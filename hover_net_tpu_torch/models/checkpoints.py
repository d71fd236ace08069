"""Checkpoint I/O for the port.

Counterpart of hover_net_tpu/models/checkpoints.py. The port's module
tree uses the reference PyTorch state dict names, so a reference `.tar`
({'desc': state_dict}) loads with strict=True, and the trainer writes the
reference's own format (`save_train_tar`: {'desc', 'optimizer', 'step'}),
which the JAX package's `load_torch_tar` reads as well.

The JAX package's own format is read and written here too, without flax
(models/msgpack_io.py): `save_checkpoint` / `load_checkpoint` are the
JAX module's functions of those names, and `load_model_state` takes
either format for inference. The JAX trainer writes `net_epoch=N.msgpack`
({params, batch_stats} and {"step": n}) with its optax Adam state beside
it as `<path>.opt`; `load_train_msgpack` reads such a pair for `--resume`
(`adam_state_from_optax` maps the Adam moments onto torch.optim.Adam's
state) and `save_train_msgpack` writes one.

`state_dict_from_jax` carries a JAX {params, batch_stats} tree (nested
numpy dicts) into the port's state dict, `jax_from_state_dict` back;
`save_torch_tar` writes such a tree as a reference `.tar`, the reverse
of cli/convert_chkpt.py.
Their name map restates the JAX package's `torch_name_map`, and
`tf_name_map` its TensorFlow names for `.npz` pretrained weights; the
JAX module cannot be imported here because it imports flax.
"""

from __future__ import annotations

import os
import tempfile
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .hovernet import HoVerNetConfig
from .msgpack_io import msgpack_restore, msgpack_serialize

RES_COUNTS = {"d0": 3, "d1": 4, "d2": 6, "d3": 3}
DENSE_COUNTS = {"u3": 8, "u2": 4}

# (torch key, JAX path, transform); transform "OIHW" marks conv kernels
Row = Tuple[str, Tuple[str, ...], Optional[str]]


def _bn(key: str, path: Tuple[str, ...]) -> List[Row]:
    return [(key + ".weight", ("params",) + path + ("scale",), None),
            (key + ".bias", ("params",) + path + ("bias",), None),
            (key + ".running_mean", ("batch_stats",) + path + ("mean",), None),
            (key + ".running_var", ("batch_stats",) + path + ("var",), None)]


def _conv(key: str, path: Tuple[str, ...], bias: bool = False) -> List[Row]:
    rows = [(key + ".weight", ("params",) + path + ("kernel",), "OIHW")]
    if bias:
        rows.append((key + ".bias", ("params",) + path + ("bias",), None))
    return rows


def name_map(cfg: HoVerNetConfig) -> List[Row]:
    """Every model variable: reference torch key <-> JAX variable path."""
    rows = _conv("conv0./", ("conv0", "conv")) + _bn("conv0.bn",
                                                     ("conv0", "bn"))
    for d, count in RES_COUNTS.items():
        for k in range(count):
            u, fu = f"{d}.units.{k}", (d, f"unit{k}")
            if k:
                rows += _bn(f"{u}.preact/bn", fu + ("preact_bn",))
            rows += _conv(f"{u}.conv1", fu + ("conv1",))
            rows += _bn(f"{u}.conv1/bn", fu + ("conv1_bn",))
            rows += _conv(f"{u}.conv2", fu + ("conv2",))
            rows += _bn(f"{u}.conv2/bn", fu + ("conv2_bn",))
            rows += _conv(f"{u}.conv3", fu + ("conv3",))
        rows += _conv(f"{d}.shortcut", (d, "shortcut"))
        rows += _bn(f"{d}.blk_bna.bn", (d, "bn"))
    rows += _conv("conv_bot", ("conv_bot",))
    for branch in cfg.branches:
        b, fb = f"decoder.{branch}", f"decoder_{branch}"
        for lvl, count in DENSE_COUNTS.items():
            rows += _conv(f"{b}.{lvl}.conva", (fb, f"{lvl}_conva"))
            for k in range(count):
                du, fdu = f"{b}.{lvl}.dense.units.{k}", (fb, f"{lvl}_dense",
                                                         f"unit{k}")
                rows += _bn(f"{du}.preact_bna/bn", fdu + ("preact_bn",))
                rows += _conv(f"{du}.conv1", fdu + ("conv1",))
                rows += _bn(f"{du}.conv1/bn", fdu + ("conv1_bn",))
                rows += _conv(f"{du}.conv2", fdu + ("conv2",))
            rows += _bn(f"{b}.{lvl}.dense.blk_bna.bn",
                        (fb, f"{lvl}_dense", "bn"))
            rows += _conv(f"{b}.{lvl}.convf", (fb, f"{lvl}_convf"))
        rows += _conv(f"{b}.u1.conva", (fb, "u1_conva"))
        rows += _bn(f"{b}.u0.bn", (fb, "u0_bn"))
        rows += _conv(f"{b}.u0.conv", (fb, "u0_conv"), bias=True)
    return rows


def _float32(v) -> np.ndarray:
    """A leaf of a JAX tree as a float32 numpy array (a bfloat16 leaf of
    msgpack_io is a torch tensor)."""
    if isinstance(v, torch.Tensor):
        return v.detach().cpu().float().numpy()
    return np.asarray(v, np.float32)


def _leaf(tree, path: Tuple[str, ...]):
    """The leaf of `tree` at `path`, or None where the path is absent."""
    node = tree
    for part in path:
        if not isinstance(node, dict) or part not in node:
            return None
        node = node[part]
    return node


def _reference_layout(variables, cfg: HoVerNetConfig, partial: bool,
                      leaf) -> dict:
    """{torch key: leaf(JAX leaf)} over the name map, HWIO kernels
    transposed to OIHW; a variable that `variables` lacks raises
    KeyError, or with `partial` is left out."""
    out = {}
    for key, path, transform in name_map(cfg):
        node = _leaf(variables, path)
        if node is None:
            if partial:
                continue
            raise KeyError(f"JAX variables miss {'/'.join(path)} (-> {key})")
        v = leaf(node)
        out[key] = v.transpose(3, 2, 0, 1) if transform == "OIHW" else v
    return out


def state_dict_from_jax(variables, cfg: HoVerNetConfig, partial: bool = False
                        ) -> Dict[str, torch.Tensor]:
    """JAX {params, batch_stats} (nested dicts of numpy arrays) -> the
    port's state dict: HWIO kernels -> OIHW, scale -> weight, mean ->
    running_mean, var -> running_var. A variable of the model that
    `variables` lacks raises KeyError, or with `partial` is left out."""
    out = {k: torch.tensor(v) for k, v in
           _reference_layout(variables, cfg, partial, _float32).items()}
    out["upsample2x.unpool_mat"] = torch.ones(2, 2)
    return out


def _numpy(v) -> np.ndarray:
    """A leaf of a JAX tree as a numpy array of its own dtype (a bfloat16
    leaf of msgpack_io, a torch tensor, as float32: numpy has no
    bfloat16)."""
    if isinstance(v, torch.Tensor):
        return _float32(v)
    return np.asarray(v)


def export_torch_state_dict(variables, cfg: HoVerNetConfig
                            ) -> Dict[str, np.ndarray]:
    """The JAX package's `export_torch_state_dict`: a {params,
    batch_stats} tree -> the reference-layout state dict as numpy arrays
    (HWIO kernels -> OIHW, no 'module.' prefixes), with the reference
    UpSample2x's constant `upsample2x.unpool_mat` buffer, so that the
    reference model loads it with strict=True. Every variable of `cfg`'s
    model must be present."""
    out = _reference_layout(variables, cfg, False, _numpy)
    out["upsample2x.unpool_mat"] = np.ones((2, 2), np.float32)
    return out


def save_torch_tar(path: str, variables, cfg: HoVerNetConfig,
                   data_parallel_prefix: bool = True) -> None:
    """The JAX package's `save_torch_tar`: write `variables` as a
    reference-format `.tar`, {'desc': state_dict}, its keys prefixed with
    DataParallel's 'module.' by default as the reference trainer writes
    them. The reference `run_infer.py`, the JAX package's
    `load_torch_tar` and the port's read it."""
    state = {("module." + k if data_parallel_prefix else k):
             torch.from_numpy(np.array(v, order="C"))
             for k, v in export_torch_state_dict(variables, cfg).items()}
    _atomic_write(path, lambda tmp: torch.save({"desc": state}, tmp))


def load_torch_tar(path: str) -> Dict[str, torch.Tensor]:
    """State dict of a reference '.tar' ({'desc': state_dict}) or of
    CellViT's '.pth' ({'model_state_dict': state_dict, ...}), with the
    DataParallel 'module.' prefix stripped."""
    return _desc(torch.load(path, map_location="cpu", weights_only=True))


def _desc(payload) -> Dict[str, torch.Tensor]:
    state = payload
    if isinstance(payload, dict):
        for key in ("desc", "model_state_dict"):
            if key in payload:
                state = payload[key]
                break
    return {(k[len("module."):] if k.startswith("module.") else k): v
            for k, v in state.items()}


def jax_from_state_dict(state: Dict[str, torch.Tensor], cfg: HoVerNetConfig):
    """Inverse of `state_dict_from_jax`: the port's state dict (or a
    gradient dict under the same keys) -> JAX {params, batch_stats} as
    nested dicts of numpy arrays, OIHW kernels -> HWIO. Keys the map
    lacks (num_batches_tracked, the unpool buffer) are dropped; a key of
    the map that `state` lacks is left out."""
    out: dict = {}
    for key, path, transform in name_map(cfg):
        if key not in state:
            continue
        v = state[key].detach().cpu().float().numpy()
        if transform == "OIHW":
            v = v.transpose(2, 3, 1, 0)
        node = out
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = v
    return out


# ------------------------------------------------------ JAX .msgpack

def _atomic_write(path: str, write) -> None:
    """`write(tmp)` into a temp file beside `path`, then rename it."""
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    os.close(fd)
    try:
        write(tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


def _state_dict(tree):
    """The JAX module's `to_state_dict(tree_map(np.asarray, tree))` for
    the port's trees, nested dicts: str keys, every leaf a numpy array (a
    torch tensor on the host; bfloat16 stays a tensor, which msgpack_io
    writes as a bfloat16 array)."""
    if isinstance(tree, dict):
        return {str(k): _state_dict(v) for k, v in tree.items()}
    if isinstance(tree, torch.Tensor):
        t = tree.detach().cpu()
        return t if t.dtype == torch.bfloat16 else t.numpy()
    return np.asarray(tree)


def save_checkpoint(path: str, variables, extra: Optional[dict] = None):
    """The JAX package's `save_checkpoint`: an atomic write of
    {"variables": variables, "extra": extra} in flax's msgpack format,
    the same bytes for the same values."""
    data = msgpack_serialize({"variables": _state_dict(variables),
                              "extra": extra or {}})

    def write(tmp):
        with open(tmp, "wb") as f:
            f.write(data)

    _atomic_write(path, write)


def load_checkpoint(path: str):
    """(variables, extra) of a checkpoint of the JAX package's format, as
    its `load_checkpoint(path)` gives them: nested dicts of numpy arrays
    (msgpack_io.msgpack_restore)."""
    with open(path, "rb") as f:
        payload = msgpack_restore(f.read())
    return payload["variables"], payload.get("extra", {})


def variable_paths(tree, prefix: Tuple[str, ...] = ()):
    """The path of every leaf of a nested dict."""
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from variable_paths(v, prefix + (k,))
        else:
            yield prefix + (k,)


def check_variables(variables, cfg: HoVerNetConfig, path: str) -> None:
    """The JAX managers' `_validate_variables`: a checkpoint must hold
    exactly the variables of `cfg`'s model (a typed checkpoint read
    without nr_types, or the reverse, raises ValueError)."""
    want = {p for _, p, _ in name_map(cfg)}
    have = set(variable_paths(variables))
    missing, extra = want - have, have - want
    if missing:
        raise ValueError(
            f"checkpoint {path} missing {len(missing)} variables for "
            f"mode={cfg.mode} nr_types={cfg.nr_types} width={cfg.width}, "
            f"e.g. {['/'.join(k) for k in sorted(missing)[:3]]}")
    if extra:
        raise ValueError(
            f"checkpoint {path} has {len(extra)} unexpected variables "
            f"(wrong --nr_types/--model_mode/--width?), e.g. "
            f"{['/'.join(k) for k in sorted(extra)[:3]]}")


def load_model_state(path: str, cfg: HoVerNetConfig
                     ) -> Dict[str, torch.Tensor]:
    """The state dict of a model checkpoint for `cfg`'s model, as the JAX
    managers pick the loader: a reference or trainer `.tar` (`.pth`,
    `.pt`), else the JAX package's msgpack (checked by
    `check_variables`). A CellViT model (models/cellvit.py) reads a
    `.pth` or `.tar` only."""
    if str(path).endswith((".tar", ".pth", ".pt")):
        return load_torch_tar(path)
    if not isinstance(cfg, HoVerNetConfig):
        raise ValueError(f"checkpoint {path}: a {cfg.mode} model loads a "
                         f".pth or .tar; the JAX package's .msgpack holds "
                         f"HoVer-Net only")
    variables, _ = load_checkpoint(path)
    check_variables(variables, cfg, path)
    return state_dict_from_jax(variables, cfg)


def _param_rows(cfg: HoVerNetConfig):
    """{torch parameter name: (path under params, transform)}: the rows
    of `name_map` that optax's Adam moments mirror (no batch_stats)."""
    return {key: (path[1:], transform) for key, path, transform
            in name_map(cfg) if path[0] == "params"}


def _count(v) -> int:
    return int(np.asarray(v))


def adam_state_from_optax(opt_tree, cfg: HoVerNetConfig,
                          model: torch.nn.Module) -> dict:
    """The JAX trainer's optax state (the `.opt` file's variables:
    "0" = scale_by_adam's {count, mu, nu}, "1" = the schedule's {count})
    as a `torch.optim.Adam` state dict for `model`: each parameter's
    exp_avg / exp_avg_sq from mu / nu (HWIO kernels to OIHW), its step
    from the count. Both compute optax's scale_by_adam(0.9, 0.999, 1e-8)
    with its bias corrections, so the next update is the same.

    Torch keys the state by parameter index, in `model.parameters()`
    order. Every parameter gets a state: in a frozen-encoder phase the
    JAX tree holds zero moments for the encoder (its gradients are
    zero), which the torch step then never reads, since the port's frozen
    parameters get no gradient. The param groups are torch's Adam with
    the trainer's betas and eps; the trainer sets each update's lr from
    its schedule."""
    adam = opt_tree["0"]
    count = _count(adam["count"])
    if "1" in opt_tree and _count(opt_tree["1"]["count"]) != count:
        raise ValueError(f"optax state: Adam count {count}, schedule count "
                         f"{_count(opt_tree['1']['count'])}")
    rows = _param_rows(cfg)
    state = {}
    for i, (name, p) in enumerate(model.named_parameters()):
        path, transform = rows[name]
        moments = {}
        for key, part in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
            v = _leaf(adam[part], path)
            if v is None:
                raise KeyError(f"optax state misses {part}/{'/'.join(path)}"
                               f" (-> {name})")
            v = torch.from_numpy(_float32(v))
            if transform == "OIHW":
                v = v.permute(3, 2, 0, 1).contiguous()
            if tuple(v.shape) != tuple(p.shape):
                raise ValueError(f"optax {part} of {name}: shape "
                                 f"{tuple(v.shape)}, parameter "
                                 f"{tuple(p.shape)}")
            moments[key] = v
        state[i] = {"step": torch.tensor(float(count)), **moments}
    groups = torch.optim.Adam(model.parameters(), betas=(0.9, 0.999),
                              eps=1e-8).state_dict()["param_groups"]
    return {"state": state, "param_groups": groups}


def optax_from_adam_state(opt_state: dict, cfg: HoVerNetConfig,
                          model: torch.nn.Module, step: int) -> dict:
    """Inverse of `adam_state_from_optax`: a `torch.optim.Adam` state dict
    of `model` after `step` updates -> the JAX trainer's optax state
    ({"0": {count, mu, nu}, "1": {count}}, float32 moments, int32
    counts). A parameter without torch state (a frozen one) gets zero
    moments, as optax's would be; one whose moments are not zero must
    have taken all `step` updates, else ValueError."""
    rows = _param_rows(cfg)
    mu: dict = {}
    nu: dict = {}
    for i, (name, p) in enumerate(model.named_parameters()):
        path, transform = rows[name]
        s = opt_state["state"].get(i) or {}
        moments = []
        for key in ("exp_avg", "exp_avg_sq"):
            v = (s[key].detach().cpu().float() if key in s
                 else torch.zeros(p.shape))
            if transform == "OIHW":
                v = v.permute(2, 3, 1, 0)
            moments.append(np.ascontiguousarray(v.numpy()))
        if s and int(s["step"]) != step and any(m.any() for m in moments):
            raise ValueError(f"{name}: Adam state after {int(s['step'])} "
                             f"updates, not {step}")
        for tree, v in zip((mu, nu), moments):
            node = tree
            for part in path[:-1]:
                node = node.setdefault(part, {})
            node[path[-1]] = v
    count = np.asarray(step, np.int32)
    return {"0": {"count": count, "mu": mu, "nu": nu},
            "1": {"count": count.copy()}}


def load_train_msgpack(path: str, model: torch.nn.Module):
    """(state dict, optimizer state dict, step) of a checkpoint the JAX
    trainer wrote (`net_epoch=N.msgpack` and its `<path>.opt`), for
    `model` (a HoVerNet: its cfg and parameter order). The step is
    `extra["step"]`, which the JAX trainer writes equal to the optax
    counts; a file where they differ raises ValueError."""
    variables, extra = load_checkpoint(path)
    check_variables(variables, model.cfg, path)
    opt_tree, _ = load_checkpoint(path + ".opt")
    opt_state = adam_state_from_optax(opt_tree, model.cfg, model)
    step = int(extra.get("step", 0))
    count = _count(opt_tree["0"]["count"])
    if step != count:
        raise ValueError(f"{path}: step {step}, but {path}.opt counts "
                         f"{count} updates")
    return state_dict_from_jax(variables, model.cfg), opt_state, step


def save_train_msgpack(path: str, model: torch.nn.Module,
                       optimizer: torch.optim.Optimizer, step: int):
    """Write `model`'s variables, {"step": step} and its Adam state as the
    JAX trainer does (`RunInfo.save_checkpoint`): `path` and
    `<path>.opt`."""
    cfg = model.cfg
    save_checkpoint(path, jax_from_state_dict(model.state_dict(), cfg),
                    extra={"step": int(step)})
    save_checkpoint(path + ".opt", optax_from_adam_state(
        optimizer.state_dict(), cfg, model, step))


# ------------------------------------------------------------ trainer .tar

def save_train_tar(path: str, model: torch.nn.Module,
                   optimizer: torch.optim.Optimizer, step: int):
    """Atomically write the trainer's checkpoint in the reference format:
    {'desc': state_dict, 'optimizer': optimizer state_dict, 'step': n}
    (run_utils/callbacks/base.py:76-101), the model on the CPU."""
    payload = {"desc": {k: v.detach().cpu()
                        for k, v in model.state_dict().items()},
               "optimizer": optimizer.state_dict(), "step": int(step)}
    _atomic_write(path, lambda tmp: torch.save(payload, tmp))


def load_train_tar(path: str):
    """(state dict, optimizer state dict, step) of a trainer `.tar`, on
    the CPU, 'module.' prefixes stripped; a reference `.tar` without the
    last two gives (state dict, None, 0)."""
    payload = torch.load(path, map_location="cpu", weights_only=True)
    return (_desc(payload), payload.get("optimizer"),
            int(payload.get("step", 0)))


# ------------------------------------------------------- pretrained .npz

# variables under these module tops constitute the encoder that ImageNet
# pretraining must fully cover (run_train.py:196-203 loads strict=False;
# an incomplete encoder fails loudly instead)
ENCODER_TOPS = ("conv0", "d0", "d1", "d2", "d3")


def tf_name_map(cfg: HoVerNetConfig) -> List[Tuple[str, Tuple[str, ...]]]:
    """[(tf_key, JAX path)] following the original TensorFlow HoVer-Net
    variable naming (the JAX package's `tf_name_map`). TF kernels are
    HWIO, as JAX's."""

    def bn(tf_prefix, path):
        return [
            (f"{tf_prefix}/gamma:0", ("params",) + path + ("scale",)),
            (f"{tf_prefix}/beta:0", ("params",) + path + ("bias",)),
            (f"{tf_prefix}/mean/EMA:0", ("batch_stats",) + path + ("mean",)),
            (f"{tf_prefix}/variance/EMA:0",
             ("batch_stats",) + path + ("var",)),
        ]

    def conv(tf_key, path):
        return [(tf_key, ("params",) + path + ("kernel",))]

    rows = conv("conv0/W:0", ("conv0", "conv")) + bn("conv0/bn",
                                                     ("conv0", "bn"))
    for g, count in enumerate(RES_COUNTS.values()):
        d = f"d{g}"
        for k in range(count):
            u, fu = f"group{g}/block{k}", (d, f"unit{k}")
            if k:
                rows += bn(f"{u}/preact/bn", fu + ("preact_bn",))
            rows += conv(f"{u}/conv1/W:0", fu + ("conv1",))
            rows += bn(f"{u}/conv1/bn", fu + ("conv1_bn",))
            rows += conv(f"{u}/conv2/W:0", fu + ("conv2",))
            rows += bn(f"{u}/conv2/bn", fu + ("conv2_bn",))
            rows += conv(f"{u}/conv3/W:0", fu + ("conv3",))
        rows += conv(f"group{g}/block0/convshortcut/W:0", (d, "shortcut"))
        rows += bn(f"group{g}/bnlast/bn", (d, "bn"))
    rows += conv("conv_bot/W:0", ("conv_bot",))
    for branch in cfg.branches:
        fb = f"decoder_{branch}"
        for lvl, count in DENSE_COUNTS.items():
            rows += conv(f"{branch}/{lvl}/conva/W:0", (fb, f"{lvl}_conva"))
            for k in range(count):
                du = f"{branch}/{lvl}/dense/blk/{k}"
                fdu = (fb, f"{lvl}_dense", f"unit{k}")
                rows += bn(f"{du}/preact_bna/bn", fdu + ("preact_bn",))
                rows += conv(f"{du}/conv1/W:0", fdu + ("conv1",))
                rows += bn(f"{du}/conv1/bn", fdu + ("conv1_bn",))
                rows += conv(f"{du}/conv2/W:0", fdu + ("conv2",))
            rows += bn(f"{branch}/{lvl}/dense/blk_bna/bn",
                       (fb, f"{lvl}_dense", "bn"))
            rows += conv(f"{branch}/{lvl}/convf/W:0", (fb, f"{lvl}_convf"))
        rows += conv(f"{branch}/u1/conva/W:0", (fb, "u1_conva"))
        rows += bn(f"preact_out_{branch}/bn", (fb, "u0_bn"))
        rows += conv(f"conv_out_{branch}/W:0", (fb, "u0_conv"))
        rows.append((f"conv_out_{branch}/b:0",
                     ("params", fb, "u0_conv", "bias")))
    return rows


def load_pretrained_npz(path: str, cfg: HoVerNetConfig,
                        require_encoder: bool = True
                        ) -> Dict[str, torch.Tensor]:
    """Import a `.npz` pretrained checkpoint (reference
    run_train.py:196-203, models/hovernet/opt.py:55) as a partial state
    dict of the port (merge it with `train.manager.merge_partial`).

    Accepts either naming style:
    - original TensorFlow preact-ResNet50 names
      (``group0/block0/conv1/W:0``; HWIO kernels, transposed), or
    - torch state-dict names (``d0.units.0.conv1.weight``; OIHW kernels,
      as they are), with optional ``module.`` prefixes.

    With `require_encoder`, raises KeyError unless conv0 + d0..d3 are
    fully covered — a phase-0 "pretrained" file that leaves encoder
    variables random is a silently broken recipe.
    """
    arrays = {}
    with np.load(path) as z:
        for k in z.files:
            key = k[len("module."):] if k.startswith("module.") else k
            arrays[key] = np.asarray(z[k])

    rows = name_map(cfg)
    if any(k.endswith(":0") for k in arrays):
        torch_key = {p: key for key, p, _ in rows}
        rows = [(tf_key, p, torch_key[p], "HWIO" if p[-1] == "kernel"
                 else None) for tf_key, p in tf_name_map(cfg)]
    else:
        rows = [(key, p, key, None) for key, p, _ in rows]

    out, covered = {}, set()
    for file_key, _, key, transform in rows:
        if file_key not in arrays:
            continue
        v = arrays[file_key]
        if transform == "HWIO":
            v = v.transpose(3, 2, 0, 1)
        out[key] = torch.tensor(np.asarray(v, np.float32))
        covered.add(file_key)

    if require_encoder:
        missing = [k for k, p, _, _ in rows
                   if p[1] in ENCODER_TOPS and k not in covered]
        if missing:
            raise KeyError(
                f"pretrained npz {path} misses {len(missing)} encoder "
                f"variables, e.g. {missing[:5]}"
            )

    unknown = sorted(
        k for k in arrays if k not in covered and not (
            k.startswith("linear") or "upsample" in k
            or k.endswith("num_batches_tracked")))
    if unknown:
        print(f"pretrained npz: {len(unknown)} unmapped variables "
              f"ignored, e.g. {unknown[:5]}")
    return out
