"""Checkpoint I/O for the port.

Counterpart of hover_net_tpu/models/checkpoints.py. The port's module
tree uses the reference PyTorch state dict names, so a reference `.tar`
({'desc': state_dict}) loads with strict=True, and the trainer writes the
reference's own format (`save_train_tar`: {'desc', 'optimizer', 'step'}),
which the JAX package's `load_torch_tar` reads as well. The JAX package's
`.msgpack` format needs flax: convert such a checkpoint once with
hover_net_tpu.models.checkpoints.save_torch_tar.

`state_dict_from_jax` carries a JAX {params, batch_stats} tree (nested
numpy dicts) into the port's state dict, `jax_from_state_dict` back.
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


def state_dict_from_jax(variables, cfg: HoVerNetConfig
                        ) -> Dict[str, torch.Tensor]:
    """JAX {params, batch_stats} (nested dicts of numpy arrays) -> the
    port's state dict: HWIO kernels -> OIHW, scale -> weight, mean ->
    running_mean, var -> running_var."""
    out = {}
    for key, path, transform in name_map(cfg):
        node = variables
        for part in path:
            if part not in node:
                raise KeyError(f"JAX variables miss {'/'.join(path)} "
                               f"(-> {key})")
            node = node[part]
        v = np.asarray(node, np.float32)
        if transform == "OIHW":
            v = v.transpose(3, 2, 0, 1)
        out[key] = torch.tensor(v)
    out["upsample2x.unpool_mat"] = torch.ones(2, 2)
    return out


def load_torch_tar(path: str) -> Dict[str, torch.Tensor]:
    """State dict of a reference '.tar' ({'desc': state_dict}), with the
    DataParallel 'module.' prefix stripped."""
    return _desc(torch.load(path, map_location="cpu", weights_only=True))


def _desc(payload) -> Dict[str, torch.Tensor]:
    state = payload["desc"] if isinstance(payload, dict) and "desc" in \
        payload else payload
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


# ------------------------------------------------------------ trainer .tar

def save_train_tar(path: str, model: torch.nn.Module,
                   optimizer: torch.optim.Optimizer, step: int):
    """Atomically write the trainer's checkpoint in the reference format:
    {'desc': state_dict, 'optimizer': optimizer state_dict, 'step': n}
    (run_utils/callbacks/base.py:76-101), the model on the CPU."""
    payload = {"desc": {k: v.detach().cpu()
                        for k, v in model.state_dict().items()},
               "optimizer": optimizer.state_dict(), "step": int(step)}
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    os.close(fd)
    try:
        torch.save(payload, tmp)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.unlink(tmp)


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
