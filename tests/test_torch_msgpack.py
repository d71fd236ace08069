"""The port's reader and writer of the JAX package's checkpoints
(models/msgpack_io.py, models/checkpoints.py) against flax and the JAX
package, on the CPU:

- (a) hypothesis trees of nested dicts and lists with every msgpack
  scalar, complex, numpy scalars and arrays (float32, float64, int32,
  uint8, bool, bfloat16): the port's `msgpack_restore` of flax's bytes
  equals flax's, and the port's `msgpack_serialize` gives flax's bytes;
  every length class of str, bin, array, map and ext once more by hand;
- (b) arrays past `MAX_CHUNK_SIZE` (made small on both sides) are
  chunked and reassembled as flax does;
- (c) the JAX trainer's `RunInfo.save_checkpoint` and the port's
  `save_train_msgpack` write the same bytes, `.opt` included, for a
  width-8 typed model and an optax Adam state, and both
  packages' `save_checkpoint` agree on a plain tree;
- (d) a truncated buffer, an unknown ExtType code, trailing bytes, an
  object dtype and an int map key raise ValueError naming the byte;
- (e) both packages' tile and WSI managers, float32, on one JAX-written
  `.msgpack` give identical instances (the harness of
  tests/test_torch_e2e_instances.py), and a typed file read untyped
  raises in both; cli/eval_consep prints the same stat lines from the
  `.msgpack` as from the `.tar` of the same weights;
- (g) the port's trainer on a log dir the JAX trainer wrote: phase 1
  chains (`pretrained=-1`) from phase 0's `net_epoch=1.msgpack`, and a
  one-phase run resumes from it and its `.opt`, going on in `.tar`;
  `last_checkpoint` takes the highest epoch of either format.

Resume parity of the train step itself is tests/test_torch_msgpack_resume.py.
"""

import json
import os
import re

import numpy as np
import pytest
import scipy.io as sio
import torch
from hypothesis import HealthCheck, given, settings
from hypothesis import strategies as st
from hypothesis.extra import numpy as hnp

import jax
import jax.numpy as jnp
from flax import serialization as fs

from hover_net_tpu.models import checkpoints as j_ckpt
from hover_net_tpu.parallel import train_parallel as j_tp
from hover_net_tpu.train.manager import RunInfo as JaxRunInfo
from hover_net_tpu_torch.models import checkpoints as t_ckpt
from hover_net_tpu_torch.models import msgpack_io
from hover_net_tpu_torch.models.hovernet import HoVerNet, HoVerNetConfig
from hover_net_tpu_torch.train.manager import last_checkpoint

from test_torch_e2e_instances import COMMON, inputs  # noqa: F401
from test_torch_tile import forced_foreground_variables

BF16 = jnp.bfloat16  # ml_dtypes' bfloat16, a numpy dtype


# ------------------------------------------------------------ comparison

def same(got, want):
    """The port's restored tree equals flax's: the same containers, keys
    and scalars (NaN equal to NaN), arrays of the same dtype, shape and
    bytes; a bfloat16 array or scalar of flax is a torch.bfloat16 tensor
    of the port with the same bits."""
    if isinstance(want, dict):
        return (type(got) is dict and list(got) == list(want)
                and all(same(got[k], want[k]) for k in want))
    if isinstance(want, list):
        return (type(got) is list and len(got) == len(want)
                and all(same(g, w) for g, w in zip(got, want)))
    if isinstance(want, (np.ndarray, np.generic)) and want.dtype == BF16:
        return (isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16
                and tuple(got.shape) == np.shape(want)
                and np.array_equal(got.view(torch.int16).numpy(),
                                   np.asarray(want).view(np.int16)))
    if isinstance(want, np.ndarray):
        return (type(got) is np.ndarray and got.dtype == want.dtype
                and got.shape == want.shape
                and got.tobytes() == want.tobytes())
    if isinstance(want, np.generic):
        return (type(got) is type(want)
                and np.asarray(got).tobytes() == np.asarray(want).tobytes())
    if isinstance(want, (float, complex)) and want != want:
        return type(got) is type(want) and got != got
    return type(got) is type(want) and got == want


# ------------------------------------------------------------ (a) trees

def bf16_arrays(shape):
    return hnp.arrays(np.uint16, shape).map(lambda a: a.view(BF16))


ARRAYS = st.one_of(
    [hnp.arrays(d, hnp.array_shapes(min_dims=0, max_dims=3, max_side=5))
     for d in (np.float32, np.float64, np.int32, np.uint8, np.bool_)]
    + [hnp.array_shapes(min_dims=0, max_dims=3, max_side=5).flatmap(
        bf16_arrays)])
NP_SCALARS = st.one_of(
    st.floats(width=32).map(np.float32), st.floats().map(np.float64),
    st.integers(-2 ** 31, 2 ** 31 - 1).map(np.int32),
    st.integers(0, 255).map(np.uint8), st.booleans().map(np.bool_),
    st.integers(0, 2 ** 16 - 1).map(
        lambda b: np.array(b, np.uint16).view(BF16)[()]))
LEAVES = st.one_of(
    st.none(), st.booleans(),
    st.integers(-2 ** 63, 2 ** 64 - 1),
    st.sampled_from([0x7f, 0x80, 0xff, 0x100, 0xffff, 0x10000, 2 ** 32 - 1,
                     2 ** 32, -0x20, -0x21, -0x80, -0x81, -0x8000, -0x8001,
                     -2 ** 31, -2 ** 31 - 1, -2 ** 63]),
    st.floats(), st.text(max_size=40), st.binary(max_size=300),
    st.complex_numbers(), NP_SCALARS, ARRAYS)
TREES = st.recursive(
    LEAVES, lambda kids: st.one_of(
        st.lists(kids, max_size=18),
        st.dictionaries(st.text(max_size=12), kids, max_size=18)),
    max_leaves=40)


@settings(max_examples=150, deadline=None,
          suppress_health_check=[HealthCheck.too_slow,
                                 HealthCheck.data_too_large])
@given(tree=TREES)
def test_hypothesis_trees_match_flax(tree):
    data = fs.msgpack_serialize(tree)
    assert msgpack_io.msgpack_serialize(tree) == data
    assert same(msgpack_io.msgpack_restore(data), fs.msgpack_restore(data))


def test_bf16_tensors_pack_as_bf16_arrays():
    """A torch.bfloat16 leaf of the port is written as flax writes the
    bfloat16 array with its bits, and read back as a bfloat16 tensor."""
    bits = np.arange(-40, 40, 7, dtype=np.int16).reshape(3, 4) * 811
    tree = {"w": torch.from_numpy(bits.copy()).view(torch.bfloat16),
            "s": torch.tensor(1.5, dtype=torch.bfloat16)}
    want = fs.msgpack_serialize({"w": bits.view(BF16),
                                 "s": np.asarray(1.5, BF16)})
    assert msgpack_io.msgpack_serialize(tree) == want
    back = msgpack_io.msgpack_restore(want)
    assert back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"].view(torch.int16), torch.from_numpy(bits))


@pytest.mark.parametrize("case", [
    "fixstr", "str8", "str16", "str32", "bin8", "bin16", "bin32",
    "fixarray", "array16", "array32", "fixmap", "map16", "map32",
    "ext8", "ext16", "ext32", "fixext", "ints"])
def test_every_length_class_matches_flax(case):
    """Each header form of msgpack once, at the sizes where the encoding
    changes, against flax's bytes and flax's restore."""
    sizes = {"fixstr": 31, "str8": 255, "str16": 65535, "str32": 65536,
             "bin8": 255, "bin16": 65535, "bin32": 65536,
             "fixarray": 15, "array16": 65535, "array32": 65536,
             "fixmap": 15, "map16": 65535, "map32": 65536}
    kind = re.sub(r"\d+$", "", case).replace("fix", "")
    n = sizes.get(case)
    if kind == "str":
        tree = {"s": "é" * (n // 2) + "a" * (n % 2)}
    elif kind == "bin":
        tree = {"b": bytes(range(256)) * (n // 256) + b"x" * (n % 256)}
    elif kind == "array":
        tree = [i % 300 - 40 for i in range(n)]
    elif kind == "map":
        tree = {f"k{i}": i for i in range(n)}
    elif case == "ext8":
        tree = {"a": np.arange(40, dtype=np.float32), "c": 1 - 2j}
    elif case == "ext16":
        tree = {"a": np.arange(4000, dtype=np.float32)}
    elif case == "ext32":
        tree = {"a": np.arange(20000, dtype=np.float32).reshape(100, 200)}
    elif case == "fixext":
        tree = {"a": np.float32(2.5), "b": np.int8(-3),
                "c": np.zeros((), np.int32)}
    else:
        tree = {"i": [0, 127, 128, 255, 256, 65535, 65536, 2 ** 32 - 1,
                      2 ** 32, 2 ** 64 - 1, -1, -32, -33, -128, -129,
                      -32768, -32769, -2 ** 31, -2 ** 31 - 1, -2 ** 63],
                "f": [0.0, -1.5, 1e300, float("inf")], "t": True,
                "z": None}
    data = fs.msgpack_serialize(tree)
    assert msgpack_io.msgpack_serialize(tree) == data
    assert same(msgpack_io.msgpack_restore(data), fs.msgpack_restore(data))


def test_containers_flax_refuses_raise_too():
    for bad in ({"t": (1, 2)}, {"o": object()}, {"i": 2 ** 64}):
        with pytest.raises((TypeError, OverflowError)):
            fs.msgpack_serialize(bad)
        with pytest.raises((TypeError, OverflowError)):
            msgpack_io.msgpack_serialize(bad)


# ---------------------------------------------------------- (b) chunked

def test_chunked_arrays_match_flax(monkeypatch):
    monkeypatch.setattr(fs, "MAX_CHUNK_SIZE", 64)
    monkeypatch.setattr(msgpack_io, "MAX_CHUNK_SIZE", 64)
    rng = np.random.default_rng(0)
    tree = {
        "big": rng.normal(size=(7, 9)).astype(np.float32),  # 252 B: 4 chunks
        "edge": np.arange(16, dtype=np.float32),  # 64 B: not chunked
        "bf16": rng.integers(0, 2 ** 16, (50,)).astype(np.uint16).view(BF16),
        "nested": {"u8": np.arange(200, dtype=np.uint8).reshape(10, 20),
                   "list": [np.arange(40, dtype=np.float64)]},
    }
    data = fs.msgpack_serialize(tree)
    assert b"__msgpack_chunked_array__" in data
    assert msgpack_io.msgpack_serialize(tree) == data
    got, want = msgpack_io.msgpack_restore(data), fs.msgpack_restore(data)
    assert same(got, want)
    assert same(got["big"], tree["big"])
    # a tree that is itself one big array
    arr = np.arange(100, dtype=np.int32)
    data = fs.msgpack_serialize(arr)
    assert msgpack_io.msgpack_serialize(arr) == data
    assert same(msgpack_io.msgpack_restore(data), fs.msgpack_restore(data))


# ------------------------------------------- (c) checkpoint files, bytes

WIDTH, NR_TYPES = 8, 5
CFG = HoVerNetConfig(mode="fast", nr_types=NR_TYPES, width=WIDTH)


def adam_after(params, count, seed=0):
    """The JAX trainer's optax state (`make_optimizer`'s chain) with
    seeded moments after `count` updates; every tenth leaf has zero
    moments, as a frozen parameter's are."""
    tx, schedule = j_tp.make_optimizer(steps_per_epoch=3)
    adam, sched = tx.init(params)
    rng = np.random.default_rng(seed)
    leaves, treedef = jax.tree_util.tree_flatten(params)
    mu, nu = [], []
    for i, v in enumerate(leaves):
        on = i % 10 != 0
        mu.append(rng.normal(0, 1e-3, v.shape).astype(np.float32) * on)
        nu.append(rng.uniform(0, 1e-6, v.shape).astype(np.float32) * on)
    n = jnp.asarray(count, jnp.int32)
    opt_state = (adam._replace(count=n,
                               mu=jax.tree_util.tree_unflatten(treedef, mu),
                               nu=jax.tree_util.tree_unflatten(treedef, nu)),
                 sched._replace(count=n))
    return tx, schedule, opt_state


@pytest.fixture(scope="module")
def jax_checkpoint(tmp_path_factory):
    """A JAX trainer checkpoint of the forced-foreground typed w8 model:
    `net_epoch=1.msgpack` and `.opt` after two updates, written by
    the JAX package's `RunInfo.save_checkpoint`. Returns (phase dir,
    path, variables as numpy)."""
    _, variables = forced_foreground_variables(NR_TYPES, seed=2)
    tx, schedule, opt_state = adam_after(variables["params"], 2)
    state = j_tp.TrainState(params=variables["params"],
                            batch_stats=variables["batch_stats"],
                            opt_state=opt_state,
                            step=jnp.asarray(2, jnp.int32))
    d = tmp_path_factory.mktemp("jax_phase")
    path = str(d / "net_epoch=1.msgpack")
    JaxRunInfo(None, tx, schedule, state).save_checkpoint(path)
    return d, path, variables


def test_trainer_files_are_byte_identical(jax_checkpoint, tmp_path):
    """The port reads the JAX trainer's pair into a model and a torch
    Adam, and writes it back byte for byte; the step is extra["step"]."""
    _, path, variables = jax_checkpoint
    net = HoVerNet(CFG)
    desc, opt_sd, step = t_ckpt.load_train_msgpack(path, net)
    assert step == 2
    net.load_state_dict(desc, strict=True)
    opt = torch.optim.Adam(net.parameters())
    opt.load_state_dict(opt_sd)
    assert {float(s["step"]) for s in opt.state.values()} == {2.0}
    assert len(opt.state) == len(list(net.parameters()))
    out = str(tmp_path / "net_epoch=1.msgpack")
    t_ckpt.save_train_msgpack(out, net, opt, step)
    for suffix in ("", ".opt"):
        with open(path + suffix, "rb") as f, open(out + suffix, "rb") as g:
            assert f.read() == g.read(), suffix
    # the moments land on the right parameters, kernels as OIHW
    with open(path + ".opt", "rb") as f:
        mu = fs.msgpack_restore(f.read())["variables"]["0"]["mu"]
    k = mu["decoder_np"]["u3_dense"]["unit2"]["conv2"]["kernel"]
    idx = [n for n, _ in net.named_parameters()].index(
        "decoder.np.u3.dense.units.2.conv2.weight")
    np.testing.assert_array_equal(
        opt.state_dict()["state"][idx]["exp_avg"].numpy(),
        np.asarray(k).transpose(3, 2, 0, 1))
    assert np.asarray(k).any()


def test_save_checkpoint_matches_the_jax_package(tmp_path):
    rng = np.random.default_rng(1)
    variables = {"params": {"b": {"kernel": rng.normal(size=(3, 3, 2, 4))
                                  .astype(np.float32)},
                            "a": {"s": np.float32(1.0), "i": np.arange(3)}},
                 "batch_stats": {"mean": np.zeros(4, np.float32)}}
    extra = {"step": 7, "note": "x", "lr": 1e-4}
    j_ckpt.save_checkpoint(str(tmp_path / "j.msgpack"), variables, extra)
    t_ckpt.save_checkpoint(str(tmp_path / "t.msgpack"), variables, extra)
    assert (tmp_path / "j.msgpack").read_bytes() == \
        (tmp_path / "t.msgpack").read_bytes()
    got, got_extra = t_ckpt.load_checkpoint(str(tmp_path / "j.msgpack"))
    want, want_extra = j_ckpt.load_checkpoint(str(tmp_path / "j.msgpack"))
    assert same(got, want) and got_extra == want_extra == extra


def test_adam_map_is_its_own_inverse_with_frozen_parameters(jax_checkpoint):
    """A frozen parameter has no torch state; its optax moments are
    zero. Both ways the map keeps that, and a parameter whose moments are
    nonzero but whose step lags the count is refused."""
    _, path, _ = jax_checkpoint
    net = HoVerNet(CFG)
    with open(path + ".opt", "rb") as f:
        opt_tree = msgpack_io.msgpack_restore(f.read())["variables"]
    sd = t_ckpt.adam_state_from_optax(opt_tree, CFG, net)
    names = [n for n, _ in net.named_parameters()]
    frozen = [i for i, n in enumerate(names) if n.startswith("d1.")]
    for i in frozen:
        del sd["state"][i]
    back = t_ckpt.optax_from_adam_state(sd, CFG, net, 2)
    assert int(back["0"]["count"]) == int(back["1"]["count"]) == 2
    for part in ("mu", "nu"):
        for key, path_, _ in t_ckpt.name_map(CFG):
            if path_[0] != "params":
                continue
            got = t_ckpt._leaf(back["0"][part], path_[1:])
            want = t_ckpt._leaf(opt_tree["0"][part], path_[1:])
            if key.startswith("d1."):
                assert got.shape == want.shape and not got.any(), key
            else:
                np.testing.assert_array_equal(got, want, err_msg=key)
    sd2 = t_ckpt.adam_state_from_optax(opt_tree, CFG, net)
    sd2["state"][frozen[0]]["step"] = torch.tensor(1.0)
    with pytest.raises(ValueError, match="not 2"):
        t_ckpt.optax_from_adam_state(sd2, CFG, net, 2)


# ---------------------------------------------------------- (d) malformed

def test_malformed_input_raises():
    good = fs.msgpack_serialize({"variables": {"w": np.arange(6.0)},
                                 "extra": {}})
    cases = {
        "truncated": (good[:-1], r"truncated at byte \d+"),
        "header only": (good[:12], r"truncated at byte \d+"),
        "trailing": (good + b"\x00", r"1 trailing bytes .* from byte"),
        "ext code": (b"\x81\xa1a\xd4\x05\x00", r"byte 3: unknown ExtType "
                                                 r"code 5"),
        "int key": (b"\x81\x01\x02", r"byte 1: a map key of type int"),
        "never used": (b"\xc1", r"byte 0: type byte 0xc1"),
    }
    for name, (data, match) in cases.items():
        with pytest.raises(ValueError, match=match):
            msgpack_io.msgpack_restore(data)
        if name in ("truncated", "trailing", "int key"):
            with pytest.raises(ValueError):
                fs.msgpack_restore(data)


def test_object_dtype_is_refused():
    header = b"\x93\x91\x01\xa6object\xc4\x08" + bytes(8)
    data = b"\xc7" + bytes([len(header)]) + b"\x01" + header
    with pytest.raises(ValueError, match="byte 0: an array of object dtype"):
        msgpack_io.msgpack_restore(data)
    with pytest.raises(ValueError, match="Object and structured"):
        msgpack_io.msgpack_serialize({"a": np.array([None], object)})


# ------------------------------------------------- (e) the managers


@pytest.fixture(scope="module")
def ckpts(inputs, jax_checkpoint):
    """(msgpack, tar of the same weights, tile dir, slide dir, mask dir):
    the inputs of tests/test_torch_e2e_instances.py, whose `.tar` holds
    the forced-foreground weights of seed 2 as `jax_checkpoint` does."""
    return (jax_checkpoint[1],) + tuple(inputs)


def test_tile_managers_read_the_msgpack_alike(ckpts, tmp_path):
    from hover_net_tpu.infer.tile import TileInferManager as JaxTile
    from hover_net_tpu_torch.infer.tile import TileInferManager as PortTile

    msgpack, _, tile_dir, _, _ = ckpts
    JaxTile(model_path=msgpack, dtype=jnp.float32, batch_size=4, **COMMON) \
        .process_file_list(tile_dir, str(tmp_path / "jax"))
    PortTile(model_path=msgpack, dtype=torch.float32, batch_size=4,
             device="cpu", **COMMON) \
        .process_file_list(tile_dir, str(tmp_path / "port"))
    out = {}
    for name in ("jax", "port"):
        with open(tmp_path / name / "json" / "t.json") as f:
            out[name] = (json.load(f)["nuc"],
                         sio.loadmat(str(tmp_path / name / "mat" / "t.mat")))
    np.testing.assert_array_equal(out["port"][1]["inst_map"],
                                  out["jax"][1]["inst_map"])
    assert out["port"][0] == out["jax"][0]
    assert len(out["jax"][0]) > 5


def test_wsi_managers_read_the_msgpack_alike(ckpts, tmp_path):
    from hover_net_tpu.infer.wsi import WSIInferManager as JaxWSI
    from hover_net_tpu_torch.infer.wsi import WSIInferManager as PortWSI

    msgpack, _, _, slide_dir, mask_dir = ckpts
    kw = dict(model_path=msgpack, batch_size=8, chunk_shape=1000,
              tile_shape=256, ambiguous_size=32, proc_mag=40,
              pred_map_dtype="float32", **COMMON)
    nuc = {}
    for name, cls, extra in (
            ("jax", JaxWSI, dict(dtype=jnp.float32)),
            ("port", PortWSI, dict(dtype=torch.float32, device="cpu"))):
        mgr = cls(cache_path=str(tmp_path / f"cache_{name}"), **extra, **kw)
        mgr.process_wsi_list(slide_dir, str(tmp_path / name),
                             input_mask_dir=mask_dir)
        with open(tmp_path / name / "s.json") as f:
            nuc[name] = json.load(f)
    assert nuc["port"] == nuc["jax"]
    assert len(nuc["jax"]["nuc"]) > 50


def test_typed_msgpack_read_untyped_raises_in_both(ckpts):
    from hover_net_tpu.infer.tile import TileInferManager as JaxTile
    from hover_net_tpu_torch.infer.tile import TileInferManager as PortTile

    msgpack = ckpts[0]
    kw = dict(model_path=msgpack, mode="fast", nr_types=None, width=WIDTH)
    with pytest.raises(ValueError, match="unexpected variables") as j_err:
        JaxTile(dtype=jnp.float32, **kw)
    with pytest.raises(ValueError, match="unexpected variables") as t_err:
        PortTile(dtype=torch.float32, device="cpu", **kw)
    assert str(t_err.value) == str(j_err.value)


def test_eval_consep_reads_the_msgpack(ckpts, tmp_path, capsys,
                                       monkeypatch):
    """cli/eval_consep on its dry run's stand-ins: the `.msgpack` prints
    the stat lines of the `.tar` of the same weights (float32 managers,
    as tests/test_torch_eval_consep.py runs the recipe)."""
    import functools

    from hover_net_tpu_torch.cli import eval_consep, eval_consep_dryrun
    from hover_net_tpu_torch.infer.base import InferManagerBase

    monkeypatch.setattr(InferManagerBase, "__init__", functools.partialmethod(
        InferManagerBase.__init__, dtype=torch.float32))
    msgpack, tar = ckpts[:2]
    root = str(tmp_path / "CoNSeP")
    eval_consep_dryrun.build_standins(root)
    lines = {}
    for name, ckpt in (("tar", tar), ("msgpack", msgpack)):
        eval_consep.main([root, ckpt, str(tmp_path / name), "fast", "8",
                          "--device", "cpu"])
        lines[name] = [ln for ln in capsys.readouterr().out.splitlines()
                       if re.match(r"^\[.*\]$", ln)]
    assert len(lines["tar"]) == 2
    assert lines["msgpack"] == lines["tar"]


# ------------------------------------------------------ (g) the trainer

TRAIN_CONFIG = """
from hover_net_tpu_torch.config import PhaseConfig, TrainConfig

config = TrainConfig(
    model_mode="fast", nr_types=5, type_classification=True, width=8,
    log_dir={log_dir!r}, train_dir_list=[{train!r}],
    valid_dir_list=[{valid!r}], nr_procs_train=0, nr_procs_valid=0,
    debug=True,
    shape_override={{"aug": (140, 140), "act": (96, 96), "out": (4, 4)}},
    phases={phases},
)
"""
CHAIN = """[
        PhaseConfig(freeze_encoder=True, batch_size={"train": 2, "valid": 2},
                    nr_epochs=1),
        PhaseConfig(freeze_encoder=False, pretrained=-1, lr=0.0,
                    batch_size={"train": 2, "valid": 2}, nr_epochs=1),
    ]"""
RESUME = """[
        PhaseConfig(freeze_encoder=False, batch_size={"train": 2,
                                                      "valid": 2},
                    nr_epochs=2),
    ]"""


@pytest.fixture(scope="module")
def patches(tmp_path_factory):
    from test_train_e2e import make_patches

    root = tmp_path_factory.mktemp("patches")
    rng = np.random.default_rng(0)
    make_patches(str(root / "train"), 4, rng)
    make_patches(str(root / "valid"), 2, rng)
    return str(root / "train"), str(root / "valid")


def run_train_on(tmp_path, log_dir, phases, patches):
    from hover_net_tpu_torch.cli import run_train

    cfg = tmp_path / "cfg.py"
    cfg.write_text(TRAIN_CONFIG.format(log_dir=str(log_dir),
                                       train=patches[0], valid=patches[1],
                                       phases=phases))
    return run_train.main(["--device", "cpu", "--resume", "--config",
                           str(cfg)])


def copy_phase(src, dst):
    os.makedirs(dst)
    for name in ("net_epoch=1.msgpack", "net_epoch=1.msgpack.opt"):
        with open(os.path.join(src, name), "rb") as f, \
                open(os.path.join(dst, name), "wb") as g:
            g.write(f.read())


def test_phase_chains_from_a_jax_phase_dir(jax_checkpoint, patches,
                                           tmp_path):
    """Phase 0 done by the JAX trainer (its dir holds net_epoch=1.msgpack
    and .opt) is skipped; phase 1 (`pretrained=-1`, lr 0 so that its
    parameters stay as loaded) starts from the JAX weights, moves only
    the BN statistics and writes the port's `.tar`."""
    src, _, variables = jax_checkpoint
    logs = tmp_path / "logs"
    copy_phase(str(src), str(logs / "00"))
    infos = run_train_on(tmp_path, logs, CHAIN, patches)
    assert len(infos) == 1 and infos[0].train_state.step == 2
    desc = t_ckpt.load_torch_tar(str(logs / "01" / "net_epoch=1.tar"))
    want = t_ckpt.state_dict_from_jax(variables, CFG)
    params = [n for n, _ in HoVerNet(CFG).named_parameters()]
    for key in params:
        assert torch.equal(desc[key], want[key]), key
    assert not torch.equal(desc["d3.blk_bna.bn.running_var"],
                           want["d3.blk_bna.bn.running_var"])


def test_resume_continues_a_jax_phase(jax_checkpoint, patches, tmp_path):
    """One phase of two epochs whose first the JAX trainer wrote: the port
    resumes at step 2 with the Adam moments of the `.opt`, takes epoch 2
    (2 steps) and writes `net_epoch=2.tar`; `last_checkpoint` then takes
    the `.tar`, and of equal epochs it prefers the `.tar`."""
    src, path, _ = jax_checkpoint
    logs = tmp_path / "logs"
    copy_phase(str(src), str(logs))
    assert last_checkpoint(str(logs)).endswith("net_epoch=1.msgpack")
    infos = run_train_on(tmp_path, logs, RESUME, patches)
    assert len(infos) == 1 and infos[0].train_state.step == 4
    assert np.all(np.isfinite(infos[0].losses)) and len(infos[0].losses) == 2
    payload = torch.load(logs / "net_epoch=2.tar", weights_only=True)
    assert payload["step"] == 4
    assert {float(s["step"]) for s in
            payload["optimizer"]["state"].values()} == {4.0}
    assert last_checkpoint(str(logs)).endswith("net_epoch=2.tar")
    # the resumed moments: the .opt's, decayed twice and fed two gradients
    _, opt_sd, _ = t_ckpt.load_train_msgpack(path, HoVerNet(CFG))
    loaded = [opt_sd["state"][i]["exp_avg"] for i in opt_sd["state"]]
    assert sum(bool(m.any()) for m in loaded) > 0.8 * len(loaded)
    for i, m0 in enumerate(loaded):
        assert not torch.equal(m0, payload["optimizer"]["state"][i][
            "exp_avg"]), i
    # equal epochs: the port's .tar first
    (logs / "net_epoch=2.msgpack").write_bytes(b"")
    assert last_checkpoint(str(logs)).endswith("net_epoch=2.tar")
    (logs / "net_epoch=3.msgpack").write_bytes(b"")
    assert last_checkpoint(str(logs)).endswith("net_epoch=3.msgpack")
