"""The port's multi-device inference against one device and against the
JAX package's mesh, on the CPU.

The port's mesh is an ordered list of stripe slots, each bound to a
`torch.device`, and a device may fill several slots: here every slot is
the CPU (`["cpu"] * n`), as the JAX side runs on the 8 virtual host
devices of tests/conftest.py. Every comparison is exact:

- the collectives (`all_gather`, `psum_scatter`, `shard_batch`) against
  numpy and against `jax.lax.all_gather` / `psum_scatter` (tiled) in a
  `shard_map` over 4 devices;
- the striped pred buffer's geometry against the JAX manager's
  `_alloc_pred_dev`;
- the striped 3-phase post-processing of a 300x260 map
  (`_dryrun_striped_once`): 4 slots == 1 device == the JAX package's 4
  devices, instance map and ids;
- the WSI manager end to end on the 600x500 pseudo-slide of
  tests/test_torch_e2e_instances.py (float32, 256^2 post-proc tiles,
  tissue in its top 320 rows: the stripes' border at row 256 runs
  through it) on 3 slots, device-resident and mmap: inst_map and json
  nuclei equal the port's single-device run and the JAX manager's
  `n_devices=3` run, with the tail called once per shard;
- the tile manager's round-robin (a dispatch thread a slot) and its
  clamp on three small images, and both CLIs with `--n_devices 2`;
- two slots on distinct devices (`["cpu", "cpu:0"]`, which compare and
  hash unequal): the second slot runs a copy of the model, the tile
  pipelines and the WSI stripes go by slot, and the outputs equal one
  device's;
- `entry()` against the JAX package's `__graft_entry__.entry()`.
"""

import functools
import glob
import json
import logging
import os

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax.sharding import PartitionSpec as P

from hover_net_tpu.infer import wsi as jax_wsi
from hover_net_tpu.models import HoVerNetConfig as JaxConfig
from hover_net_tpu.ops.targets import gen_instance_hv_map
from hover_net_tpu.parallel.mesh import make_mesh as jax_mesh
from hover_net_tpu.parallel.mesh import shard_map_compat
from hover_net_tpu_torch.infer import wsi as port_wsi
from hover_net_tpu_torch.models.hovernet import HoVerNetConfig
from hover_net_tpu_torch.parallel.mesh import (
    all_gather,
    make_mesh,
    psum_scatter,
    replicate,
    shard_batch,
)

from test_torch_e2e_instances import COMMON, inputs  # noqa: F401

# several worker processes share the host's cores (tests/test_torch_wsi.py)
torch.set_num_threads(1)
# post-proc tile of the CLI's WSI runs: a tenth of the
# time 256^2 tiles take on the CPU (the plain watershed floods the random
# net's few markers over whole windows)
CLI_TILE = 352
IMAGES = {"a": (164, 164), "b": (120, 150), "c": (150, 120)}


@pytest.fixture(scope="module")
def top_mask(tmp_path_factory):
    """A tissue mask of the pseudo-slide's rows 40..320 (at 1/8 scale):
    half the post-proc windows of the whole slide, where the CPU's plain
    watershed spends most of these tests' time."""
    root = tmp_path_factory.mktemp("top_mask")
    mask = np.zeros((600 // 8, 500 // 8), np.uint8)
    mask[5:40, 5:-5] = 255
    cv2.imwrite(str(root / "s.png"), mask)
    return str(root)


@pytest.fixture(scope="module")
def tiles(tmp_path_factory):
    """A directory of three small RGB images (one 256^2 patch each)."""
    root = tmp_path_factory.mktemp("tiles")
    rng = np.random.default_rng(5)
    for name, hw in IMAGES.items():
        cv2.imwrite(str(root / f"{name}.png"),
                    rng.integers(0, 255, hw + (3,), dtype=np.uint8))
    return str(root)


def cpu_mesh(n):
    return make_mesh(devices=["cpu"] * n)


# ----------------------------------------------------------- collectives

def test_mesh_collectives():
    rng = np.random.default_rng(0)
    mesh = cpu_mesh(4)
    assert len(mesh) == 4 and mesh.devices == [torch.device("cpu")]
    x = rng.integers(-50, 50, (8, 3, 5)).astype(np.float32)
    shards = shard_batch(mesh, torch.from_numpy(x))
    assert [tuple(s.shape) for s in shards] == [(2, 3, 5)] * 4
    np.testing.assert_array_equal(torch.cat(shards).numpy(), x)
    # uneven: 3 rows a slot, the last shards short and empty
    assert [len(s) for s in shard_batch(mesh, torch.from_numpy(x), 3)] == [
        3, 3, 2, 0]
    reps = replicate(torch.from_numpy(x), mesh)
    assert len(reps) == 4 and all(r is reps[0] for r in reps)  # one copy

    parts = rng.integers(-50, 50, (4, 8, 3, 5)).astype(np.float32)
    gathered = all_gather([torch.from_numpy(p) for p in parts], mesh)
    scattered = psum_scatter([torch.from_numpy(p) for p in parts], mesh)
    for g in gathered:
        np.testing.assert_array_equal(g.numpy(), parts.reshape(32, 3, 5))
    total = parts.sum(axis=0)
    for d, s in enumerate(scattered):
        np.testing.assert_array_equal(s.numpy(), total[2 * d:2 * d + 2])
    short = psum_scatter([torch.from_numpy(p) for p in parts], mesh, 3)
    assert [len(s) for s in short] == [3, 3, 2, 0]
    np.testing.assert_array_equal(torch.cat(short).numpy(), total)

    # the JAX collectives on a 4-device mesh: slot d holds parts[d]
    jm = jax_mesh(4)
    spec = (P("data"),)
    jag = jax.jit(shard_map_compat(
        lambda a: jax.lax.all_gather(a, "data", axis=0, tiled=True),
        jm, spec, P("data")))(parts.reshape(32, 3, 5))
    jps = jax.jit(shard_map_compat(
        lambda a: jax.lax.psum_scatter(a, "data", scatter_dimension=0,
                                       tiled=True),
        jm, spec, P("data")))(parts.reshape(32, 3, 5))
    assert jag.shape == (4 * 32, 3, 5) and jps.shape == (8, 3, 5)
    np.testing.assert_array_equal(
        np.asarray(jag), torch.cat(gathered).numpy())
    np.testing.assert_array_equal(
        np.asarray(jps), torch.cat(scattered).numpy())


def test_make_mesh_counts_devices():
    assert len(make_mesh(2, ["cpu"] * 4)) == 2
    with pytest.raises(ValueError, match="need 5 devices"):
        make_mesh(5, ["cpu"] * 4)


# -------------------------------------------------------- stripe geometry

@pytest.mark.parametrize("shape", [(300, 260), (1000, 513), (2048, 1536)])
@pytest.mark.parametrize("n", [1, 2, 3, 4])
def test_stripe_geometry_matches_jax(n, shape):
    port = port_wsi.WSIInferManager.__new__(port_wsi.WSIInferManager)
    port.cfg = HoVerNetConfig(mode="fast", nr_types=None, width=8)
    port.mesh = cpu_mesh(n) if n > 1 else None
    ref = jax_wsi.WSIInferManager.__new__(jax_wsi.WSIInferManager)
    ref.cfg = JaxConfig(mode="fast", nr_types=None, width=8)
    ref.mesh = jax_mesh(n) if n > 1 else None
    ref.n_devices = n
    for mgr in (port, ref):
        mgr.pred_map_dtype = np.dtype("float16")
        mgr.wsi_proc_shape = np.array(shape)
        mgr._alloc_pred_dev(3)
    assert port._stripe == ref._stripe
    if n == 1:
        assert port._stripe is None
        assert tuple(port._pred_dev.shape) == ref._pred_dev.shape
        return
    s_rows, halo = port._stripe
    assert halo == port_wsi._STRIPE_HALO
    assert n * s_rows >= shape[0] + 164 and s_rows % 256 == 0
    bw = ref._pred_dev.shape[1]
    assert [tuple(b.shape) for b in port._pred_dev] == [
        (s_rows + 2 * halo, bw, 3)] * n
    assert ref._pred_dev.shape == (n * (s_rows + 2 * halo), bw, 3)


# --------------------------------------------------------------- dryrun

def dryrun_pred():
    """The 300x260 float16 map of 40 discs of `dryrun_striped_infer`."""
    rng = np.random.default_rng(3)
    shape = (300, 260)
    inst = np.zeros(shape, np.int32)
    for k in range(1, 41):
        cy = int(rng.integers(10, shape[0] - 10))
        cx = int(rng.integers(10, shape[1] - 10))
        r = int(rng.integers(4, 8))
        yy, xx = np.mgrid[-r:r + 1, -r:r + 1]
        sub = inst[cy - r:cy + r + 1, cx - r:cx + r + 1]
        sub[((yy ** 2 + xx ** 2) <= r * r) & (sub == 0)] = k
    hv = gen_instance_hv_map(inst, shape)
    return np.dstack([(inst > 0).astype(np.float32), hv[..., 0],
                      hv[..., 1]]).astype(np.float16), shape


@pytest.fixture(scope="module")
def striped4():
    """(pred, shape, inst_map, ids) of the port's 4-slot dryrun."""
    pred, shape = dryrun_pred()
    return (pred, shape) + port_wsi._dryrun_striped_once(4, pred, shape,
                                                         ["cpu"] * 4)


def test_dryrun_striped_matches_single_and_jax(striped4):
    """`dryrun_striped_infer` checks 4 slots against 1 device itself (and
    raises on a difference); `_dryrun_striped_once` with 4 slots gives
    the JAX package's 4-device instance map and ids."""
    pred, shape, inst4, keys4 = striped4
    want, want_keys = jax_wsi._dryrun_striped_once(4, pred, shape)
    np.testing.assert_array_equal(inst4, want)
    assert keys4 == want_keys
    assert len(keys4) > 10
    assert port_wsi.dryrun_striped_infer(4, ["cpu"] * 4) == {
        "n_instances": len(want_keys)}


def test_dryrun_detects_stripes_keyed_by_device(striped4, monkeypatch):
    """Slots that share a device must still read their own stripes: every
    slot reading slot 0's stripe (a stripe keyed by the device) gives
    another instance map."""
    pred, shape, inst4, _ = striped4
    read = port_wsi.WSIInferManager._stripe_windows
    monkeypatch.setattr(port_wsi.WSIInferManager, "_stripe_windows",
                        lambda self, d, *a: read(self, 0, *a))
    wrong, _ = port_wsi._dryrun_striped_once(4, pred, shape, ["cpu"] * 4)
    assert not np.array_equal(wrong, inst4)


# --------------------------------------------------------- WSI end to end

WSI_KW = dict(batch_size=4, chunk_shape=1000, tile_shape=256,
              ambiguous_size=32, proc_mag=40, pred_map_dtype="float32",
              **COMMON)


@pytest.fixture
def one_window_a_slot(monkeypatch):
    """Window batches of one window a slot (no phase here has more than 4
    windows of a shape, so at the default 4 only slot 0 would run the
    tail)."""
    cls = port_wsi.WSIInferManager
    monkeypatch.setattr(cls, "_dispatch_post_processing",
                        functools.partialmethod(
                            cls._dispatch_post_processing, batch=1))


def port_wsi_run(tar, slide_dir, mask_dir, root, name, **extra):
    """The port's WSI manager in float32 on the CPU through `run_wsi`:
    (json payload, inst_map, tail calls, manager)."""
    mgr = port_wsi.WSIInferManager(
        model_path=tar, dtype=torch.float32, device="cpu",
        cache_path=str(root / f"cache_{name}"), **dict(WSI_KW, **extra))
    return run_wsi(mgr, slide_dir, mask_dir, str(root / name)) + (mgr,)


def run_wsi(mgr, slide_dir, mask_dir, out):
    """process_wsi_list; (json payload, inst_map, tail calls)."""
    calls = []
    post_proc = mgr._post_proc

    def counted(seg, valid):
        calls.append(seg.shape[0])
        return post_proc(seg, valid)

    mgr._post_proc = counted
    assert mgr.process_wsi_list(slide_dir, out, input_mask_dir=mask_dir) == 1
    with open(os.path.join(out, "s.json")) as f:
        payload = json.load(f)
    return payload, np.array(mgr.wsi_inst_map), calls


def test_wsi_manager_striped_matches_single_and_jax(
        inputs, top_mask, tmp_path, one_window_a_slot):  # noqa: F811
    """The port's WSI manager on the pseudo-slide three ways (one device;
    3 CPU slots with the buffer device-resident, and in an mmap through
    a 1-byte budget) and the JAX manager with `n_devices=3`: identical
    json nuclei and inst_map. The port's window batches hold one window
    a slot: the tail runs once a window, in fewer batches under the
    mesh."""
    tar, _, slide_dir, _ = inputs
    runs = {name: port_wsi_run(tar, slide_dir, top_mask, tmp_path, name,
                               **extra)
            for name, extra in (
                ("single", {}),
                ("striped", dict(devices=["cpu"] * 3)),
                ("striped_mmap", dict(devices=["cpu"] * 3,
                                      hbm_pred_budget=1)))}
    ref = jax_wsi.WSIInferManager(
        model_path=tar, dtype=jnp.float32, n_devices=3,
        cache_path=str(tmp_path / "cache_jax"), **WSI_KW)
    assert ref.mesh is not None and ref.n_devices == 3
    ref.process_wsi_list(slide_dir, str(tmp_path / "jax"),
                         input_mask_dir=top_mask)
    with open(tmp_path / "jax" / "s.json") as f:
        want = json.load(f)
    want_map = np.array(ref.wsi_inst_map)

    single = runs["single"][3]
    assert single.mesh is None
    assert runs["striped"][3]._stripe is not None
    assert runs["striped_mmap"][3]._pred_map_path is not None
    for name in ("striped", "striped_mmap"):
        payload, inst_map, calls, mgr = runs[name]
        assert len(mgr.mesh) == 3
        assert payload == runs["single"][0] == want, name
        np.testing.assert_array_equal(inst_map, runs["single"][1])
        np.testing.assert_array_equal(inst_map, want_map)
        assert len(calls) == mgr.n_window_shards == single.n_window_shards
        assert set(calls) == {1}
        assert mgr.n_window_batches < mgr.n_window_shards
        assert mgr.n_forward_batches == single.n_forward_batches
    assert len(want["nuc"]) > 50


# ------------------------------------------------------------------ tile

def tile_run(mgr, tiles, out):
    """process_file_list in json mode: {image name: json payload}."""
    assert mgr.process_file_list(tiles, str(out), save_format="json") == 3
    names = sorted(IMAGES)
    assert [t["name"] for t in mgr.timings] == names  # input order
    assert mgr._rr == 3
    got = {}
    for n in names:
        with open(out / "json" / f"{n}.json") as f:
            got[n] = json.load(f)
    return got


def tile_manager(tar, **extra):
    from hover_net_tpu_torch.infer.tile import TileInferManager

    return TileInferManager(model_path=tar, dtype=torch.float32,
                            batch_size=4, **COMMON, **extra)


def test_tile_round_robin_matches_one_device(  # noqa: F811
        inputs, tiles, tmp_path, caplog):
    tar = inputs[0]
    with caplog.at_level(logging.WARNING, logger="hover_net_tpu_torch"):
        clamped = tile_manager(tar, device="cpu", n_devices=2)
    assert clamped.devices == (torch.device("cpu"),)
    assert "n_devices=2" in caplog.text
    out = {name: tile_run(mgr, tiles, tmp_path / name) for name, mgr in (
        ("one", tile_manager(tar, device="cpu")),
        ("two", tile_manager(tar, devices=["cpu"] * 2)),
        ("clamped", clamped))}
    assert out["two"] == out["one"] == out["clamped"]
    assert sum(len(v["nuc"]) for v in out["one"].values()) > 0


# ------------------------------------------------------- distinct devices

DISTINCT = ["cpu", "cpu:0"]


def assert_replica(mgr):
    """The run made the second device's model, once: a copy of the
    first's, another module with the same weights."""
    second = torch.device("cpu", 0)
    assert mgr.devices == (torch.device("cpu"), second)
    assert list(mgr._replicas) == [second]
    replica = mgr.model_on(second)
    assert replica is not mgr.model and replica is mgr._replicas[second]
    want = mgr.model.state_dict()
    got = replica.state_dict()
    assert list(got) == list(want)
    for k, v in want.items():
        assert got[k] is not v and torch.equal(got[k], v), k


def test_tile_distinct_devices_match_one_device(  # noqa: F811
        inputs, tiles, tmp_path):
    """Two slots on distinct devices: a dispatch thread and a pipeline a
    slot, the second slot's with the model copy; the json of one
    device."""
    tar = inputs[0]
    one = tile_run(tile_manager(tar, device="cpu"), tiles, tmp_path / "one")
    mgr = tile_manager(tar, devices=DISTINCT)
    assert tile_run(mgr, tiles, tmp_path / "two") == one
    assert_replica(mgr)
    assert {slot for _, slot in mgr._pipelines} == {0, 1}


def test_wsi_distinct_devices_match_one_device(
        inputs, top_mask, tmp_path, one_window_a_slot):  # noqa: F811
    """Two stripe slots on distinct devices: the chunk pushed to both,
    the second slot's forward shards on the model copy (one patch a
    shard: the masked slide has 4 patches); the json nuclei and inst_map
    of one device."""
    tar, _, slide_dir, _ = inputs
    single = port_wsi_run(tar, slide_dir, top_mask, tmp_path, "single",
                          batch_size=1)
    payload, inst_map, calls, mgr = port_wsi_run(
        tar, slide_dir, top_mask, tmp_path, "distinct", devices=DISTINCT,
        batch_size=1)
    assert mgr.mesh.devices == [torch.device(d) for d in DISTINCT]
    assert_replica(mgr)
    assert payload == single[0] and len(payload["nuc"]) > 50
    np.testing.assert_array_equal(inst_map, single[1])
    assert len(calls) == mgr.n_window_shards == single[3].n_window_shards
    assert mgr.n_forward_batches == single[3].n_forward_batches == 4


@pytest.mark.parametrize("command", ["tile", "wsi"])
def test_cli_n_devices(inputs, tiles, top_mask, tmp_path,  # noqa: F811
                      command, monkeypatch):
    from hover_net_tpu_torch.cli.run_infer import main
    from hover_net_tpu_torch.infer.base import InferManagerBase

    monkeypatch.setattr(InferManagerBase, "__init__", functools.partialmethod(
        InferManagerBase.__init__, dtype=torch.float32))
    tar, _, slide_dir, _ = inputs
    written = {}
    for n in (1, 2):
        out = tmp_path / f"out{n}"
        argv = ["--model_path", tar, "--nr_types", "5", "--type_info_path",
                COMMON["type_info_path"], "--width", "8", "--batch_size",
                "8", "--device", "cpu", "--n_devices", str(n), command,
                "--output_dir", str(out)]
        if command == "tile":
            argv += ["--input_dir", tiles, "--save_format", "json"]
        else:
            argv += ["--input_dir", slide_dir, "--input_mask_dir", top_mask,
                     "--tile_shape", str(CLI_TILE), "--ambiguous_size", "32",
                     "--chunk_shape", "1000",
                     "--cache_path", str(tmp_path / f"cache{n}")]
        mgr = main(argv)
        assert len(mgr.devices) == 1  # the CPU is one device
        paths = sorted(glob.glob(str(out / "**" / "*.json"), recursive=True))
        written[n] = {}
        for p in paths:
            with open(p) as f:
                written[n][os.path.relpath(p, out)] = json.load(f)
    assert list(written[2]) == ([f"json/{n}.json" for n in sorted(IMAGES)]
                                if command == "tile" else ["s.json"])
    assert written[2] == written[1]
    assert sum(len(v["nuc"]) for v in written[2].values()) > 0


# ----------------------------------------------------------------- entry

def test_entry_matches_jax_entry(monkeypatch):
    """The port's `entry()` at width 8 on the CPU: the output shape and
    dtype, the input batch and the model's heads of the JAX package's
    `__graft_entry__.entry()`."""
    import __graft_entry__
    # imported before jax.jit is patched below (their module-level jits)
    import hover_net_tpu.infer.steps  # noqa: F401
    from hover_net_tpu.models import HoVerNet
    from hover_net_tpu_torch.entry import entry

    # the JAX entry() initialises its width-64 weights in a jitted call;
    # its shapes are all this test needs, so that call only traces
    with monkeypatch.context() as m:
        m.setattr(jax, "jit", lambda f: functools.partial(jax.eval_shape, f))
        jfn, jargs = __graft_entry__.entry()
    want = jax.eval_shape(jfn, *jargs)
    fn, (model, imgs) = entry(device="cpu", width=8)
    got = fn(model, imgs)
    assert tuple(got.shape) == want.shape == (8, 164, 164, 4)
    assert got.dtype == torch.float32 and str(want.dtype) == "float32"
    assert tuple(imgs.shape) == jargs[1].shape
    assert bool(torch.isfinite(got).all())
    assert model.cfg.nr_types == 5 and model.cfg.dtype == torch.bfloat16
    with torch.no_grad():
        heads = model(imgs[:1].permute(0, 3, 1, 2))
    jheads = jax.eval_shape(
        lambda v, x: HoVerNet(JaxConfig(mode="fast", nr_types=5, width=64))
        .apply(v, x, train=False), jargs[0], jargs[1][:1])
    assert sorted(heads) == sorted(jheads) == ["hv", "np", "tp"]
