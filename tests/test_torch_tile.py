"""The port's tile path against the JAX package's, on the CPU.

- the tile pipeline (gather, forward, stitch) gives the JAX pipeline's
  stitched map on the same image and carried weights (f32, width 8);
- given the same stitched map, the mirror, post-processing, label
  compaction and instance tables are identical, typed and untyped;
- the port's CLI writes the JAX CLI's files with the same json schema;
  with `--host_post_proc` (float32 managers) the same instances, and
  the manager's host branch gives the JAX host branch's outputs;
- no module of the port imports jax or flax.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hover_net_tpu.data.tiling import bucket_grid_dim, prepare_tile_patching
from hover_net_tpu.models import HoVerNet as JaxHoVerNet
from hover_net_tpu.models import HoVerNetConfig as JaxConfig
from hover_net_tpu_torch.infer import steps as port_steps
from hover_net_tpu_torch.models.checkpoints import state_dict_from_jax
from hover_net_tpu_torch.models.hovernet import HoVerNet, HoVerNetConfig

from test_torch_kernels import nuclei_pred

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WIDTH = 8


def canvas(img, win=256, step=164):
    """The JAX TileInferManager's zero-extended canonical canvas."""
    pads, coords, grid = prepare_tile_patching(img.shape[:2], win, step)
    padded = np.pad(img, ((pads[0], pads[1]), (pads[2], pads[3]), (0, 0)),
                    mode="reflect")
    rows, cols = bucket_grid_dim(grid[0]), bucket_grid_dim(grid[1])
    return padded, coords.astype(np.int32), (rows, cols)


def test_tile_pipeline_matches_jax():
    from hover_net_tpu.infer.steps import make_tile_pipeline

    cfg = JaxConfig(mode="fast", nr_types=None, width=WIDTH)
    model = JaxHoVerNet(cfg)
    variables = jax.jit(lambda: model.init(
        jax.random.PRNGKey(1), jnp.zeros((1, 256, 256, 3)), train=False))()
    img = np.random.default_rng(0).integers(
        0, 255, (180, 200, 3), dtype=np.uint8)
    padded, coords, grid = canvas(img)
    want = make_tile_pipeline(model, grid, src_hw=None)(
        variables, jnp.asarray(padded), jnp.asarray(coords),
        jnp.asarray(img.shape[:2], jnp.int32))

    pcfg = HoVerNetConfig(mode="fast", nr_types=None, width=WIDTH)
    net = HoVerNet(pcfg).eval()
    net.load_state_dict(state_dict_from_jax(
        jax.tree_util.tree_map(np.asarray, variables), pcfg))
    got = port_steps.make_tile_pipeline(net, grid)(
        torch.from_numpy(padded), torch.from_numpy(coords.astype(np.int64)),
        img.shape[:2])

    full_j, full_p = np.asarray(want[0]), got[0].numpy()
    assert full_p.shape == full_j.shape == (328, 328, 3)
    rel = np.abs(full_p - full_j).max() / max(1.0, np.abs(full_j).max())
    assert rel < 2e-4, rel


@pytest.mark.parametrize("typed", [False, True])
def test_post_proc_and_tables_match_jax(typed):
    """Same stitched canonical map -> identical instance map, label count
    and tables."""
    from hover_net_tpu.infer.steps import _reflect_pp, _tables_tail

    rng = np.random.default_rng(5 + typed)
    src = (150, 140)
    seg = np.zeros((192, 192, 3), np.float32)
    seg[:src[0], :src[1]] = nuclei_pred(src, rng, 40, edge_touching=True)
    seg[src[0]:] = 0.7  # garbage the mirror must overwrite
    seg[:, src[1]:] = 0.7
    full = seg
    if typed:
        tp = rng.integers(0, 5, seg.shape[:2]).astype(np.float32)
        full = np.dstack([tp, seg])
    nr_types = 5 if typed else None

    fj, inst_b = _reflect_pp(jnp.asarray(full), jnp.asarray(src, jnp.int32),
                             typed, exact=True)
    inst_j, n_j, tp_j, tab_j = _tables_tail(fj, inst_b, typed, nr_types)

    fp, valid = port_steps.reflect_canvas(torch.from_numpy(full), src)
    np.testing.assert_array_equal(fp.numpy(), np.asarray(fj))
    segp = fp[..., 1:4] if typed else fp[..., 0:3]
    from hover_net_tpu_torch.ops.post_proc_device import proc_np_hv_batch

    inst_p = proc_np_hv_batch(segp[None], valid[None])
    np.testing.assert_array_equal(inst_p.numpy(), np.asarray(inst_b))
    inst_q, n_p, tp_p, tab_p = port_steps.tables_tail(fp, inst_p, nr_types)

    assert int(np.asarray(n_j)[0]) > 10
    np.testing.assert_array_equal(inst_q.numpy(), np.asarray(inst_j))
    np.testing.assert_array_equal(n_p.numpy(), np.asarray(n_j))
    np.testing.assert_array_equal(tp_p.numpy(), np.asarray(tp_j))
    for key in ("stats", "coo", "coo_n"):
        np.testing.assert_array_equal(tab_p[key].numpy(),
                                      np.asarray(tab_j[key]), err_msg=key)


def forced_foreground_variables(nr_types=5, seed=2, mode="fast"):
    """(JAX config, {params, batch_stats} as numpy) of a width-8 seeded
    JAX init whose np head is a constant foreground, so both packages find
    instances (cut by the hv maps of the random net)."""
    cfg = JaxConfig(mode=mode, nr_types=nr_types, width=WIDTH)
    model = JaxHoVerNet(cfg)
    size = cfg.patch_input_shape
    variables = jax.jit(lambda: model.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, size, size, 3)),
        train=False))()
    variables = jax.tree_util.tree_map(np.asarray, variables)
    head = dict(variables["params"]["decoder_np"]["u0_conv"])
    head["kernel"] = np.zeros_like(head["kernel"])
    head["bias"] = np.array([-2.0, 2.0], np.float32)
    variables["params"]["decoder_np"]["u0_conv"] = head
    return cfg, variables


def forced_foreground_tar(path, nr_types=5, seed=2, mode="fast"):
    """A reference `.tar` of `forced_foreground_variables`."""
    from hover_net_tpu.models.checkpoints import save_torch_tar

    cfg, variables = forced_foreground_variables(nr_types, seed, mode)
    save_torch_tar(path, variables, cfg)
    return path


@pytest.fixture(scope="module")
def typed_tar(tmp_path_factory):
    return forced_foreground_tar(str(tmp_path_factory.mktemp("ckpt") / "m.tar"))


@pytest.fixture
def f32_managers(monkeypatch):
    """Both packages' tile managers in float32. The CLIs have no dtype
    flag, and in bf16 the random net's hv maps (values in the thousands)
    sit at the noise floor where the two packages' instances part
    (AJI ~0.65, the same as either package's bf16 against its own f32);
    in float32 they agree."""
    import functools

    from hover_net_tpu.infer.tile import TileInferManager as JaxTile
    from hover_net_tpu_torch.infer.tile import TileInferManager as PortTile

    for cls, dtype in ((JaxTile, jnp.float32), (PortTile, torch.float32)):
        monkeypatch.setattr(cls, "__init__", functools.partialmethod(
            cls.__init__, dtype=dtype))


def run_both_clis(tmp_path, tar, flags, shape=(170, 190)):
    """Both CLIs' `tile` on one seeded image (typed, qupath on); returns
    {"jax" | "port": sorted relative paths written}."""
    import cv2

    from hover_net_tpu.cli.run_infer import main as jax_main
    from hover_net_tpu_torch.cli.run_infer import main as port_main

    in_dir = tmp_path / "in"
    os.makedirs(in_dir)
    img = np.random.default_rng(0).integers(0, 255, shape + (3,),
                                            dtype=np.uint8)
    cv2.imwrite(str(in_dir / "t.png"), img)
    common = ["--model_path", tar, "--model_mode", "fast", "--width",
              str(WIDTH), "--nr_types", "5", "--type_info_path",
              os.path.join(REPO, "type_info.json"), "--batch_size", "4"]
    tile = ["tile", "--input_dir", str(in_dir), "--save_qupath"]
    cwd = os.getcwd()
    os.chdir(tmp_path)  # the JAX CLI logs to ./debug.log
    try:
        jax_main(common + flags + tile
                 + ["--output_dir", str(tmp_path / "jax")])
        port_main(common + flags + ["--device", "cpu"] + tile
                  + ["--output_dir", str(tmp_path / "port")])
    finally:
        os.chdir(cwd)
    outs = {}
    for name in ("jax", "port"):
        root = tmp_path / name
        outs[name] = sorted(os.path.relpath(os.path.join(d, f), root)
                            for d, _, fs in os.walk(root) for f in fs)
    return outs


def read_outputs(root):
    """(json payload, mat dict) of the image `t` under `root`."""
    import scipy.io as sio

    with open(root / "json" / "t.json") as f:
        payload = json.load(f)
    return payload, sio.loadmat(str(root / "mat" / "t.mat"))


def test_cli_matches_jax_cli(tmp_path, typed_tar):
    """Both CLIs on the same `.tar` and image: the same output files and
    the same json schema."""
    outs = run_both_clis(tmp_path, typed_tar, [])
    assert outs["port"] == outs["jax"] == [
        "json/t.json", "mat/t.mat", "overlay/t.png", "qupath/t.tsv"]

    (pay_p, mat_p), (pay_j, mat_j) = (read_outputs(tmp_path / "port"),
                                      read_outputs(tmp_path / "jax"))
    assert set(pay_p) == set(pay_j) == {"mag", "nuc"}
    assert pay_p["nuc"] and pay_j["nuc"]
    keys = {name: {tuple(sorted(v)) for v in p["nuc"].values()}
            for name, p in (("port", pay_p), ("jax", pay_j))}
    assert keys["port"] == keys["jax"] == {
        ("bbox", "centroid", "contour", "type", "type_prob")}
    assert ({k for k in mat_p if not k.startswith("__")}
            == {k for k in mat_j if not k.startswith("__")})
    assert mat_p["inst_map"].shape == (170, 190)


def test_host_post_proc_cli_matches_jax_cli(tmp_path, typed_tar,
                                            f32_managers):
    """`--host_post_proc` in both CLIs (float32 managers): the same files,
    an identical inst_map and equal json nuclei."""
    outs = run_both_clis(tmp_path, typed_tar, ["--host_post_proc"])
    assert outs["port"] == outs["jax"] == [
        "json/t.json", "mat/t.mat", "overlay/t.png", "qupath/t.tsv"]
    (pay_p, mat_p), (pay_j, mat_j) = (read_outputs(tmp_path / "port"),
                                      read_outputs(tmp_path / "jax"))
    np.testing.assert_array_equal(mat_p["inst_map"], mat_j["inst_map"])
    assert pay_p == pay_j and len(pay_j["nuc"]) > 5
    for key in ("inst_centroid", "inst_type", "inst_uid"):
        np.testing.assert_array_equal(mat_p[key], mat_j[key], err_msg=key)


def test_host_manager_matches_jax(tmp_path):
    """TileInferManager(device_post_proc=False) in float32, untyped, on
    the CPU: the JAX manager's prediction map, label map and info."""
    from hover_net_tpu.infer.tile import TileInferManager as JaxTile
    from hover_net_tpu_torch.infer.tile import TileInferManager as PortTile

    from test_torch_host_copies import assert_same

    tar = forced_foreground_tar(str(tmp_path / "m.tar"), None, seed=3)
    kw = dict(model_path=tar, mode="fast", width=WIDTH, batch_size=4,
              device_post_proc=False)
    img = np.random.default_rng(1).integers(0, 255, (300, 340, 3),
                                            dtype=np.uint8)
    want = JaxTile(dtype=jnp.float32, **kw).predict_image(img)
    mgr = PortTile(dtype=torch.float32, device="cpu", **kw)
    got = mgr.predict_image(img)
    assert got[0].shape == want[0].shape == (300, 340, 3)
    rel = np.abs(got[0] - want[0]).max() / max(1.0, np.abs(want[0]).max())
    assert rel < 2e-4, rel
    assert_same(got[1:], want[1:])
    assert len(want[2]) > 5 and mgr.last_post_proc_ms > 0


def test_n_devices_above_one_exits():
    """`--n_devices 2` is accepted (multi-device inference is ported,
    tests/test_torch_multidevice.py): the CLI exits with an error only on
    what it cannot run, here the absent checkpoint, and without a GPU the
    default CUDA device (there is no fallback to the CPU)."""
    from hover_net_tpu_torch.cli.run_infer import main as port_main

    argv = ["--model_path", "absent.tar", "--n_devices", "2", "tile",
            "--input_dir", "in", "--output_dir", "out"]
    with pytest.raises(FileNotFoundError):
        port_main(["--device", "cpu"] + argv)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            port_main(argv)


def test_port_imports_no_jax():
    """Every module of the port, the CLI included, imports without jax or
    flax."""
    code = (
        "import pkgutil, sys, hover_net_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for n in names: __import__(n)\n"
        "for n in ('cli.run_infer', 'infer.wsi', 'models.encoder_fused',\n"
        "          'ops.fused_block_cuda', 'ops.nvcc_build'):\n"
        "    assert 'hover_net_tpu_torch.' + n in sys.modules, n\n"
        "bad = [m for m in ('jax', 'flax', 'hover_net_tpu.infer.base')\n"
        "       if m in sys.modules]\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 16
