"""The port's tile path against the JAX package's, on the CPU.

- the tile pipeline (gather, forward, stitch) gives the JAX pipeline's
  stitched map on the same image and carried weights (f32, width 8);
- given the same stitched map, the mirror, post-processing, label
  compaction and instance tables are identical, typed and untyped;
- the port's CLI writes the JAX CLI's files with the same json schema;
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


def test_cli_matches_jax_cli(tmp_path):
    """Both CLIs on the same `.tar` and image: the same output files and
    the same json schema."""
    import cv2

    from hover_net_tpu.cli.run_infer import main as jax_main
    from hover_net_tpu.models.checkpoints import save_torch_tar
    from hover_net_tpu_torch.cli.run_infer import main as port_main

    cfg = JaxConfig(mode="fast", nr_types=5, width=WIDTH)
    model = JaxHoVerNet(cfg)
    variables = jax.jit(lambda: model.init(
        jax.random.PRNGKey(2), jnp.zeros((1, 256, 256, 3)), train=False))()
    variables = jax.tree_util.tree_map(np.asarray, variables)
    # a constant foreground np head, so both runs find instances
    head = dict(variables["params"]["decoder_np"]["u0_conv"])
    head["kernel"] = np.zeros_like(head["kernel"])
    head["bias"] = np.array([-2.0, 2.0], np.float32)
    variables["params"]["decoder_np"]["u0_conv"] = head
    tar = str(tmp_path / "m.tar")
    save_torch_tar(tar, variables, cfg)

    in_dir = tmp_path / "in"
    os.makedirs(in_dir)
    img = np.random.default_rng(0).integers(0, 255, (170, 190, 3),
                                            dtype=np.uint8)
    cv2.imwrite(str(in_dir / "t.png"), img)
    common = ["--model_path", tar, "--model_mode", "fast", "--width",
              str(WIDTH), "--nr_types", "5", "--type_info_path",
              os.path.join(REPO, "type_info.json"), "--batch_size", "4"]
    tile = ["tile", "--input_dir", str(in_dir), "--save_qupath"]
    outs = {}
    cwd = os.getcwd()
    os.chdir(tmp_path)  # the JAX CLI logs to ./debug.log
    try:
        jax_main(common + tile + ["--output_dir", str(tmp_path / "jax")])
        port_main(common + ["--device", "cpu"] + tile
                  + ["--output_dir", str(tmp_path / "port")])
    finally:
        os.chdir(cwd)
    for name in ("jax", "port"):
        root = tmp_path / name
        outs[name] = sorted(os.path.relpath(os.path.join(d, f), root)
                            for d, _, fs in os.walk(root) for f in fs)
    assert outs["port"] == outs["jax"] == [
        "json/t.json", "mat/t.mat", "overlay/t.png", "qupath/t.tsv"]

    payload = {}
    for name in ("jax", "port"):
        with open(tmp_path / name / "json" / "t.json") as f:
            payload[name] = json.load(f)
    assert set(payload["port"]) == set(payload["jax"]) == {"mag", "nuc"}
    assert payload["port"]["nuc"] and payload["jax"]["nuc"]
    keys = {name: {tuple(sorted(v)) for v in p["nuc"].values()}
            for name, p in payload.items()}
    assert keys["port"] == keys["jax"] == {
        ("bbox", "centroid", "contour", "type", "type_prob")}

    import scipy.io as sio

    mats = {name: sio.loadmat(str(tmp_path / name / "mat" / "t.mat"))
            for name in ("jax", "port")}
    assert ({k for k in mats["port"] if not k.startswith("__")}
            == {k for k in mats["jax"] if not k.startswith("__")})
    assert mats["port"]["inst_map"].shape == (170, 190)


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
