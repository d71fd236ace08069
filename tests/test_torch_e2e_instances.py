"""Both packages' managers end to end on the CPU, in float32: the same
instances.

- tile: `TileInferManager.process_file_list` (the device post-processing
  branch; on the CPU the port runs K1's plain version) on one typed
  300x340 image gives an identical inst_map and equal json nuclei;
- WSI: `WSIInferManager.process_wsi_list` on a 600x500 pseudo-slide of
  synthetic nuclei with a tissue mask gives identical json nuclei;
- the port's CLI with `--profile_dir` writes a torch.profiler trace for
  `tile` and for `wsi`.

The weights are a seeded width-8 JAX init with a constant foreground np
head (tests/test_torch_tile.py), so the instances are cut by the hv maps
alone; float32 because in bf16 the random net sits at the noise floor.
"""

import glob
import json
import os

import cv2
import numpy as np
import pytest
import scipy.io as sio
import torch

import jax.numpy as jnp

from test_torch_tile import forced_foreground_tar
from test_wsi import _paint_nuclei

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TYPE_INFO = os.path.join(REPO, "type_info.json")
COMMON = dict(mode="fast", nr_types=5, width=8, type_info_path=TYPE_INFO)


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """(tar, tile input dir, slide dir, mask dir)."""
    root = tmp_path_factory.mktemp("e2e")
    tar = forced_foreground_tar(str(root / "m.tar"), 5, seed=2)
    tile_dir, slide_dir, mask_dir = (root / n for n in ("in", "slides",
                                                        "masks"))
    for d in (tile_dir, slide_dir, mask_dir):
        os.makedirs(d)
    img = np.random.default_rng(0).integers(0, 255, (300, 340, 3),
                                            dtype=np.uint8)
    cv2.imwrite(str(tile_dir / "t.png"), img)
    rng = np.random.default_rng(3)
    inst = _paint_nuclei((600, 500), rng, 40)
    slide = np.full((600, 500, 3), (230, 200, 220), np.uint8)
    slide[inst > 0] = (120, 60, 150)
    np.save(str(slide_dir / "s.npy"),
            (slide - rng.integers(0, 20, slide.shape)).astype(np.uint8))
    mask = np.zeros((600 // 8, 500 // 8), np.uint8)
    mask[5:-5, 5:-5] = 255
    cv2.imwrite(str(mask_dir / "s.png"), mask)
    return tar, str(tile_dir), str(slide_dir), str(mask_dir)


def test_tile_managers_give_the_same_instances(inputs, tmp_path):
    from hover_net_tpu.infer.tile import TileInferManager as JaxTile
    from hover_net_tpu_torch.infer.tile import TileInferManager as PortTile

    tar, tile_dir, _, _ = inputs
    JaxTile(model_path=tar, dtype=jnp.float32, batch_size=4, **COMMON) \
        .process_file_list(tile_dir, str(tmp_path / "jax"))
    PortTile(model_path=tar, dtype=torch.float32, batch_size=4,
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


def test_wsi_managers_give_the_same_instances(inputs, tmp_path):
    from hover_net_tpu.infer.wsi import WSIInferManager as JaxWSI
    from hover_net_tpu_torch.infer.wsi import WSIInferManager as PortWSI

    tar, _, slide_dir, mask_dir = inputs
    kw = dict(model_path=tar, batch_size=8, chunk_shape=1000,
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


@pytest.mark.parametrize("command", ["tile", "wsi"])
def test_profile_dir_writes_a_trace(inputs, tmp_path, command, monkeypatch):
    import functools

    from hover_net_tpu_torch.cli.run_infer import main
    from hover_net_tpu_torch.infer.base import InferManagerBase

    # float32 managers: the CLI has no dtype flag, and bf16 convolutions
    # on the CPU take several times as long
    monkeypatch.setattr(InferManagerBase, "__init__", functools.partialmethod(
        InferManagerBase.__init__, dtype=torch.float32))
    tar, tile_dir, slide_dir, mask_dir = inputs
    prof = tmp_path / "prof"
    argv = ["--model_path", tar, "--nr_types", "5", "--type_info_path",
            TYPE_INFO, "--width", "8", "--batch_size", "8", "--device",
            "cpu", "--profile_dir", str(prof), command, "--output_dir",
            str(tmp_path / "out")]
    if command == "tile":
        argv += ["--input_dir", tile_dir, "--save_format", "json"]
    else:
        argv += ["--input_dir", slide_dir, "--input_mask_dir", mask_dir,
                 "--tile_shape", "256", "--ambiguous_size", "32",
                 "--chunk_shape", "1000",
                 "--cache_path", str(tmp_path / "cache")]
    main(argv)
    traces = glob.glob(str(prof / "*.pt.trace.json"))
    assert len(traces) == 1
    with open(traces[0]) as f:
        events = json.load(f)["traceEvents"]
    assert any(e.get("name", "").startswith("aten::conv") for e in events)
    written = glob.glob(str(tmp_path / "out" / "**" / "*.json"),
                        recursive=True)
    assert [os.path.basename(p) for p in written] == [
        "t.json" if command == "tile" else "s.json"]
