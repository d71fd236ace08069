"""The port's copies of the JAX package's host modules against their
originals, on the CPU.

Each copied function and its hover_net_tpu original get the same small
inputs and must give identical output. The native functions run through
the port's own library, built from hover_net_tpu_torch/csrc/ into
build/hover_net_tpu_torch/.
"""

import json
import os
import random

import numpy as np
import pytest
import torch

from hover_net_tpu.data import tiling as j_tiling
from hover_net_tpu.infer import wsi_handler as j_handler
from hover_net_tpu.metrics import stats as j_stats
from hover_net_tpu.ops import cc_np as j_cc
from hover_net_tpu.ops import instance_table as j_it
from hover_net_tpu.ops import post_proc_host as j_host
from hover_net_tpu.ops import targets as j_targets
from hover_net_tpu.utils import crops as j_crops
from hover_net_tpu.utils import qupath as j_qupath
from hover_net_tpu.utils import viz as j_viz
from hover_net_tpu_torch.data import tiling as t_tiling
from hover_net_tpu_torch.infer import wsi_handler as t_handler
from hover_net_tpu_torch.metrics import stats as t_stats
from hover_net_tpu_torch.ops import cc_np as t_cc
from hover_net_tpu_torch.ops import instance_table as t_it
from hover_net_tpu_torch.ops import post_proc_device as t_ppd
from hover_net_tpu_torch.ops import post_proc_host as t_host
from hover_net_tpu_torch.ops import targets as t_targets
from hover_net_tpu_torch.utils import crops as t_crops
from hover_net_tpu_torch.utils import qupath as t_qupath
from hover_net_tpu_torch.utils import viz as t_viz

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def assert_same(got, want, where=""):
    """Equal type and value, through tuples, lists and dicts of arrays."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), where
        for k in want:
            assert_same(got[k], want[k], f"{where}[{k}]")
    elif isinstance(want, (tuple, list)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray), where
        assert got.dtype == want.dtype, (where, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert got == want, (where, got, want)


def blobs(shape=(96, 88), n=14, seed=0):
    """[H, W] int32 map of n overlapping disc instances (ids 1..n, some
    cut into fragments by later discs)."""
    rng = np.random.default_rng(seed)
    inst = np.zeros(shape, np.int32)
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    for k in range(1, n + 1):
        cy, cx = rng.integers(0, shape[0]), rng.integers(0, shape[1])
        r = rng.integers(3, 12)
        inst[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = k
    return inst


# ----------------------------------------------------------------- tiling

TILING_CASES = {
    "tile_patching": lambda m: [m.prepare_tile_patching(hw, 256, 164)
                                for hw in ((1000, 1000), (300, 340),
                                           (164, 164), (1500, 700))],
    "bucket_grid_dim": lambda m: [m.bucket_grid_dim(n) for n in range(80)],
    "wsi_tile_grids": lambda m: [m.wsi_tile_grids(s, (256, 256), a)
                                 for s, a in (((700, 600), 32),
                                              ((4096, 3000), 128))],
    "wsi_chunk_patch_grids": lambda m: [
        m.wsi_chunk_patch_grids(s, (c, c), (256, 256), (164, 164))
        for s, c in (((700, 600), 1000), ((4096, 3000), 2048))],
    "select_patches_in_chunk": lambda m: [
        m.select_patches_in_chunk(p, c, (256, 256))
        for c_all, p in [m.wsi_chunk_patch_grids((3000, 2500), (1024, 1024),
                                                 (256, 256), (164, 164))]
        for c in c_all],
}


@pytest.mark.parametrize("name", sorted(TILING_CASES))
def test_tiling(name):
    assert_same(TILING_CASES[name](t_tiling), TILING_CASES[name](j_tiling),
                name)


# ------------------------------------------------------- crops and labels

CROP_CASES = {
    "crop_op_nhwc": lambda m, x: m.crop_op(x, (5, 8)),
    "crop_op_nchw": lambda m, x: m.crop_op(x.transpose(0, 3, 1, 2), (7, 2),
                                           "NCHW"),
    "crop_to_shape": lambda m, x: m.crop_to_shape(x, (20, 13)),
    "cropping_center": lambda m, x: m.cropping_center(x[0], (11, 17)),
    "cropping_center_batch": lambda m, x: m.cropping_center(x, (9, 10),
                                                            batch=True),
}


@pytest.mark.parametrize("name", sorted(CROP_CASES))
def test_crops(name):
    x = np.arange(2 * 31 * 27 * 3, dtype=np.float32).reshape(2, 31, 27, 3)
    assert_same(CROP_CASES[name](t_crops, x), CROP_CASES[name](j_crops, x),
                name)


@pytest.mark.parametrize("by_size", [False, True])
def test_remap_label(by_size):
    inst = blobs() * 7 + np.where(blobs(seed=1) > 0, 3, 0)
    assert_same(t_stats.remap_label(inst, by_size),
                j_stats.remap_label(inst, by_size))
    empty = np.zeros((5, 5), np.int32)
    assert_same(t_stats.remap_label(empty), j_stats.remap_label(empty))


CC_CASES = {
    "label_4": lambda m, a: m.label(a > 0, 1),
    "label_8": lambda m, a: m.label(a > 0, 2),
    "remove_small_objects_bool": lambda m, a: m.remove_small_objects(
        a > 0, 40, connectivity=2),
    "remove_small_objects_labels": lambda m, a: m.remove_small_objects(a, 60),
    "remove_small_holes": lambda m, a: m.remove_small_holes(a > 0, 30),
    "ellipse": lambda m, a: [m.ellipse_structuring_element(h, w)
                             for h, w in ((5, 5), (3, 7), (1, 1), (9, 4))],
    "binary_dilation_disk": lambda m, a: m.binary_dilation_disk(a > 0, 3),
}


@pytest.mark.parametrize("name", sorted(CC_CASES))
def test_cc_np(name):
    a = blobs()
    assert_same(CC_CASES[name](t_cc, a), CC_CASES[name](j_cc, a), name)


# ------------------------------------------------ native library and host

def test_native_library_is_the_ports_own():
    lib = t_it._build_lib()
    assert lib is not None, "g++ failed to build csrc/instance_table.cpp"
    path = lib._name
    assert os.path.dirname(path) == os.path.join(REPO, "build",
                                                 "hover_net_tpu_torch")
    assert os.path.basename(path).startswith("instance_table_")


def test_apply_lut():
    inst = blobs()
    lut = np.random.default_rng(3).permutation(inst.max() + 1).astype(
        np.int32)
    assert_same(t_it.apply_lut(inst.copy(), lut),
                j_it.apply_lut(inst.copy(), lut))


@pytest.mark.parametrize("typed", [False, True])
def test_extract_instance_info_and_json(typed, tmp_path):
    """The info dicts of a map with 1-2 pixel specks (which the finalize
    erases and renumbers), then emit_nuc_json of them."""
    inst = t_stats.remap_label(blobs(seed=4))
    inst[0, 0] = inst[40, 87] = inst.max() + 1
    inst[95, 3] = inst.max() + 1
    tp = (np.random.default_rng(5).integers(0, 4, inst.shape)
          .astype(np.int32) if typed else None)
    got = t_host.extract_instance_info(inst, tp, n_types=4)
    want = j_host.extract_instance_info(inst, tp, n_types=4)
    assert_same(got, want)
    assert len(want[1]) > 5

    info = want[1]
    ids = np.array(list(info), np.int64)
    bbox = np.stack([v["bbox"].ravel() for v in info.values()])
    cen = np.stack([v["centroid"] for v in info.values()])
    lens = np.cumsum([0] + [len(v["contour"]) for v in info.values()])
    pts = np.concatenate([v["contour"] for v in info.values()])
    tids = (np.array([v["type"] for v in info.values()], np.int32)
            if typed else None)
    tprob = (np.array([v["type_prob"] for v in info.values()])
             if typed else None)
    args = (ids, bbox, cen, lens, pts, tids, tprob, 40.0)
    payload = t_it.emit_nuc_json(*args)
    assert payload is not None and payload == j_it.emit_nuc_json(*args)
    assert set(json.loads(payload)["nuc"]) == {str(i) for i in ids}


@pytest.mark.parametrize("nr_types", [None, 3])
def test_instance_info_from_tables(nr_types):
    inst = t_stats.remap_label(blobs(seed=6)).astype(np.int32)
    tp = np.random.default_rng(7).integers(0, 3, inst.shape).astype(np.int32)
    tables = t_ppd.instance_tables(torch.from_numpy(inst),
                                   torch.from_numpy(tp), nr_types=nr_types,
                                   with_sums=nr_types is not None)
    tables = {k: v.numpy() for k, v in tables.items()}
    n = int(inst.max())
    assert_same(t_host.instance_info_from_tables(tables, n, nr_types),
                j_host.instance_info_from_tables(tables, n, nr_types))


def test_get_file_handler_npy(tmp_path):
    img = np.random.default_rng(8).integers(0, 255, (300, 260, 3),
                                            dtype=np.uint8)
    path = str(tmp_path / "slide.npy")
    np.save(path, img)
    out = []
    for mod in (t_handler, j_handler):
        h = mod.get_file_handler(path, backend=".npy", base_mag=40.0)
        h.prepare_reading(read_mag=40.0)
        out.append([h.get_dimensions(read_mag=20.0),
                    h.read_region((17, 33), (64, 48)),
                    h.get_full_img(read_mag=10.0), dict(h.metadata)])
    assert_same(*out)
    with pytest.raises(ValueError):
        t_handler.get_file_handler(str(tmp_path / "slide.xyz"))


@pytest.mark.parametrize("native", [True, False])
def test_gen_instance_hv_map(native, monkeypatch):
    """Through the native pass and through the NumPy formulation."""
    inst = blobs((80, 90), 12, seed=9)
    if not native:
        monkeypatch.setattr(t_targets, "hv_targets_native", lambda *a: None)
        monkeypatch.setattr(t_targets, "fragment_labels", lambda *a: None)
        monkeypatch.setattr(j_it, "hv_targets_native", lambda *a: None)
        monkeypatch.setattr(j_it, "fragment_labels", lambda *a: None)
    for crop in ((80, 90), (60, 64)):
        assert_same(t_targets.gen_instance_hv_map(inst, crop),
                    j_targets.gen_instance_hv_map(inst, crop), str(crop))
    assert_same(t_targets.fix_mirror_padding(inst),
                j_targets.fix_mirror_padding(inst))


def test_qupath_and_overlay(tmp_path):
    inst = t_stats.remap_label(blobs(seed=10))
    tp = (inst % 3).astype(np.int32)
    _, info = j_host.extract_instance_info(inst, tp, n_types=3)
    types = {0: ("a", (1, 2, 3)), 1: ("b", (200, 0, 9)), 2: ("c", (7, 7, 7))}
    pos = np.array([v["centroid"] for v in info.values()])
    typ = np.array([v["type"] for v in info.values()])
    texts = []
    for mod in (t_qupath, j_qupath):
        path = tmp_path / f"{mod.__name__}.tsv"
        mod.to_qupath(str(path), pos, typ, types)
        texts.append(path.read_text())
    assert texts[0] == texts[1] and texts[0].count("\n") == len(info) + 1
    img = np.full(inst.shape + (3,), 200, np.uint8)
    overlays = []
    for mod in (t_viz, j_viz):
        random.seed(11)
        overlays.append(mod.overlay_instances(img, info, draw_dot=True))
    overlays.append(t_viz.overlay_instances(img, info, type_colour=types))
    overlays.append(j_viz.overlay_instances(img, info, type_colour=types))
    assert_same(overlays[0], overlays[1])
    assert_same(overlays[2], overlays[3])
    assert not np.array_equal(overlays[0], img)
