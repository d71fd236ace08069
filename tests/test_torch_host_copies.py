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
    "center_pad_to_shape": lambda m, x: m.center_pad_to_shape(
        x[0], (40, 34), cval=7),
    "center_pad_to_shape_2d": lambda m, x: m.center_pad_to_shape(
        x[1, ..., 0], (33, 30)),
    "get_bounding_box": lambda m, x: m.get_bounding_box(
        (x[0, ..., 0] % 97 > 90) & (np.arange(27) > 3)[None]),
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
    "binary_fill_holes": lambda m, a: m.binary_fill_holes(a % 3 == 1),
    "binary_opening": lambda m, a: m.binary_opening(
        a > 0, m.ellipse_structuring_element(5, 5)),
    "watershed_4": lambda m, a: m.watershed(
        ws_energy(a.shape), np.where(a % 2 == 1, a, 0), mask=a > 0),
    "watershed_8_nomask": lambda m, a: m.watershed(
        ws_energy(a.shape), np.where(a % 4 == 1, a, 0), connectivity=2),
}


def ws_energy(shape):
    """A float32 landscape with plateaus (ties in the flood order)."""
    idx = np.arange(shape[0] * shape[1]).reshape(shape)
    return np.round(np.sin(idx * 0.37) * 4).astype(np.float32)


@pytest.mark.parametrize("name", sorted(CC_CASES))
def test_cc_np(name):
    a = blobs()
    assert_same(CC_CASES[name](t_cc, a), CC_CASES[name](j_cc, a), name)


# ------------------------------------------------ native library and host

def oracle_pred(seed, typed):
    """[160, 150, 3 (+1)] map of synthetic nuclei plus noise: (type,) np
    prob, hv x, hv y."""
    from test_torch_kernels import nuclei_pred

    rng = np.random.default_rng(seed)
    pred = nuclei_pred((160, 150), rng, 30, edge_touching=True)
    pred += rng.normal(0, 0.05, pred.shape).astype(np.float32)
    if typed:
        tp = rng.integers(0, 5, pred.shape[:2]).astype(np.float32)
        pred = np.dstack([tp, pred])
    return pred


def test_proc_np_hv():
    pred = oracle_pred(20, typed=False)
    want = j_host.proc_np_hv(pred)
    assert_same(t_host.proc_np_hv(pred), want)
    assert want.max() >= 15
    x = pred[..., 1] * 3 + 1
    assert_same(t_host._minmax_norm(x), j_host._minmax_norm(x))


@pytest.mark.parametrize("typed,centroids", [(False, False), (False, True),
                                             (True, True)])
def test_process(typed, centroids):
    pred = oracle_pred(21 + typed, typed)
    nr_types = 5 if typed else None
    want = j_host.process(pred, nr_types, return_centroids=centroids)
    assert_same(t_host.process(pred, nr_types, return_centroids=centroids),
                want)
    assert want[0].max() >= 15


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


@pytest.mark.parametrize("typed", [False, True])
def test_assemble_instance_info_equals_the_loop(typed):
    """The port's whole-table dict assembly against the JAX package's
    per-instance loop: absent ids, contours under 3 points, vote ties,
    background majorities with and without a second vote, int32 and int64
    tables; the same dict, key order and dtypes included."""
    rng = np.random.default_rng(11)
    n, n_types = 300, 5
    size = rng.integers(0, 50, n)
    size[::17] = 0
    hist = rng.integers(0, 4, (n, n_types))
    hist[::5, 1:] = 0            # background alone
    hist[1::5, 0] = 9            # background ahead of a second vote
    hist[2::5, 1:3] = 7          # a tie for the lead
    lo = rng.integers(0, 100, (n, 2))
    bbox = np.stack([lo[:, 0], lo[:, 0] + 5, lo[:, 1], lo[:, 1] + 4], 1)
    centroid = rng.random((n, 2)) * 100
    contours = [rng.integers(0, 100, (int(rng.integers(1, 8)), 2))
                .astype(np.int32) for _ in range(n)]
    for dtype in (np.int32, np.int64):
        args = (bbox.astype(dtype), centroid, size.astype(dtype),
                hist.astype(dtype) if typed else None, contours, typed)
        got = t_host.assemble_instance_info(*args)
        want = j_host.assemble_instance_info(*args)
        assert list(got[0]) == list(want[0]) and len(want[1]) > 10
        assert all(list(g) == list(w)
                   for g, w in zip(got[0].values(), want[0].values()))
        assert_same(got, want)


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


@pytest.mark.parametrize("typed", [False, True])
def test_overlay_instances_map(typed):
    inst = t_stats.remap_label(blobs(seed=12))
    tp = (inst % 3).astype(np.int32) if typed else None
    colours = {0: (1, 2, 3), 1: (200, 0, 9), 2: (7, 7, 7)} if typed else None
    img = np.full(inst.shape + (3,), 200, np.uint8)
    overlays = []
    for mod in (t_viz, j_viz):
        random.seed(13)
        overlays.append(mod.overlay_instances_map(img, inst, tp, colours))
    assert_same(overlays[0], overlays[1])
    assert not np.array_equal(overlays[0], img)


# --------------------------------------------------------------- training

from hover_net_tpu import config as j_config  # noqa: E402
from hover_net_tpu.cli import extract_patches as j_extract  # noqa: E402
from hover_net_tpu.data import augs as j_augs  # noqa: E402
from hover_net_tpu.data import datasets as j_datasets  # noqa: E402
from hover_net_tpu.data import patch_extract as j_patch  # noqa: E402
from hover_net_tpu.data import train_pipeline as j_pipe  # noqa: E402
from hover_net_tpu.train import callbacks as j_cb  # noqa: E402
from hover_net_tpu.train import engine as j_engine  # noqa: E402
from hover_net_tpu.train import validation as j_valid  # noqa: E402
from hover_net_tpu.utils import misc as j_misc  # noqa: E402
from hover_net_tpu_torch import config as t_config  # noqa: E402
from hover_net_tpu_torch.cli import extract_patches as t_extract  # noqa: E402
from hover_net_tpu_torch.data import augs as t_augs  # noqa: E402
from hover_net_tpu_torch.data import datasets as t_datasets  # noqa: E402
from hover_net_tpu_torch.data import patch_extract as t_patch  # noqa: E402
from hover_net_tpu_torch.data import train_pipeline as t_pipe  # noqa: E402
from hover_net_tpu_torch.train import callbacks as t_cb  # noqa: E402
from hover_net_tpu_torch.train import engine as t_engine  # noqa: E402
from hover_net_tpu_torch.train import validation as t_valid  # noqa: E402
from hover_net_tpu_torch.utils import misc as t_misc  # noqa: E402


def nuclei_patch(size=140, seed=0, typed=True):
    """[size, size, 3 + 1 (+1)] int32 patch: RGB, instances (, types)."""
    rng = np.random.default_rng(seed)
    inst = blobs((size, size), 10, seed=seed)
    img = rng.integers(0, 256, (size, size, 3))
    chans = [img, inst[..., None]]
    if typed:
        chans.append(np.where(inst > 0, inst % 4 + 1, 0)[..., None])
    return np.concatenate(chans, -1).astype(np.int32)


@pytest.mark.parametrize("crop", [(80, 90), (40, 36), (4, 4)])
def test_gen_targets(crop):
    inst = blobs((80, 90), 12, seed=12)
    assert_same(t_targets.gen_targets(inst, crop),
                j_targets.gen_targets(inst, crop), str(crop))


@pytest.mark.parametrize("vmin,vmax", [(0, 1), (-1, 1), (0, 5)])
def test_colorize_jet_table_is_matplotlibs(vmin, vmax):
    """The port's explicit jet table against matplotlib's colormap (the
    JAX original calls it), with NaN, out-of-range and integer maps."""
    rng = np.random.default_rng(13)
    maps = [rng.uniform(-2, 6, (40, 50)).astype(np.float32),
            np.linspace(-1.5, 5.5, 30001).reshape(1, -1),
            rng.integers(0, 6, (30, 30)),
            np.array([[np.nan, 0.5], [1.0, 0.0]], np.float32)]
    for i, m in enumerate(maps):
        assert_same(t_viz.colorize(m, vmin, vmax),
                    j_viz.colorize(m, vmin, vmax), str(i))


@pytest.mark.parametrize("typed", [False, True])
def test_viz_train_panel_and_validation(typed):
    rng = np.random.default_rng(14)
    n, nr_types = 3, 5 if typed else None
    raw = {"imgs": rng.integers(0, 256, (n, 12, 12, 3)).astype(np.float32),
           "true_np": rng.integers(0, 2, (n, 8, 8)),
           "prob_np": rng.uniform(0, 1, (n, 8, 8)).astype(np.float32),
           "true_hv": rng.uniform(-1, 1, (n, 8, 8, 2)).astype(np.float32),
           "pred_hv": rng.uniform(-1, 1, (n, 8, 8, 2)).astype(np.float32)}
    if typed:
        raw["true_tp"] = rng.integers(0, 5, (n, 8, 8))
        raw["pred_tp"] = rng.integers(0, 5, (n, 8, 8)).astype(np.float32)
    outs = []
    for mod in (t_valid, j_valid):
        np.random.seed(15)  # the panel's sample draw
        outs.append(mod.proc_valid_step_output(raw, nr_types, viz_samples=2))
    assert_same(outs[0], outs[1])
    step_raw = {"img": raw["imgs"][:2],
                "np": (raw["true_np"][:2], raw["prob_np"][:2]),
                "hv": (raw["true_hv"][:2], raw["pred_hv"][:2])}
    if typed:
        step_raw["tp"] = (raw["true_tp"][:2], raw["pred_tp"][:2])
    assert_same(t_valid.viz_train_step_output(step_raw, nr_types),
                j_valid.viz_train_step_output(step_raw, nr_types))


def test_gen_figure():
    import matplotlib

    matplotlib.use("Agg")
    imgs = [np.eye(4) * i for i in range(5)]
    titles = [f"t{i}" for i in range(5)]
    figs = [mod.gen_figure(imgs, titles) for mod in (t_viz, j_viz)]
    for fig in figs:
        assert len(fig.axes) == 6
    assert ([a.get_title() for a in figs[0].axes]
            == [a.get_title() for a in figs[1].axes])


@pytest.mark.parametrize("mode", ["train", "valid"])
@pytest.mark.parametrize("typed", [False, True])
def test_train_augmentor(mode, typed):
    patch = nuclei_patch(seed=16, typed=typed)
    img, ann = patch[..., :3].astype(np.uint8), patch[..., 3:]
    outs = []
    for mod in (t_augs, j_augs):
        aug = mod.TrainAugmentor((96, 96), mode=mode, seed=17)
        outs.append([aug(img, ann) for _ in range(4)])
        aug.reseed(18)
        outs[-1].append(aug(img, ann))
    assert_same(outs[0], outs[1])


@pytest.mark.parametrize("name,typed", [("consep", True), ("consep", False),
                                        ("kumar", False), ("cpm17", False)])
def test_datasets_and_patch_extraction(name, typed, tmp_path):
    """The loaders on a written .png/.mat pair, the patch extractor in
    both modes, and the extraction CLI's files."""
    import cv2
    import scipy.io as sio

    rng = np.random.default_rng(19)
    img = rng.integers(0, 256, (300, 340, 3), np.uint8)
    inst = blobs((300, 340), 20, seed=20)
    for d in ("Images", "Labels"):
        (tmp_path / d).mkdir()
    cv2.imwrite(str(tmp_path / "Images" / "a.png"), img)
    sio.savemat(str(tmp_path / "Labels" / "a.mat"),
                {"inst_map": inst, "type_map": (inst % 8).astype(np.int32)})
    loaded = []
    for mod in (t_datasets, j_datasets):
        parser = mod.get_dataset(name)
        loaded.append((parser.load_img(str(tmp_path / "Images" / "a.png")),
                       parser.load_ann(str(tmp_path / "Labels" / "a.mat"),
                                       typed)))
    assert_same(loaded[0], loaded[1])
    for mode in ("mirror", "valid"):
        assert_same(
            t_patch.extract_patches(*loaded[0], (96, 96), (40, 40), mode),
            j_patch.extract_patches(*loaded[1], (96, 96), (40, 40), mode),
            mode)
    for mod in (t_datasets, j_datasets):
        with pytest.raises(ValueError):
            mod.get_dataset("nope")

    outs = {}
    for label, mod in (("t", t_extract), ("j", j_extract)):
        out = tmp_path / label
        mod.main(["--dataset", name, "--img_dir", str(tmp_path / "Images"),
                  "--ann_dir", str(tmp_path / "Labels"), "--out_dir",
                  str(out), "--win_size", "120", "--step_size", "60"]
                 + (["--with_type"] if typed else []))
        outs[label] = {f: np.load(out / f) for f in sorted(os.listdir(out))}
    assert len(outs["t"]) > 4
    assert_same(outs["t"], outs["j"])


@pytest.mark.parametrize("mode,typed", [("train", True), ("valid", True),
                                        ("train", False)])
def test_train_loader_epoch_matches(mode, typed, tmp_path):
    """At num_workers=0 the port's loader gives the JAX loader's batches,
    two epochs over, bit for bit."""
    for i in range(5):
        np.save(tmp_path / f"p{i}.npy", nuclei_patch(seed=30 + i, typed=typed))
    epochs = []
    for mod in (t_pipe, j_pipe):
        loader = mod.TrainLoader(
            mod.PatchDataset([str(tmp_path)]), batch_size=2,
            input_shape=(96, 96), mask_shape=(40, 40), mode=mode,
            with_type=typed, num_workers=0, seed=21)
        assert loader.steps_per_epoch() == (2 if mode == "train" else 3)
        epochs.append([list(loader) for _ in range(2)])
        loader.close()
    assert_same(epochs[0], epochs[1])
    assert len(epochs[0][0]) == (2 if mode == "train" else 3)


def test_worker_pool_gives_the_in_process_batches(tmp_path):
    """The port's one departure from the copied loader: its workers are
    forks of a `forkserver` that has imported the pipeline. In valid mode
    (no random augmentation) two pools, one after the other as the
    trainer starts them, give the batches of `num_workers=0`."""
    for i in range(5):
        np.save(tmp_path / f"p{i}.npy", nuclei_patch(seed=50 + i))

    def epoch(workers):
        loader = t_pipe.TrainLoader(
            t_pipe.PatchDataset([str(tmp_path)]), batch_size=2,
            input_shape=(96, 96), mask_shape=(40, 40), mode="valid",
            with_type=True, num_workers=workers, seed=23)
        try:
            if workers:
                assert (loader._pool._mp_context.get_start_method()
                        == "forkserver")
            return list(loader)
        finally:
            loader.close()

    want = epoch(0)
    for _ in range(2):
        assert_same(epoch(2), want)


def test_prefetch_loader_on_the_cpu(tmp_path):
    """The CPU path of the prefetcher hands out the loader's batches as
    tensors, and times each wait."""
    for i in range(4):
        np.save(tmp_path / f"p{i}.npy", nuclei_patch(seed=40 + i))
    def loader():  # a fresh one reseeds the augmentation
        return t_pipe.TrainLoader(
            t_pipe.PatchDataset([str(tmp_path)]), batch_size=2,
            input_shape=(96, 96), mask_shape=(40, 40), with_type=True,
            num_workers=0, seed=22)

    want = list(loader())
    pre = t_pipe.PrefetchLoader(loader(), "cpu")
    got = list(pre)
    assert len(pre) == 2 and len(pre.wait_s) == 2
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            assert isinstance(g[k], torch.Tensor)
            np.testing.assert_array_equal(g[k].numpy(), w[k])


class _StubInfo:
    """The parts of RunInfo the callbacks read."""

    def __init__(self, suffix):
        self.suffix = suffix
        self.saved = []
        self.lr_schedule = lambda step: 1e-3 if step < 3 else 1e-4
        self.train_state = type("S", (), {"step": 0})()
        self.last_grad_norm = None

    def save_checkpoint(self, path):
        assert path.endswith(self.suffix)
        self.saved.append(os.path.basename(path)[:-len(self.suffix)])


def run_stub_training(engine, cb, suffix, log_dir):
    """Two epochs of a stub train engine chaining a stub valid engine,
    with every callback of the manager wired as it wires them."""
    info = _StubInfo(suffix)
    rng = np.random.default_rng(23)
    train_batches = [{"x": float(v)} for v in rng.uniform(0, 1, 3)]
    valid_batches = [{"x": float(v)} for v in rng.uniform(0, 1, 2)]

    def train_step(batch, state):
        info.train_state.step += 1
        info.last_grad_norm = batch["x"] * 10
        return {"EMA": {"loss": batch["x"], "aux": 2 * batch["x"]},
                "raw": {"x": [batch["x"]]}}

    def valid_step(batch, state):
        return {"raw": {"x": [batch["x"]], "y": [1 - batch["x"]]}}

    with open(os.path.join(log_dir, "stats.json"), "w") as f:
        json.dump({}, f)
    log_info = {"json_file": os.path.join(log_dir, "stats.json")}
    train = engine.RunEngine("train", train_batches, train_step, info,
                             log_info)
    valid = engine.RunEngine("valid", valid_batches, valid_step, info,
                             log_info)
    trigger = cb.TriggerEngine("valid")
    trigger.triggered_engine = valid
    for c in (cb.ScalarMovingAverage(), cb.LoggingGradient()):
        train.add_event_handler(engine.Events.STEP_COMPLETED, c)
    for c in (cb.TrackLr(), cb.PeriodicSaver(),
              cb.VisualizeOutput(lambda raw: np.asarray(raw["x"])),
              cb.LoggingEpochOutput(), trigger, cb.ScheduleLr()):
        train.add_event_handler(engine.Events.EPOCH_COMPLETED, c)
    valid.add_event_handler(engine.Events.STEP_COMPLETED,
                            cb.AccumulateRawOutput())
    for c in (cb.ProcessAccumulatedRawOutput(lambda acc: {
                  "scalar": {"np_dice": float(np.mean(acc["x"]))},
                  "image": {}}),
              cb.LoggingEpochOutput(),
              cb.ConditionalSaver("valid-np_dice", comparator=">=")):
        valid.add_event_handler(engine.Events.EPOCH_COMPLETED, c)
    for e in (train, valid):
        e.state.logging = True
        e.state.log_dir = log_dir
    state = train.run(2)
    with open(log_info["json_file"]) as f:
        stats = json.load(f)
    return (stats, info.saved, state.curr_epoch, state.curr_global_step,
            dict(state.tracked_step_output["scalar"]))


def test_engine_and_callbacks_on_a_stub_step(tmp_path):
    outs = []
    for label, engine, cb, suffix in (("t", t_engine, t_cb, ".tar"),
                                      ("j", j_engine, j_cb, ".msgpack")):
        d = tmp_path / label
        d.mkdir()
        outs.append(run_stub_training(engine, cb, suffix, str(d)))
    assert_same(outs[0], outs[1])
    stats, saved = outs[0][0], outs[0][1]
    assert set(stats) == {"1", "2"} and "valid-np_dice" in stats["2"]
    assert saved[:2] == ["net_epoch=1", "net_best=[valid-np_dice]"]
    assert [e.value for e in t_engine.Events] == \
        [e.value for e in j_engine.Events]


def test_config_and_misc(tmp_path):
    import dataclasses

    assert t_config.MODE_SHAPES == j_config.MODE_SHAPES
    for kw in ({}, {"model_mode": "fast", "pretrained": "x.npz"},
               {"type_classification": False, "shape_override": {
                   "aug": (140, 140), "act": (96, 96), "out": (4, 4)}}):
        t_cfg, j_cfg = t_config.TrainConfig(**kw), j_config.TrainConfig(**kw)
        assert dataclasses.asdict(t_cfg) == dataclasses.asdict(j_cfg), kw
        assert (t_cfg.act_shape, t_cfg.out_shape) == (j_cfg.act_shape,
                                                      j_cfg.out_shape)
    phases = t_config.default_phases("fast", "w.npz")
    assert [dataclasses.asdict(p) for p in phases] == [
        dataclasses.asdict(p) for p in j_config.default_phases("fast",
                                                               "w.npz")]
    assert [p.batch_size["train"] for p in phases] == [16, 4]

    rng = np.random.default_rng(24)
    m = rng.uniform(0, 3, (20, 20))
    assert_same(t_misc.normalize_to_uint8(m), j_misc.normalize_to_uint8(m))
    rgb = rng.integers(0, 256, (10, 12, 3), np.uint8)
    stain = rng.uniform(0, 1, (3, 3))
    assert_same(t_misc.color_deconvolution(rgb, stain),
                j_misc.color_deconvolution(rgb, stain))
    draws = []
    for mod in (t_misc, j_misc):
        assert mod.check_manual_seed(25) == 25
        draws.append((random.random(), np.random.rand()))
        d = tmp_path / mod.__name__
        mod.mkdir(str(d / "x"))
        (d / "x" / "f").write_text("")
        mod.rm_n_mkdir(str(d / "x"))
        assert os.listdir(d / "x") == []
    assert draws[0] == draws[1]
