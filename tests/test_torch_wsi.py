"""The port's WSI manager (hover_net_tpu_torch/infer/wsi.py) against the
JAX package's (hover_net_tpu/infer/wsi.py), on the CPU.

On the CPU the JAX manager post-processes with the exact scan path and
the port with the plain version of K1, which gives the same labels. So
given the same stitched prediction map, the 3-phase post-processing of
the two managers must give the same instance map and the same
per-nucleus info, element for element, in both buffer modes (device-
resident and mmap), untyped and typed. The managers are built with
`__new__`, as tests/test_wsi.py builds them.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hover_net_tpu.data.tiling import wsi_chunk_patch_grids, wsi_tile_grids
from hover_net_tpu.infer.wsi import WSIInferManager as JaxWSI
from hover_net_tpu.infer.wsi_handler import get_file_handler
from hover_net_tpu.ops.targets import gen_instance_hv_map
from hover_net_tpu_torch.infer import wsi as port_wsi
from hover_net_tpu_torch.infer.wsi import WSIInferManager as PortWSI

from test_wsi import _paint_nuclei

# the suite runs in several worker processes on one host: torch's default
# of one CPU thread per core in each of them oversubscribes the cores
# many times over and slows these tests by an order of magnitude
torch.set_num_threads(1)

SHAPE = (700, 600)
WIDTH = 8


def pred_map(shape, seed, n, nr_types=None):
    """float16 (tp,) np, hv_x, hv_y map of synthetic nuclei."""
    rng = np.random.default_rng(seed)
    inst = _paint_nuclei(shape, rng, n)
    hv = gen_instance_hv_map(inst, shape)
    parts = [(inst > 0).astype(np.float32), hv[..., 0], hv[..., 1]]
    if nr_types:
        parts.insert(0, ((inst % nr_types) * (inst > 0)).astype(np.float32))
    return np.dstack(parts).astype(np.float16)


def manager(cls, pred, tmp_path, tag, dev_mode, nr_types=None, workers=0):
    shape = pred.shape[:2]
    mgr = cls.__new__(cls)
    mgr.nr_types = nr_types
    mgr.tile_shape = 256
    mgr.ambiguous_size = 32
    mgr.wsi_proc_shape = np.array(shape)
    mgr.wsi_mask = np.ones((shape[0] // 10, shape[1] // 10), np.uint8)
    mgr.wsi_inst_info = {}
    mgr.wsi_inst_map = np.zeros(shape, np.int32)
    mgr._fwd_fns = {}
    if cls is PortWSI:
        mgr._slide_times = {}
    if workers:
        mgr.finalize_workers = workers
    if dev_mode:
        bh = -(-(shape[0] + 164) // 256) * 256
        bw = -(-(shape[1] + 164) // 256) * 256
        buf = np.full((bh, bw, pred.shape[-1]), 7.0, np.float16)
        buf[:shape[0], :shape[1]] = pred  # slack garbage must not leak
        mgr._pred_dev_mode = True
        mgr._pred_dev = (jnp.asarray(buf) if cls is JaxWSI
                         else torch.from_numpy(buf))
        if cls is PortWSI:
            # beside a resident pred map the port keeps the instance map
            # on its device, as `process_single_file` allocates it
            mgr.wsi_inst_map = torch.zeros(shape, dtype=torch.int32)
    else:
        mgr._pred_map_path = str(tmp_path / f"{tag}.npy")
        np.save(mgr._pred_map_path, pred)
    return mgr


def three_phases(mgr):
    tg, tb, tc = wsi_tile_grids(mgr.wsi_proc_shape,
                                np.array([mgr.tile_shape] * 2),
                                mgr.ambiguous_size)
    mgr._dispatch_post_processing(tg, mgr._cb_normal_tile, "p1")
    mgr._dispatch_post_processing(tb, mgr._cb_fixing_tile, "p2")
    mgr._dispatch_post_processing(tc, mgr._cb_fixing_tile, "p3")
    return np.array(mgr.wsi_inst_map), mgr.wsi_inst_info


def extraction_counts(mgr):
    """(windows whose dict came from the device's tables, windows
    extracted from a dense map, windows the callbacks took) of the
    manager's phases."""
    t = mgr._slide_times
    return (t.get("pp_extract_windows_tables", 0),
            t.get("pp_extract_windows_dense", 0),
            t.get("pp_callback_windows_dev", 0)
            + t.get("pp_callback_windows_host", 0))


def assert_same(got, want):
    (map_g, info_g), (map_w, info_w) = got, want
    np.testing.assert_array_equal(map_g, map_w)
    assert list(info_g) == list(info_w)
    for k, w in info_w.items():
        g = info_g[k]
        assert set(g) == set(w)
        for field in ("bbox", "centroid", "contour"):
            np.testing.assert_array_equal(g[field], w[field], err_msg=field)
        assert g["type"] == w["type"] and g["type_prob"] == w["type_prob"]


@pytest.mark.parametrize("dev_mode", [True, False], ids=["device", "mmap"])
@pytest.mark.parametrize("nr_types", [None, 4], ids=["untyped", "typed"])
def test_three_phases_equal_jax(tmp_path, dev_mode, nr_types):
    pred = pred_map(SHAPE, 5, 100, nr_types)
    want = three_phases(manager(JaxWSI, pred, tmp_path, "jax", dev_mode,
                                nr_types))
    port = manager(PortWSI, pred, tmp_path, "port", dev_mode, nr_types)
    got = three_phases(port)
    assert len(want[1]) > 50
    assert_same(got, want)
    # the info dict matches the final map
    assert set(np.unique(got[0]).tolist()) - {0} == set(got[1])
    # every window's dict from the device's tables beside a resident pred
    # map, from the dense map on the mmap path
    tables, dense, windows = extraction_counts(port)
    assert windows > 10
    assert (tables, dense) == ((windows, 0) if dev_mode else (0, windows))


def test_three_phases_equal_jax_at_smoke_density(tmp_path):
    """The density of the 4096^2 WSI map of chip_smoke.py (1500 discs of
    radius 5-10 per 4096^2) on a 1024^2 map, with its 128-pixel
    ambiguous strips and 2 x 2 post-proc tiles: the port's 3 phases
    equal the JAX manager's. On this map both stitch one instance fewer
    than the single-shot solve of the whole map: the fixing rule of
    phases 2-3 drops a re-predicted nucleus that touches a kept boundary
    straddler. That gap is the algorithm's, not the port's."""
    from hover_net_tpu_torch.ops.post_proc_device import proc_np_hv_batch

    side = 1024
    inst = _paint_nuclei((side, side), np.random.default_rng(1),
                         round(1500 * side**2 / 4096**2), r_range=(5, 11))
    hv = gen_instance_hv_map(inst, inst.shape)
    pred = np.dstack([(inst > 0).astype(np.float32), hv[..., 0],
                      hv[..., 1]]).astype(np.float16)
    got, want = (
        manager(cls, pred, tmp_path, tag, True) for cls, tag in
        ((PortWSI, "port"), (JaxWSI, "jax")))
    for mgr in (got, want):
        mgr.tile_shape, mgr.ambiguous_size = 512, 128
    port = got
    got, want = three_phases(got), three_phases(want)
    assert_same(got, want)
    tables, dense, windows = extraction_counts(port)
    assert windows > 4 and (tables, dense) == (windows, 0)
    whole = proc_np_hv_batch(torch.from_numpy(pred.astype(np.float32))[None])
    n_whole = len(torch.unique(whole)) - 1
    assert n_whole > 80
    assert len(got[1]) == n_whole - 1


def test_skips_degenerate_boxes(tmp_path):
    """512 x 512, an exact tile multiple: the grid carries zero-area
    trailing boxes, which the dispatch skips."""
    pred = pred_map((512, 512), 5, 60)
    mgr = manager(PortWSI, pred, tmp_path, "p", False)
    tg, _, _ = wsi_tile_grids(np.array((512, 512)), np.array([256, 256]), 32)
    assert any((br - tl).min() <= 0 for tl, br in tg)
    inst_map, info = three_phases(mgr)
    assert inst_map.max() > 0
    assert set(np.unique(inst_map).tolist()) - {0} == set(info)


def test_finalize_pool_matches_sequential(tmp_path):
    pred = pred_map(SHAPE, 7, 150)
    one = three_phases(manager(PortWSI, pred, tmp_path, "a", True, workers=1))
    three = three_phases(manager(PortWSI, pred, tmp_path, "b", True,
                                 workers=3))
    assert_same(three, one)


# ------------------------------------------- the instance map on the device

def count_calls(monkeypatch, name):
    """Wrap `port_wsi.<name>`; returns the list its calls append to."""
    calls = []
    fn = getattr(port_wsi, name)

    def counted(*args, **kwargs):
        out = fn(*args, **kwargs)
        calls.append(out)
        return out

    monkeypatch.setattr(port_wsi, name, counted)
    return calls


def three_phases_counted(mgr, inst_map):
    """`three_phases` with `inst_map` preset and the slide's timings on:
    (map, info, the callbacks' counter keys)."""
    mgr.wsi_inst_map = inst_map
    mgr._slide_times = {}
    got = three_phases(mgr)
    return got, {k: v for k, v in mgr._slide_times.items()
                 if k.startswith("pp_callback_windows")}


@pytest.mark.parametrize("dev_mode", [True, False], ids=["device", "mmap"])
@pytest.mark.parametrize("nr_types", [None, 4], ids=["untyped", "typed"])
def test_three_phases_torch_map_equals_numpy_map(tmp_path, monkeypatch,
                                                 dev_mode, nr_types):
    """The callbacks on a torch.int32 instance map (as `process_single_file`
    allocates it beside a resident pred map) against the same run on a
    numpy map: the same map and the same dict, id for id. With a resident
    pred map the torch map's callbacks take the tail's labels renumbered
    on the device (`remap_labels_u16`, once a window); every callback
    counts as `_dev` on the torch map and as `_host` on the numpy one."""
    pred = pred_map(SHAPE, 5, 100, nr_types)
    shape = pred.shape[:2]
    renumbered = count_calls(monkeypatch, "remap_labels_u16")
    want, host_count = three_phases_counted(
        manager(PortWSI, pred, tmp_path, "np", dev_mode, nr_types),
        np.zeros(shape, np.int32))
    assert not renumbered
    got, dev_count = three_phases_counted(
        manager(PortWSI, pred, tmp_path, "torch", dev_mode, nr_types),
        torch.zeros(shape, dtype=torch.int32))
    assert len(want[1]) > 50
    assert_same(got, want)
    n = host_count["pp_callback_windows_host"]
    assert host_count == {"pp_callback_windows_host": n} and n > 10
    assert dev_count == {"pp_callback_windows_dev": n}
    assert len(renumbered) == (n if dev_mode else 0)


def test_device_labels_apply_the_extractions_dropped_ids(tmp_path,
                                                         monkeypatch):
    """Windows whose labels hold one-pixel instances, which the extraction
    drops (a contour of fewer than 3 points) and renumbers the rest: on
    the device path the callbacks take the dict's ids through the
    extraction's lookup table, and the map and dict equal the host
    path's."""
    pred = pred_map(SHAPE, 9, 90, 4)
    real = PortWSI._post_proc

    def with_dots(self, seg, valid):
        inst, nlab = real(self, seg, valid)
        lab = inst.to(torch.int32)
        for b in range(lab.shape[0]):
            free = (lab[b] == 0) & valid[b]
            ys, xs = torch.nonzero(free, as_tuple=True)
            pick = torch.arange(0, len(ys), 997)[:40]
            lab[b, ys[pick], xs[pick]] = (int(nlab[b]) + 1
                                          + torch.arange(len(pick),
                                                         dtype=torch.int32))
        return lab.to(torch.uint16), nlab + 40

    monkeypatch.setattr(PortWSI, "_post_proc", with_dots)
    luts = count_calls(monkeypatch, "instance_info_from_tables")
    want, _ = three_phases_counted(
        manager(PortWSI, pred, tmp_path, "np", True, 4),
        np.zeros(SHAPE, np.int32))
    got, _ = three_phases_counted(
        manager(PortWSI, pred, tmp_path, "torch", True, 4),
        torch.zeros(SHAPE, dtype=torch.int32))
    assert sum(lut is not None for _, lut in luts) > 10
    assert_same(got, want)
    assert set(np.unique(got[0]).tolist()) - {0} == set(got[1])


@pytest.mark.parametrize("caps", [(4, 1 << 14), (4096, 300)],
                         ids=["stat_cap", "coo_cap"])
def test_window_tables_overflow_takes_the_dense_extraction(
        tmp_path, monkeypatch, caps):
    """Window tables too small for some windows (ids past `stat_cap`, or
    boundary pixels past `coo_cap`): those windows pull their crop and
    take the dense extraction, the others keep their tables, and the map
    and dict equal the JAX manager's."""
    pred = pred_map(SHAPE, 5, 100, 4)
    monkeypatch.setattr(port_wsi, "window_caps", lambda area: caps)
    want = three_phases(manager(JaxWSI, pred, tmp_path, "jax", True, 4))
    port = manager(PortWSI, pred, tmp_path, "port", True, 4)
    got = three_phases(port)
    assert_same(got, want)
    tables, dense, windows = extraction_counts(port)
    assert tables > 0 and dense > 0 and tables + dense == windows


def border_case():
    """A fixing window (rows 10:40, cols 20:60 of a 50 x 80 map) over an
    old map holding: id 3 straddling its top border, id 5 inside it, id 7
    outside it, id 8 on its left column; and new labels holding id 1 over
    the straddler's inner part, id 2 clear of every old nucleus, id 3
    over the dropped interior nucleus, id 4 over part of id 8."""
    old = np.zeros((50, 80), np.int32)
    old[5:15, 30:36] = 3
    old[20:26, 40:46] = 5
    old[2:6, 70:76] = 7
    old[25:30, 18:22] = 8
    new = np.zeros((30, 40), np.int32)
    new[3:7, 9:17] = 1  # the straddler covers rows 10:15 -> window 0:5
    new[20:25, 30:36] = 2
    new[9:17, 19:27] = 3
    new[15:21, 0:6] = 4  # id 8 covers window cols 0:2 of rows 15:20
    info_old = {k: {"bbox": np.zeros((2, 2), np.int64),
                    "contour": np.zeros((4, 2), np.int64),
                    "centroid": np.zeros(2), "type": None,
                    "type_prob": None} for k in (3, 5, 7, 8)}
    return old, new, info_old


def run_fixing(cls, inst_map, new, info_old, as_tensor=False):
    import copy

    mgr = cls.__new__(cls)
    mgr.wsi_inst_map = inst_map
    mgr.wsi_inst_info = copy.deepcopy(info_old)
    info_new = {k: {"bbox": np.array([[k, k], [k + 1, k + 1]]),
                    "contour": np.full((4, 2), k), "centroid":
                    np.array([k, k], np.float64), "type": None,
                    "type_prob": None} for k in (1, 2, 3, 4)}
    pred = torch.from_numpy(new) if as_tensor else new
    mgr._cb_fixing_tile(pred, info_new, np.array([10, 20]),
                        np.array([40, 60]))
    return np.array(mgr.wsi_inst_map), mgr.wsi_inst_info


@pytest.mark.parametrize("kind", ["torch_map", "numpy_map"])
def test_fixing_window_with_nuclei_on_its_border(kind):
    """The fixing callback on a window whose old map has nuclei on its
    border: the straddlers (3 across the top row, 8 on the left column)
    stay, the interior nucleus (5) goes from the map and the dict, the
    nucleus outside (7) is untouched; of the new labels those overlapping
    a kept straddler (1 and 4) are dropped, and the others (2, and 3 over
    the dropped interior) are installed above the old maximum id. The
    port on a torch map (labels as a tensor) and on a numpy map equals
    the JAX manager's numpy callback."""
    old, new, info_old = border_case()
    want_map, want_info = run_fixing(JaxWSI, old.copy(), new, info_old)
    if kind == "torch_map":
        got = run_fixing(PortWSI, torch.from_numpy(old.copy()), new,
                         info_old, as_tensor=True)
    else:
        got = run_fixing(PortWSI, old.copy(), new, info_old)
    assert_same(got, (want_map, want_info))
    assert list(want_info) == [3, 7, 8, 10, 11]
    assert (want_map == 3).sum() == (old == 3).sum()
    assert not (want_map == 5).any() and (want_map == 7).sum() == 24
    assert (want_map[10:40, 20:60] == 10).sum() == (new == 2).sum()
    assert (want_map[10:40, 20:60] == 11).sum() == (new == 3).sum()
    np.testing.assert_array_equal(want_info[10]["bbox"], [[12, 22], [13, 23]])


def test_device_renumbering_equals_remap_label():
    """`remap_labels_u16` of a cropped window of compacted labels equals
    `remap_label` of the same crop on the host: the crop loses some ids,
    so the ids it keeps have gaps; an empty crop stays 0."""
    from hover_net_tpu.metrics.stats import remap_label as jax_remap
    from hover_net_tpu_torch.metrics.stats import remap_label
    from hover_net_tpu_torch.ops.post_proc_device import (
        compact_labels_u16, proc_np_hv_batch, remap_labels_u16)

    pred = pred_map((300, 260), 3, 60)
    inst, n = compact_labels_u16(proc_np_hv_batch(
        torch.from_numpy(pred.astype(np.float32))[None]))
    lab = inst.to(torch.int32)[0]
    assert int(n[0]) > 30
    for y0, y1, x0, x1 in ((37, 251, 13, 190), (0, 300, 0, 260),
                           (100, 101, 50, 52)):
        crop = lab[y0:y1, x0:x1]
        want = remap_label(crop.numpy())
        got = remap_labels_u16(crop)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)
        np.testing.assert_array_equal(want, jax_remap(crop.numpy()))
    assert int(remap_label(lab[37:251, 13:190].numpy()).max()) < int(n[0])
    empty = torch.zeros((5, 7), dtype=torch.int32)
    assert not remap_labels_u16(empty).any()


def test_scatter_clamps_the_dustbin_like_jax():
    """Patch outputs written at a coordinate past the buffer (the JAX
    padded-batch "dustbin") clamp into the bottom-right slack exactly as
    `dynamic_update_slice` clamps them; the slide region is untouched."""
    rng = np.random.default_rng(0)
    buf = np.zeros((512, 512, 3), np.float16)
    outs = rng.normal(0, 1, (4, 164, 164, 3)).astype(np.float32)
    coords = np.array([[0, 0], [164, 300], [512, 512], [600, 10]], np.int32)
    mgr = JaxWSI.__new__(JaxWSI)
    mgr._fwd_fns = {}
    want = np.asarray(mgr._scatter_fn()(jnp.asarray(buf), jnp.asarray(outs),
                                        jnp.asarray(coords)))
    got = torch.from_numpy(buf.copy())
    port_wsi.scatter_patches(got, torch.from_numpy(outs), coords)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(want[348:, 348:],
                                  outs[2].astype(np.float16))


@pytest.fixture(scope="module")
def slide(tmp_path_factory):
    """A width-8 checkpoint (.tar from JAX variables), a 600 x 500 `.npy`
    pseudo-slide of synthetic nuclei and its tissue mask."""
    import cv2
    import jax

    from hover_net_tpu.models import HoVerNet, HoVerNetConfig
    from hover_net_tpu.models.checkpoints import save_torch_tar

    root = tmp_path_factory.mktemp("wsi")
    cfg = HoVerNetConfig(mode="fast", nr_types=None, width=WIDTH)
    variables = jax.jit(lambda: HoVerNet(cfg).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 256, 256, 3)), train=False))()
    tar = str(root / "tiny.tar")
    save_torch_tar(tar, jax.tree_util.tree_map(np.asarray, variables), cfg)
    img = np.full((600, 500, 3), 235, np.uint8)
    img[_paint_nuclei((600, 500), np.random.default_rng(2), 40) > 0] = (
        130, 80, 150)
    os.makedirs(root / "in")
    os.makedirs(root / "mask")
    np.save(str(root / "in" / "sample.npy"), img)
    cv2.imwrite(str(root / "mask" / "sample.png"),
                np.full((60, 50), 255, np.uint8))
    return root, tar


def raw_prediction(mgr, root, dev_mode):
    """Chunked inference of the pseudo-slide into the pred map."""
    mgr.wsi_handler = get_file_handler(str(root / "in" / "sample.npy"))
    mgr.wsi_handler.prepare_reading(read_mag=40)
    mgr.wsi_proc_shape = np.array((600, 500))
    mgr.wsi_mask = np.ones((60, 50), np.uint8)
    if dev_mode:
        mgr._alloc_pred_dev(3)
    else:
        mgr._pred_map_path = str(root / f"pred_{id(mgr)}.npy")
        np.save(mgr._pred_map_path, np.zeros((600, 500, 3), np.float32))
    chunk_info, patch_info = wsi_chunk_patch_grids(
        mgr.wsi_proc_shape, np.array([420, 420]), np.array([256, 256]),
        np.array([164, 164]))
    assert len(chunk_info) > 1  # several chunks: the prefetch runs
    mgr._get_raw_prediction(chunk_info, patch_info)
    if not dev_mode:
        return np.load(mgr._pred_map_path)
    buf = mgr._pred_dev
    buf = buf.numpy() if isinstance(buf, torch.Tensor) else np.asarray(buf)
    return buf[:600, :500].astype(np.float32)


def test_raw_prediction_matches_jax(slide):
    """Width 8, float32: the stitched prediction of the port's chunk loop
    (device buffer and mmap) against the JAX manager's, within 2e-4 of
    the map's scale (the forward bound of tests/test_torch_tile.py)."""
    root, tar = slide
    kw = dict(model_path=tar, mode="fast", nr_types=None, width=WIDTH,
              batch_size=3, chunk_shape=420, tile_shape=256,
              ambiguous_size=32, proc_mag=40, pred_map_dtype="float32",
              cache_path=str(root / "cache"))
    want = raw_prediction(JaxWSI(dtype=jnp.float32, **kw), root, True)
    port = PortWSI(dtype=torch.float32, device="cpu", **kw)
    got = raw_prediction(port, root, True)
    # chunks of 4 and 2 patches in batches of 3: two of them partial
    assert port.n_forward_batches == 3
    rel = np.abs(got - want).max() / max(1.0, np.abs(want).max())
    assert rel < 2e-4, rel
    got_mmap = raw_prediction(PortWSI(dtype=torch.float32, device="cpu",
                                      **kw), root, False)
    np.testing.assert_array_equal(got_mmap, got)


def test_process_wsi_list_writes_json_and_resumes(slide, tmp_path):
    root, tar = slide
    mgr = PortWSI(model_path=tar, mode="fast", nr_types=None, width=WIDTH,
                  batch_size=8, dtype=torch.float32, chunk_shape=1000,
                  tile_shape=256, ambiguous_size=32, proc_mag=40,
                  cache_path=str(tmp_path / "cache"), device="cpu")
    out = str(tmp_path / "out")
    assert mgr.process_wsi_list(str(root / "in"), out,
                                input_mask_dir=str(root / "mask")) == 1
    with open(f"{out}/sample.json") as f:
        payload = json.load(f)
    assert payload["mag"] == 40 and isinstance(payload["nuc"], dict)
    times = mgr.timings["sample"]
    assert {"inference", "post_proc_phase1", "post_proc_phase2",
            "post_proc_phase3", "save"} <= set(times)
    mtime = os.path.getmtime(f"{out}/sample.json")
    assert mgr.process_wsi_list(str(root / "in"), out) == 0  # resume
    assert os.path.getmtime(f"{out}/sample.json") == mtime
    assert not os.path.exists(tmp_path / "cache")


def test_wsi_cli_on_cpu(slide, tmp_path):
    from hover_net_tpu_torch.cli.run_infer import main

    root, tar = slide
    out = tmp_path / "out"
    main(["--model_path", tar, "--width", str(WIDTH), "--batch_size", "8",
          "--device", "cpu", "wsi", "--input_dir", str(root / "in"),
          "--output_dir", str(out), "--input_mask_dir", str(root / "mask"),
          "--cache_path", str(tmp_path / "cache"), "--tile_shape", "256",
          "--ambiguous_size", "32", "--chunk_shape", "1000",
          "--save_mask"])
    with open(out / "json" / "sample.json") as f:
        assert set(json.load(f)) == {"mag", "nuc"}
    assert os.path.exists(out / "mask" / "sample.png")
    # --n_devices 2 on the CPU runs on its one device (clamped) and, the
    # slide's json being written, skips it (resume)
    mtime = os.path.getmtime(out / "json" / "sample.json")
    mgr = main(["--model_path", tar, "--width", str(WIDTH), "--n_devices",
                "2", "--device", "cpu", "wsi", "--input_dir",
                str(root / "in"), "--output_dir",
                str(out), "--cache_path", str(tmp_path / "cache"),
                "--save_mask"])
    assert mgr.devices == (torch.device("cpu"),) and mgr.mesh is None
    assert os.path.getmtime(out / "json" / "sample.json") == mtime
