"""The WSI manager's instance map on the device: `process_single_file` on a
resident slide keeps the map beside the pred map and runs the phase
callbacks there, and writes the json it writes with the map on the host.
A CPU case, and the same on a card, marked `gpu`, which skips without a
CUDA device.

This file imports no jax, so its card test runs on a machine without it:
  python -m pytest --noconftest -m gpu tests/test_torch_wsi_map.py
"""

import json
import os

import cv2
import numpy as np
import pytest
import torch

from hover_net_tpu_torch.infer.wsi import WSIInferManager
from hover_net_tpu_torch.models.hovernet import HoVerNet, HoVerNetConfig
from hover_net_tpu_torch.ops.targets import gen_instance_hv_map

# several test workers share the host's cores
torch.set_num_threads(1)

WIDTH = 8
NR_TYPES = 4
SHAPE = (900, 700)
# the repository's palette: without it a typed manager draws one with
# matplotlib, which the card's machine lacks
TYPE_INFO = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "type_info.json")


def paint(shape, seed, n, radius=(6, 11)):
    """Instance labels of `n` seeded discs of radius in [radius)."""
    rng = np.random.default_rng(seed)
    inst = np.zeros(shape, np.int32)
    yy, xx = np.mgrid[-12:13, -12:13]
    for k in range(1, n + 1):
        cy, cx = (int(v) for v in rng.integers(14, np.array(shape) - 14))
        m = (yy ** 2 + xx ** 2) <= int(rng.integers(*radius)) ** 2
        sub = inst[cy - 12:cy + 13, cx - 12:cx + 13]
        sub[m & (sub == 0)] = k
    return inst


@pytest.fixture(scope="module")
def slide(tmp_path_factory):
    """A typed width-8 checkpoint, a pseudo-slide with its mask, and the
    float32 (tp, np, hv) prediction the runs stitch in place of a
    forward: discs of known types, so that every phase has nuclei."""
    root = tmp_path_factory.mktemp("wsi_map")
    net = HoVerNet(HoVerNetConfig(mode="fast", nr_types=NR_TYPES,
                                  width=WIDTH),
                   generator=torch.Generator().manual_seed(0))
    tar = str(root / "w8.tar")
    torch.save({"desc": net.state_dict()}, tar)
    os.makedirs(root / "in")
    os.makedirs(root / "mask")
    np.save(str(root / "in" / "s.npy"), np.zeros(SHAPE + (3,), np.uint8))
    cv2.imwrite(str(root / "mask" / "s.png"),
                np.full((SHAPE[0] // 10, SHAPE[1] // 10), 255, np.uint8))
    inst = paint(SHAPE, 4, 260)
    hv = gen_instance_hv_map(inst, SHAPE)
    pred = np.dstack([(inst % NR_TYPES) * (inst > 0), inst > 0,
                      hv[..., 0], hv[..., 1]]).astype(np.float32)
    return root, tar, pred


def run_slide(root, tar, pred, device, tag, host_map,
              nr_types=NR_TYPES, tile_shape=256, ambiguous_size=32):
    """`process_wsi_list` over the slide with `pred` stitched in place of
    the chunk loop's forward; with `host_map` the instance map is swapped
    for a numpy one before the phases. (json payload, the slide's
    timings, the manager)."""
    mgr = WSIInferManager(model_path=tar, mode="fast", nr_types=nr_types,
                          type_info_path=TYPE_INFO, width=WIDTH,
                          dtype=torch.float32, batch_size=8,
                          device=device, chunk_shape=1000,
                          tile_shape=tile_shape,
                          ambiguous_size=ambiguous_size, proc_mag=40,
                          pred_map_dtype="float32",
                          cache_path=str(root / f"cache_{tag}"))
    shape = pred.shape[:2]

    def stitched(chunk_info, patch_info):
        mgr._pred_dev[:shape[0], :shape[1]] = torch.from_numpy(pred).to(
            mgr._pred_dev.device)

    phases = mgr.post_process_phases

    def on_host_map():
        assert isinstance(mgr.wsi_inst_map, torch.Tensor)
        mgr.wsi_inst_map = np.zeros(shape, np.int32)
        return phases()

    mgr._get_raw_prediction = stitched
    if host_map:
        mgr.post_process_phases = on_host_map
    out = root / f"out_{tag}"
    assert mgr.process_wsi_list(str(root / "in"), str(out),
                                input_mask_dir=str(root / "mask")) == 1
    with open(out / "s.json") as f:
        payload = json.load(f)
    return payload, mgr.timings["s"], mgr


@pytest.mark.parametrize("device", [
    "cpu", pytest.param("cuda", marks=pytest.mark.gpu)])
def test_resident_slide_keeps_its_instance_map_on_the_device(
        slide, device, monkeypatch):
    """The resident slide's map is a torch.int32 tensor on the manager's
    device, every callback counts as run there (`pp_callback_windows_dev`
    only), no `pred_inst.npy` is made, and the json equals the json of
    the same slide with the map on the host, nucleus for nucleus; the
    device map equals the host map."""
    if device == "cuda" and not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    root, tar, pred = slide
    created = []
    open_memmap = np.lib.format.open_memmap

    def watched(path, *args, **kwargs):
        created.append(os.path.basename(path))
        return open_memmap(path, *args, **kwargs)

    monkeypatch.setattr(np.lib.format, "open_memmap", watched)
    dev_json, dev_times, dev_mgr = run_slide(root, tar, pred, device,
                                             f"{device}_dev", False)
    host_json, host_times, host_mgr = run_slide(root, tar, pred, device,
                                                f"{device}_host", True)
    assert dev_mgr._pred_dev_mode and "pred_inst.npy" not in created
    inst_map = dev_mgr.wsi_inst_map
    assert isinstance(inst_map, torch.Tensor)
    assert inst_map.dtype == torch.int32
    assert inst_map.device.type == device
    n = host_times["pp_callback_windows_host"]
    assert n > 20 and "pp_callback_windows_dev" not in host_times
    assert dev_times["pp_callback_windows_dev"] == n
    assert "pp_callback_windows_host" not in dev_times
    assert len(dev_json["nuc"]) > 150
    assert dev_json == host_json
    np.testing.assert_array_equal(inst_map.cpu().numpy(),
                                  host_mgr.wsi_inst_map)


@pytest.fixture(scope="module")
def dense_slide(tmp_path_factory):
    """A 4096^2 pseudo-slide of full tissue at the slide cells' density
    (PanNuke's 385 nuclei a tissue Mpx, discs of radius 5-10, 6 types),
    its typed width-8 checkpoint and its float32 (tp, np, hv) prediction."""
    root = tmp_path_factory.mktemp("wsi_dense")
    shape = (4096, 4096)
    net = HoVerNet(HoVerNetConfig(mode="fast", nr_types=6, width=WIDTH),
                   generator=torch.Generator().manual_seed(0))
    tar = str(root / "w8_6.tar")
    torch.save({"desc": net.state_dict()}, tar)
    os.makedirs(root / "in")
    os.makedirs(root / "mask")
    np.save(str(root / "in" / "s.npy"), np.zeros(shape + (3,), np.uint8))
    cv2.imwrite(str(root / "mask" / "s.png"),
                np.full((shape[0] // 16, shape[1] // 16), 255, np.uint8))
    inst = paint(shape, 7, round(385 * shape[0] * shape[1] / 1e6),
                 radius=(5, 11))
    hv = gen_instance_hv_map(inst, shape)
    pred = np.dstack([(inst % 6) * (inst > 0), inst > 0,
                      hv[..., 0], hv[..., 1]]).astype(np.float32)
    return root, tar, pred, inst


@pytest.mark.gpu
def test_window_tables_on_card_at_slide_density(dense_slide, monkeypatch):
    """A resident slide at the cells' density and window size (2048^2
    tiles, 128-px ambiguous strips): every window's dict comes from the
    card's tables (`pp_extract_windows_tables`, none dense), and the json
    equals the json of the same slide with every window's dense
    extraction forced. Prints the table pass's card time a 2048^2 window
    (CUDA events over batches of 4, as phase 1 sends them) and holds it to
    1.5 ms a Mpx."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from hover_net_tpu_torch.infer import wsi as wsi_mod
    from hover_net_tpu_torch.ops.post_proc_device import (
        remap_labels_u16, window_caps, window_tables)

    root, tar, pred, inst = dense_slide
    kw = dict(nr_types=6, tile_shape=2048, ambiguous_size=128)
    got, times, mgr = run_slide(root, tar, pred, "cuda", "tables", False,
                                **kw)
    windows = times["pp_callback_windows_dev"]
    assert windows > 10
    assert times["pp_extract_windows_tables"] == windows
    assert times["pp_extract_windows_dense"] == 0
    assert len(got["nuc"]) > 5000

    monkeypatch.setattr(wsi_mod, "instance_info_from_tables",
                        lambda *args: (None, None))
    want, dense_times, _ = run_slide(root, tar, pred, "cuda", "dense", False,
                                     **kw)
    assert dense_times["pp_extract_windows_dense"] == windows
    assert dense_times["pp_extract_windows_tables"] == 0
    assert got == want

    # the table pass alone on the slide's four 2048^2 windows
    side = 2048
    corners = [(y, x) for y in (0, side) for x in (0, side)]
    lab = torch.stack([remap_labels_u16(torch.from_numpy(
        inst[y:y + side, x:x + side]).cuda()) for y, x in corners])
    tp = torch.stack([torch.from_numpy(pred[y:y + side, x:x + side, 0])
                      for y, x in corners]).cuda().to(torch.uint8)
    caps = window_caps(side * side)
    out = window_tables(lab, tp, 6, *caps)
    assert int(out["coo_n"].max()) < caps[1]
    assert int(out["n"].max()) < caps[0]
    reps = 10
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(reps):
        window_tables(lab, tp, 6, *caps)
    end.record()
    end.synchronize()
    ms = start.elapsed_time(end) / reps / 4
    mpx = side * side / 1e6
    print(f"window tables: {ms:.3f} ms a 2048^2 window "
          f"({ms / mpx:.3f} ms/Mpx; budget 1.5), "
          f"n {out['n'].tolist()}, coo_n {out['coo_n'].tolist()} "
          f"({torch.cuda.get_device_name(0)})")
    assert ms / mpx <= 1.5
