"""Slide traffic: whole pseudo-slides through `run_infer wsi`, that is
`WSIInferManager.process_wsi_list`, one slide a call, back to back.

Set-up paints `slides` distinct `.npy` pseudo-slides of `slide_size`^2 at
40x (a smoothed random tissue mask covering `tissue_fraction` of each, as
a png at 1/16; nuclei only in tissue, at `nuclei_per_mpx` a million tissue
pixels), loads the cached recipe weights into the manager (the CLI's
settings: `chunk_shape`, `tile_shape`, `ambiguous_size`, batch, json
output, the prediction map resident on the card under the default 4 GiB
budget) and runs one smaller warm-up slide. The window then runs the
slides in turn until `--seconds` have passed; it ends with the last slide.

- `wsi_mpx_per_s`: the slides' full area (tissue or not) over the time
  from the first slide's start to the last slide's end.

`correct` (after the window, the manager freed): one slide drawn from
`--seed` among the first two; its stitched prediction map (kept from the
manager when its post-processing starts) over `check_regions` regions of
`check_region`^2 drawn from `--seed` where the mask is at least a third
tissue, against the reference's float32 map of the same patches; and the
slide's json nuclei inside each region against the oracle's nuclei on the
reference map (printed, not compared) and, by themselves, the three
post-processing phases and the json: the json nuclei against the oracle
run on the program's own map of the region (in both, nuclei within
`margin` of a region's edge left out).
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np

from .. import common
from ..reference import compare
from ..reference.geometry import slide_patches, slide_windows
from ..reference.paint import paint_slide
from ..roofline import patch_flops

LOGGER = "hover_net_tpu_torch"
MASK_SCALE = 16


class _Errors(logging.Handler):
    def __init__(self):
        super().__init__(logging.WARNING)

    def emit(self, record):
        common.log(self.format(record))


def paint_slides(ctx, src: str, mask_dir: str):
    """The cell's slides as `src/w<k>.npy` with masks `mask_dir/w<k>.png`;
    returns [(image, mask)]."""
    import cv2

    out = []
    for k in range(ctx.cell["slides"]):
        img, mask = paint_one(ctx, k)
        np.save(os.path.join(src, f"w{k}.npy"), img)
        cv2.imwrite(os.path.join(mask_dir, f"w{k}.png"), mask * 255)
        out.append((img, mask))
    return out


def paint_one(ctx, k: int):
    """Slide k of the cell from `--seed`: (image, mask)."""
    cell = ctx.cell
    seed = np.random.default_rng(ctx.seed).integers(1 << 62, size=k + 1)[k]
    return paint_slide(cell["slide_size"], cell["slide_size"],
                       cell["nuclei_per_mpx"], cell["tissue_fraction"],
                       int(seed), ctx.cfg["nr_types"], MASK_SCALE,
                       device=ctx.device)


def checked_slide(ctx) -> int:
    """The window's slide whose output is checked, from `--seed`."""
    return int(np.random.default_rng([ctx.seed, 1]).integers(
        0, min(2, ctx.cell["slides"])))


def _one_slide_dirs(work, slide, call):
    """in/<call>/<name>.npy and masks/<call>/<name>.png linking the slide
    `src/<slide>.npy` and its mask."""
    name = call if isinstance(call, str) else f"s{call:03d}"
    d_in = os.path.join(work, "in", str(call))
    d_mask = os.path.join(work, "masks", str(call))
    os.makedirs(d_in)
    os.makedirs(d_mask)
    os.symlink(os.path.join(work, "src", f"{slide}.npy"),
               os.path.join(d_in, f"{name}.npy"))
    os.symlink(os.path.join(work, "src", f"{slide}.png"),
               os.path.join(d_mask, f"{name}.png"))
    return name, d_in, d_mask


def run(ctx: common.Context) -> dict:
    import cv2
    import torch

    from hover_net_tpu_torch.infer.wsi import WSIInferManager

    cell, cfg = ctx.cell, ctx.cfg
    work = ctx.workdir()
    weights = ctx.weights()
    src = os.path.join(work, "src")
    os.makedirs(src)
    slides = paint_slides(ctx, src, src)
    # the warm-up slide: the top-left corner of the first slide
    warm = cell["warm_size"]
    np.save(os.path.join(src, "warm.npy"), slides[0][0][:warm, :warm])
    wm = -(-warm // MASK_SCALE)
    cv2.imwrite(os.path.join(src, "warm.png"), slides[0][1][:wm, :wm] * 255)
    check_slide = checked_slide(ctx)
    type_info = common.write_type_info(ctx)

    handler = _Errors()
    logger = logging.getLogger(LOGGER)
    logger.addHandler(handler)
    logger.propagate = False
    kept, current = {}, [None]
    stretch = None
    if ctx.trace:
        from ..trace import Stretch, span

        stretch = Stretch(work)

    def manager():
        """A manager as `run_infer wsi` builds it, with the check's tap on
        its post-processing (the stitched map of the checked slide is kept
        when its post-processing starts) and, in a traced run, spans."""
        mgr = WSIInferManager(
            model_path=weights, mode=cfg["mode"], nr_types=cfg["nr_types"],
            type_info_path=type_info, width=cfg["width"],
            dtype=getattr(torch, cfg["dtype"]),
            batch_size=cfg["batch_size"], device=ctx.device,
            chunk_shape=cell["chunk_shape"], tile_shape=cell["tile_shape"],
            ambiguous_size=cell["ambiguous_size"], proc_mag=40,
            cache_path=os.path.join(work, "cache"))
        post_process = mgr.post_process_phases

        def tapped():
            if current[0] == check_slide:
                kept["pred"] = mgr._pred_dev
            return post_process()

        mgr.post_process_phases = tapped
        if stretch is not None:
            mgr._run_chunk = span("bench.chunk", mgr._run_chunk)
            mgr._dispatch_post_processing = span(
                "bench.post_proc_phase", mgr._dispatch_post_processing)
        return mgr

    mgr = manager()
    _, d_in, d_mask = _one_slide_dirs(work, "warm", "warm")
    mgr.process_wsi_list(d_in, os.path.join(work, "out", "warm"),
                         input_mask_dir=d_mask)
    mgr.timings.clear()
    # one `run_infer wsi` job a slide (a manager built for each), or one
    # manager over every slide
    per_job = cell["manager_per_slide"]
    traced = cell["trace_slide"]
    if ctx.device.startswith("cuda"):
        torch.cuda.synchronize()
    setup_s = ctx.elapsed()

    written, calls, timings = 0, 0, {}
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < ctx.seconds:
        name, d_in, d_mask = _one_slide_dirs(
            work, f"w{calls % len(slides)}", calls)
        current[0] = calls
        if stretch is not None and calls == traced:
            stretch.start()
        if per_job:
            del mgr
            mgr = manager()
        written += mgr.process_wsi_list(
            d_in, os.path.join(work, "out", str(calls)),
            input_mask_dir=d_mask)
        timings.update(mgr.timings)
        if stretch is not None and calls == traced:
            stretch.stop()
        calls += 1
    window_s = time.perf_counter() - t_start
    if stretch is not None and stretch.prof is not None \
            and stretch.host_s is None:
        stretch.stop()
    size = cell["slide_size"]
    mpx = calls * size * size / 1e6
    device = common.device_info(ctx.device)
    img, mask = slides[check_slide]
    regions = draw_regions(ctx, mask)
    box = draw_tile(ctx, mask)
    port, pred = None, kept.pop("pred", None)
    if pred is not None:
        r, t = cell["check_region"], cell["tile_shape"]
        port = {"regions": [pred[y:y + r, x:x + r].float().cpu().numpy()
                            for y, x in regions],
                "tile": pred[box[0]:box[0] + t, box[1]:box[1] + t]
                .float().cpu().numpy()}
    del mgr, pred
    logger.removeHandler(handler)
    common.free_cuda()

    json_path = os.path.join(work, "out", str(check_slide),
                             f"s{check_slide:03d}.json")
    out = {"attempted": calls, "failed": calls - written, "device": device,
           "e2e": {"setup_s": setup_s, "wsi_mpx_per_s": mpx / window_s},
           "checks": check(ctx, weights, slides[check_slide], regions, box,
                           port, json_path)}
    common.log(f"window {window_s:.3f} s, {written} slides; setup "
               f"{setup_s:.3f} s")
    if stretch is not None:
        img, mask = slides[traced % len(slides)]
        win, step = cfg["patch_input"], cfg["patch_output"]
        summary = stretch.summary()
        out["trace"] = summary
        out["facts"] = {
            "timings": timings, "mpx": mpx, "trace": summary,
            "flops_per_patch": patch_flops(cfg["mode"], cfg["nr_types"],
                                           cfg["width"], win),
            "patches": len(slide_patches(img.shape[:2], mask,
                                         cell["chunk_shape"], win, step)),
            "k1_pixels": sum(h * w for h, w in slide_windows(
                img.shape[:2], mask, cell["tile_shape"],
                cell["ambiguous_size"])),
        }
    return out


def draw_tile(ctx, mask):
    """The top-left (y, x) of one whole first-phase post-processing tile
    (`tile_shape`^2, inside the slide) whose part clear of the boundary
    and corner bands is at least half tissue, drawn from `--seed`."""
    from ..reference.geometry import wsi_tile_grids

    cell = ctx.cell
    t, size = cell["tile_shape"], cell["slide_size"]
    band = 2 * cell["ambiguous_size"] + cell["margin"]
    grid = wsi_tile_grids((size, size), np.array([t, t]),
                          cell["ambiguous_size"])[0]
    s = MASK_SCALE
    share = {(int(y), int(x)): mask[(y + band) // s:-(-(y1 - band) // s),
                                    (x + band) // s:-(-(x1 - band) // s)
                                    ].mean()
             for (y, x), (y1, x1) in grid if y1 - y == t and x1 - x == t}
    full = [tl for tl, v in share.items() if v >= 0.5]
    if not full:
        return max(share, key=share.get)
    rng = np.random.default_rng([ctx.seed, 3])
    return full[int(rng.integers(len(full)))]


def draw_regions(ctx, mask) -> list:
    """`check_regions` top-lefts (y, x) of `check_region`^2 boxes whose
    mask is at least a third tissue, drawn from `--seed`."""
    cell = ctx.cell
    r, size = cell["check_region"], cell["slide_size"]
    rng = np.random.default_rng([ctx.seed, 2])
    out = []
    for _ in range(1000):
        y, x = (int(v) for v in rng.integers(0, size - r + 1, 2))
        m = mask[y // MASK_SCALE:-(-(y + r) // MASK_SCALE),
                 x // MASK_SCALE:-(-(x + r) // MASK_SCALE)]
        if m.mean() >= 1 / 3:
            out.append((y, x))
            if len(out) == cell["check_regions"]:
                break
    return out


def check(ctx, weights, slide, regions, box, port, json_path) -> dict:
    """The numbers that decide `correct`, each [value, limit]."""
    from ..reference.infer import Reference
    from ..reference.postproc import proc_np_hv

    cell, cfg = ctx.cell, ctx.cfg
    limits = cell["limits"]
    if port is None or not os.path.exists(json_path):
        return {"checked_slide_missing": [1, 0]}
    typed = cfg["nr_types"] is not None
    c = 1 if typed else 0
    img, mask = slide
    boxes = slide_patches(img.shape[:2], mask, cell["chunk_shape"],
                          cfg["patch_input"], cfg["patch_output"])
    ref = Reference(cfg, weights, ctx.device)
    nuc = compare.load_nuclei(json_path)
    r, m = cell["check_region"], cell["margin"]
    interior = np.zeros((r, r), bool)
    interior[m:r - m, m:r - m] = True
    tally = compare.Tally(typed)
    for (y, x), port_map in zip(regions, port["regions"]):
        ref_map = ref.region(img, boxes, (y, x), r)
        tally.add_maps(port_map, ref_map)
        ref_inst, ref_types = compare.reference_instances(ref_map, typed)
        lab, types = compare.raster(nuc, (y, x), (r, r))
        tally.add_match(*compare.match(ref_inst, ref_types, lab, types,
                                       interior))
    # the post-processing and the json by themselves, on one whole tile of
    # the first phase: the oracle over the tile's own window (its min-max
    # normalisations see what the program's tail saw), nuclei clear of
    # the bands that the boundary and corner phases redo
    t = cell["tile_shape"]
    band = 2 * cell["ambiguous_size"] + m
    inner = np.zeros((t, t), bool)
    inner[band:t - band, band:t - band] = True
    lab, _ = compare.raster(nuc, box, (t, t))
    counted, missed, _ = compare.match(
        proc_np_hv(port["tile"][..., c:c + 3]), None, lab, None, inner)
    tally.add_stage(counted, missed)
    common.log(f"readings (not compared) {tally.readings()}")
    return {k: [v, limits[k]] for k, v in tally.numbers().items()}
