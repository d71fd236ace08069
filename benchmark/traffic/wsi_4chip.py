"""Slide traffic across cards: one pseudo-slide through `run_infer wsi
--n_devices <n>`, that is `WSIInferManager.process_wsi_list` on a mesh of
the cell's `n_devices` cards, one slide a call, back to back.

The painter, the mask, the warm-up, the window, `wsi_mpx_per_s` and the
three numbers of `correct` are `traffic/wsi.py`'s (its helpers are
imported); what this kind has of its own:

- the manager runs on cuda:0..n-1, as `--n_devices n` builds it (on the
  CPU, n slots of the one device): each forward batch is
  `batch_size` patches a card, the stitched prediction map is row-striped
  over the cards (each card holds its core rows and landing rows), and
  each window batch's shards are assembled by `psum_scatter` and
  post-processed on their own card;
- the check's tap reads the checked slide's map from the stripes' core
  rows (the map a one-card run holds);
- the line's `device` names the cards it ran on (`count`) and the largest
  of their memory peaks.

A traced run's facts hold `traffic/wsi.py`'s keys, and its trace summary
each card's busy seconds in the traced slide (`busy_s_by_card`, the union
of that card's kernel, copy and memset intervals; `CardStretch`). Of the
`.wsi` readers, those of host spans (the chunk loop, the post-processing
and its extraction and callbacks, the chunk wait), the forward batches'
device ms summed over the cards and K1's roofline (its kernels' device
seconds summed over the cards, against the bytes of every window) are
defined on a mesh; the whole step's share of one card's peak and the idle
share of "the card" are not, and this kind is not listed for them. The
cards' idle share is `device_idle_pct.wsi_mesh`'s: the mean over the
cards of each card's.
"""

from __future__ import annotations

import logging
import os
import time

import numpy as np

from .. import common
from ..reference.geometry import slide_patches, slide_windows
from ..roofline import patch_flops
from .wsi import (
    LOGGER,
    MASK_SCALE,
    _Errors,
    _one_slide_dirs,
    check,
    checked_slide,
    draw_regions,
    draw_tile,
    paint_slides,
)


def busy_by_card(events, cards) -> dict:
    """{card index: seconds in which some kernel, copy or memset ran on
    that card within the stretch mark} over chrome-trace events
    (microseconds), every card of `cards` present."""
    from ..trace import DEVICE_CATS, MARK, _union

    mark = next(e for e in events
                if e.get("ph") == "X" and e.get("name") == MARK)
    w0 = float(mark["ts"])
    w1 = w0 + float(mark["dur"])
    spans = {int(c): [] for c in cards}
    for e in events:
        if e.get("ph") != "X" or "dur" not in e \
                or e.get("cat", "") not in DEVICE_CATS:
            continue
        card = int(e.get("args", {}).get("device", e.get("pid")))
        s0 = max(float(e["ts"]), w0)
        s1 = min(float(e["ts"]) + float(e["dur"]), w1)
        if s1 > s0:
            spans.setdefault(card, []).append((s0, s1))
    out = {}
    for card, iv in spans.items():
        busy = _union(np.asarray(sorted(iv), float).reshape(-1, 2))
        out[str(card)] = float((busy[:, 1] - busy[:, 0]).sum()) * 1e-6 \
            if len(busy) else 0.0
    return out


def card_stretch(work: str, cards):
    """`trace.Stretch` whose summary also holds `busy_s_by_card`
    (`busy_by_card` over `cards`, the indices of the mesh's cards)."""
    import json

    from ..trace import Stretch, summarize

    class CardStretch(Stretch):
        def summary(self) -> dict:
            if self.prof is None:
                raise RuntimeError("the window ended before the traced "
                                   "stretch began")
            self.prof.export_chrome_trace(self.path)
            with open(self.path) as f:
                events = json.load(f)["traceEvents"]
            os.remove(self.path)
            out = summarize(events)
            out["busy_s_by_card"] = busy_by_card(events, cards)
            return out

    return CardStretch(work)


def stripe_crop(stripes, stripe, y: int, x: int, h: int, w: int):
    """The [h, w, C] box at (y, x) of the map held row-striped in
    `stripes` (`WSIInferManager._stripe` = (core rows, landing rows)),
    read from each card's core rows, as float32 numpy."""
    s_rows, halo = stripe
    out = []
    for d, buf in enumerate(stripes):
        lo, hi = max(y, d * s_rows), min(y + h, (d + 1) * s_rows)
        if lo < hi:
            r0 = halo + lo - d * s_rows
            out.append(buf[r0:r0 + hi - lo, x:x + w].float().cpu().numpy())
    return np.concatenate(out)


def run(ctx: common.Context) -> dict:
    import cv2
    import torch

    from hover_net_tpu_torch.infer.wsi import WSIInferManager

    cell, cfg = ctx.cell, ctx.cfg
    n_dev = cell["n_devices"]
    work = ctx.workdir()
    weights = ctx.weights()
    src = os.path.join(work, "src")
    os.makedirs(src)
    slides = paint_slides(ctx, src, src)
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
        from ..trace import span

        stretch = card_stretch(
            work, range(n_dev) if ctx.device.startswith("cuda") else ())

    mgr = WSIInferManager(
        model_path=weights, mode=cfg["mode"], nr_types=cfg["nr_types"],
        type_info_path=type_info, width=cfg["width"],
        dtype=getattr(torch, cfg["dtype"]), batch_size=cfg["batch_size"],
        devices=([f"cuda:{i}" for i in range(n_dev)]
                 if ctx.device.startswith("cuda") else [ctx.device] * n_dev),
        chunk_shape=cell["chunk_shape"], tile_shape=cell["tile_shape"],
        ambiguous_size=cell["ambiguous_size"], proc_mag=40,
        cache_path=os.path.join(work, "cache"))
    if mgr.mesh is None or len(mgr.mesh) != n_dev:
        raise SystemExit(f"the manager runs on {len(mgr.devices)} slots, "
                         f"the cell needs {n_dev}")
    post_process = mgr.post_process_phases

    def tapped():
        if current[0] == check_slide:
            kept["pred"] = (mgr._pred_dev, mgr._stripe)
        return post_process()

    mgr.post_process_phases = tapped
    if stretch is not None:
        mgr._run_chunk = span("bench.chunk", mgr._run_chunk)
        mgr._dispatch_post_processing = span(
            "bench.post_proc_phase", mgr._dispatch_post_processing)
    _, d_in, d_mask = _one_slide_dirs(work, "warm", "warm")
    mgr.process_wsi_list(d_in, os.path.join(work, "out", "warm"),
                         input_mask_dir=d_mask)
    mgr.timings.clear()
    traced = cell["trace_slide"]
    cards = [d for d in mgr.mesh.devices if d.type == "cuda"]
    for dev in cards:
        torch.cuda.synchronize(dev)
    setup_s = ctx.elapsed()

    written, calls = 0, 0
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < ctx.seconds:
        _, d_in, d_mask = _one_slide_dirs(
            work, f"w{calls % len(slides)}", calls)
        current[0] = calls
        if stretch is not None and calls == traced:
            stretch.start()
        written += mgr.process_wsi_list(
            d_in, os.path.join(work, "out", str(calls)),
            input_mask_dir=d_mask)
        if stretch is not None and calls == traced:
            stretch.stop()
        calls += 1
    window_s = time.perf_counter() - t_start
    if stretch is not None and stretch.prof is not None \
            and stretch.host_s is None:
        stretch.stop()
    timings = dict(mgr.timings)
    size = cell["slide_size"]
    mpx = calls * size * size / 1e6
    device = common.device_info(ctx.device)
    device["count"] = len(mgr.mesh.devices)
    if cards:
        device["memory_peak_bytes"] = max(
            int(torch.cuda.max_memory_allocated(d)) for d in cards)
    img, mask = slides[check_slide]
    regions = draw_regions(ctx, mask)
    box = draw_tile(ctx, mask)
    port, pred = None, kept.pop("pred", None)
    if pred is not None:
        (stripes, stripe), r, t = pred, cell["check_region"], \
            cell["tile_shape"]
        port = {"regions": [stripe_crop(stripes, stripe, y, x, r, r)
                            for y, x in regions],
                "tile": stripe_crop(stripes, stripe, box[0], box[1], t, t)}
    del mgr, pred
    logger.removeHandler(handler)
    common.free_cuda()

    json_path = os.path.join(work, "out", str(check_slide),
                             f"s{check_slide:03d}.json")
    out = {"attempted": calls, "failed": calls - written, "device": device,
           "e2e": {"setup_s": setup_s, "wsi_mpx_per_s": mpx / window_s},
           "checks": check(ctx, weights, slides[check_slide], regions, box,
                           port, json_path)}
    common.log(f"window {window_s:.3f} s, {written} slides on {n_dev} "
               f"cards; setup {setup_s:.3f} s")
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
