"""Tile traffic for Cellpose-SAM: a lab's 1000^2 H&E fields of view through
`run_infer tile --model_mode cellpose_sam --save_format json`, that is
`TileInferManager.process_file_list`, in directories back to back.

The tiles, the directories, the warm-up, the window, `tiles_per_s` and the
traced stretch are `traffic/tile.py`'s (its painter and helpers are
imported); what this kind has of its own:

- the weights: `reference/cellpose_recipe.py`, trained where missing and
  left out of `setup_s`;
- the manager: untyped (Cellpose-SAM types nothing), no type info;
- `correct` (after the window, the manager freed), on the `check_tiles`
  tiles a run with the seed checks: `map_err`, the program's stitched
  [dY, dX, cellprob] map against the float32 reference's
  (`reference/cellpose_sam.CellposeReference`), ||P - R|| / ||R|| over
  the three channels; `pp_miss`, the reference's dynamics (Cellpose's
  code as published) run on the program's own map against the program's
  json masks (`compare.match`: a mask missed where its best overlap has
  an IoU under 0.5); `pp_extra`, the same two the other way round: the
  program's json masks that match no mask of the reference's dynamics
  (a mask the program should have dropped or never grown). Printed and
  not compared: the program's json against the reference dynamics on
  the reference map (`inst_miss`);
- the FLOP counts of the per-layer shares: the reference's whole forward
  of one 256^2 block and its attention modules (qkv through proj), on
  the meta device, times the tile's 25 blocks;
- the control (`python3 -m benchmark.traffic.tile_cellpose --workload
  <cell> --seeds ...`): the reference with every convolution, linear
  layer and attention matmul rounded to fp8 e4m3 in the program's place
  (the 1x1 readout kept float32), on the tiles a run with the seed
  checks, judged by the cell's limits as a run is; `--rounding bf16`
  gives the bf16 witness. The program's own readings over many seeds,
  and the planted fault that loses masks, are `benchmark.control
  --program [--fault drop_nuclei]`'s; the planted fault that keeps masks
  (`--fault skip_flow_error`: the program's flow-error check drops
  nothing) is this module's, a run of the cell for each seed.

A program without `--model_mode cellpose_sam` exits at once (the mode is
checked before anything is trained or painted).
"""

from __future__ import annotations

import argparse
import functools
import json
import logging
import os
import sys
import time

import numpy as np

from .. import common
from ..reference import compare
from ..reference.geometry import tile_canvas
from .tile import LOGGER, _Events, _link_dir, paint_tiles, plan
from .wsi_vit import ensure_supported


def weights(ctx) -> str:
    """The configuration's cached recipe weights; the seconds of training
    them where missing are left out of `setup_s`."""
    from ..reference import cellpose_recipe

    t = time.perf_counter()
    path = cellpose_recipe.ensure_weights(ctx.cfg)
    spent = time.perf_counter() - t
    ctx.excluded_s += spent
    if spent > 1:
        common.log(f"recipe weights trained in {spent:.3f} s, left out of "
                   f"setup_s")
    return path


@functools.lru_cache(maxsize=4)
def block_flops(cfg_json: str):
    """(FLOPs of one forward of a 256^2 block through the reference, FLOPs
    of its attention modules), a multiply-add counting 2, counted by
    `FlopCounterMode` on the meta device."""
    import re

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from ..reference.cellpose_sam import CellposeRef

    cfg = json.loads(cfg_json)
    with torch.device("meta"):
        model = CellposeRef(cfg).eval()
        x = torch.zeros(1, 3, cfg["patch_input"], cfg["patch_input"])
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(x)
    attn = sum(sum(ops.values()) for name, ops
               in counter.get_flop_counts().items()
               if re.fullmatch(r".*\.encoder\.blocks\.\d+\.attn", name))
    return int(counter.get_total_flops()), int(attn)


def run(ctx: common.Context) -> dict:
    ensure_supported(ctx.cfg["mode"])
    import cv2
    import torch

    from hover_net_tpu_torch.infer.tile import TileInferManager

    cell, cfg = ctx.cell, ctx.cfg
    work = ctx.workdir()
    wts = weights(ctx)
    src = os.path.join(work, "src")
    os.makedirs(src)
    imgs = paint_tiles(ctx, src)
    seq, names, check_idx = plan(ctx)
    per_call, max_calls = cell["tiles_per_call"], cell["max_calls"]
    for c in range(max_calls):
        _link_dir(os.path.join(work, "in", f"c{c:04d}"),
                  [(names[i], os.path.join(src, f"t{seq[i]:03d}.png"))
                   for i in range(c * per_call, (c + 1) * per_call)])
    _link_dir(os.path.join(work, "in", "warm"),
              [(f"warm{k}", os.path.join(src, f"t{k:03d}.png"))
               for k in range(cell["warm_tiles"])])

    events = _Events()
    logger = logging.getLogger(LOGGER)
    logger.setLevel(logging.INFO)
    logger.addHandler(events)
    logger.propagate = False
    mgr = TileInferManager(
        model_path=wts, mode=cfg["mode"], nr_types=None,
        dtype=getattr(torch, cfg["dtype"]), batch_size=cfg["batch_size"],
        device=ctx.device)
    mgr.process_file_list(os.path.join(work, "in", "warm"),
                          os.path.join(work, "out", "warm"),
                          save_format="json")
    mgr.timings.clear()

    kept, finalized = {}, [0]
    finalize = mgr.finalize_prediction

    def tapped(img, dev_out, *a, **k):
        i = finalized[0]
        finalized[0] += 1
        if i in check_idx:
            kept[i] = dev_out[0]
        return finalize(img, dev_out, *a, **k)

    mgr.finalize_prediction = tapped
    imread = traced_imread = cv2.imread
    stretch = None
    if ctx.trace:
        from ..trace import Stretch, span

        stretch = Stretch(work)
        mgr.finalize_prediction = span("bench.finalize",
                                       mgr.finalize_prediction)
        mgr._save_outputs = span("bench.save", mgr._save_outputs)
        mgr.predict_image_async = span("bench.dispatch",
                                       mgr.predict_image_async)
        traced_imread = span("bench.read", imread)
    trace_calls = range(cell["trace_from_call"],
                        cell["trace_from_call"] + cell["trace_calls"])
    if ctx.device.startswith("cuda"):
        torch.cuda.synchronize()
    setup_s = ctx.elapsed()

    cv2.imread = traced_imread
    written, calls, traced_tiles = 0, 0, 0
    t_start = time.perf_counter()
    try:
        while time.perf_counter() - t_start < ctx.seconds:
            if calls >= max_calls:
                raise RuntimeError(f"the window outran {max_calls} calls")
            if stretch is not None and calls == trace_calls.start:
                stretch.start()
            done = mgr.process_file_list(
                os.path.join(work, "in", f"c{calls:04d}"),
                os.path.join(work, "out", f"c{calls:04d}"),
                save_format="json")
            written += done
            if stretch is not None and calls in trace_calls:
                traced_tiles += done
                if calls == trace_calls[-1]:
                    stretch.stop()
            calls += 1
    finally:
        cv2.imread = imread
    window_s = time.perf_counter() - t_start
    if stretch is not None and stretch.prof is not None \
            and stretch.host_s is None:
        stretch.stop()
    if ctx.device.startswith("cuda"):
        torch.cuda.synchronize()
    attempted = calls * per_call
    device = common.device_info(ctx.device)
    timings = list(mgr.timings)
    kept = {i: full.float().cpu().numpy() for i, full in kept.items()}
    del mgr, tapped
    logger.removeHandler(events)
    common.free_cuda()

    out = {"attempted": attempted, "failed": attempted - written,
           "device": device,
           "e2e": {"setup_s": setup_s, "tiles_per_s": written / window_s},
           "checks": check(ctx, wts, imgs, seq, names, kept,
                           os.path.join(work, "out"), per_call)}
    common.log(f"window {window_s:.3f} s, {written} tiles in {calls} calls; "
               f"setup {setup_s:.3f} s; counters over the tiles (min, max) "
               f"{ {k: (min(t.get(k, -1) for t in timings), max(t.get(k, -1) for t in timings)) for k in COUNTERS} }")
    if stretch is not None:
        summary = stretch.summary()
        grid, _ = tile_canvas((cell["tile_size"],) * 2, cfg["patch_input"],
                              cfg["patch_output"])
        flops, attn = block_flops(json.dumps(cfg, sort_keys=True))
        out["trace"] = summary
        out["facts"] = {
            "timings": timings, "trace": summary, "tiles": traced_tiles,
            "flops_per_tile": flops * grid[0] * grid[1],
            "attn_flops_per_tile": attn * grid[0] * grid[1],
        }
    return out


COUNTERS = ("n_seeds", "n_dropped_flow_error", "n_dropped_small")


class _Sums:
    """The compared sums over the checked tiles."""

    def __init__(self):
        self.sq_err = self.sq_ref = 0.0
        self.counted = self.missed = 0

    def add_maps(self, port, ref):
        p, r = port.astype(np.float64), ref.astype(np.float64)
        self.sq_err += float(((p - r) ** 2).sum())
        self.sq_ref += float((r ** 2).sum())

    def add_match(self, counted, missed):
        self.counted += counted
        self.missed += missed

    def map_err(self) -> float:
        return (self.sq_err / max(self.sq_ref, 1e-30)) ** 0.5

    def miss(self) -> float:
        return self.missed / max(self.counted, 1)


def check(ctx, wts, imgs, seq, names, kept, out_dir, per_call) -> dict:
    """The numbers that decide `correct`, each [value, limit]."""
    from ..reference.cellpose_sam import CellposeReference, masks_of_map

    limits = ctx.cell["limits"]
    if len(kept) < ctx.cell["check_tiles"]:
        return {"checked_tiles_missing": [ctx.cell["check_tiles"] - len(kept),
                                          0]}
    ref = CellposeReference(ctx.cfg, wts, ctx.device)
    maps, stage, spare, reading = _Sums(), _Sums(), _Sums(), _Sums()
    for i, port_full in sorted(kept.items()):
        img = imgs[seq[i]]
        h, w = img.shape[:2]
        ref_map = ref.tile(img)
        port_map = port_full[:h, :w]
        maps.add_maps(port_map, ref_map)
        nuc = compare.load_nuclei(os.path.join(
            out_dir, f"c{i // per_call:04d}", "json", f"{names[i]}.json"))
        lab, _ = compare.raster(nuc, (0, 0), (h, w))
        everywhere = np.ones((h, w), bool)
        oracle, _ = masks_of_map(port_map, ctx.device)
        oracle = oracle.astype(np.int64)
        stage.add_match(*compare.match(oracle, None, lab, None,
                                       everywhere)[:2])
        spare.add_match(*compare.match(lab, None, oracle, None,
                                       everywhere)[:2])
        ref_masks, _ = masks_of_map(ref_map, ctx.device)
        reading.add_match(*compare.match(ref_masks.astype(np.int64), None,
                                         lab, None, everywhere)[:2])
    common.log(f"readings (not compared) {{'inst_miss': {reading.miss()}, "
               f"'ref_nuclei': {reading.counted}, "
               f"'pp_nuclei': {stage.counted}, "
               f"'json_nuclei': {spare.counted}}}")
    return {"map_err": [maps.map_err(), limits["map_err"]],
            "pp_miss": [stage.miss(), limits["pp_miss"]],
            "pp_extra": [spare.miss(), limits["pp_extra"]]}


def control_checks(ctx, wts: str, rounding: str = "fp8") -> dict:
    """{name: [value, limit]}: the reference under `rounding` in the
    program's place against the float32 reference, on the tiles a run
    with the seed checks, each number beside the cell's limit."""
    from ..reference.cellpose_sam import CellposeReference, masks_of_map

    ref = CellposeReference(ctx.cfg, wts, ctx.device)
    ctl = CellposeReference(ctx.cfg, wts, ctx.device, rounding=rounding)
    imgs = paint_tiles(ctx)
    seq, _, check_idx = plan(ctx)
    maps, reading = _Sums(), _Sums()
    for i in check_idx:
        img = imgs[seq[i]]
        ref_map, ctl_map = ref.tile(img), ctl.tile(img)
        maps.add_maps(ctl_map, ref_map)
        ref_masks, _ = masks_of_map(ref_map, ctx.device)
        ctl_masks, _ = masks_of_map(ctl_map, ctx.device)
        reading.add_match(*compare.match(
            ref_masks.astype(np.int64), None, ctl_masks.astype(np.int32),
            None, np.ones(img.shape[:2], bool))[:2])
    common.log(f"readings (not compared) {{'inst_miss': {reading.miss()}, "
               f"'ref_nuclei': {reading.counted}}}")
    return {"map_err": [maps.map_err(), ctx.cell["limits"]["map_err"]]}


def skip_flow_error():
    """The planted fault of `--fault skip_flow_error`: the program's
    flow-error check drops no mask (Cellpose's `remove_bad_flow_masks`
    left out), so the json keeps masks that Cellpose drops."""
    import torch

    from hover_net_tpu_torch.ops import flow_dynamics

    def kept(masks, flows, n):
        return masks, torch.zeros((), dtype=torch.int64, device=masks.device)

    flow_dynamics.remove_bad_flow_masks = kept


def main(argv=None):
    p = argparse.ArgumentParser("benchmark.traffic.tile_cellpose")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--rounding", default="fp8", choices=("fp8", "bf16"))
    p.add_argument("--fault", default=None, choices=("skip_flow_error",))
    p.add_argument("--seconds", type=float, default=8.0,
                   help="the window of a run with --fault")
    args = p.parse_args(argv)
    common.setup_env()
    from .. import run

    if args.fault:
        skip_flow_error()
    for seed in args.seeds:
        t0 = time.perf_counter()
        ctx = run.make_context(argparse.Namespace(
            workload=args.workload, seed=seed,
            seconds=args.seconds if args.fault else 0, trace=0))
        if args.fault:
            res = run.execute(ctx)
            checks = {k: [v["value"], v["limit"]]
                      for k, v in res["checks"].items()}
            correct = res["correct"]
        else:
            checks = control_checks(ctx, weights(ctx), args.rounding)
            correct = run.judge(checks)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "fault": args.fault,
                          "rounding": None if args.fault else args.rounding,
                          "correct": correct,
                          "checks": {k: {"value": v, "limit": lim}
                                     for k, (v, lim) in checks.items()},
                          "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
