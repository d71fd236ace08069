"""Tile traffic: a lab's 1000^2 fields of view through `run_infer tile
--save_format json`, that is `TileInferManager.process_file_list`.

Set-up paints the cell's `tiles` distinct tiles as png files (nuclei
counts spread evenly over the cell's range, positions and types from
`--seed`), loads the cached recipe weights into the manager and runs one
call over `warm_tiles` of them. The window then drives
`process_file_list` over directories of `tiles_per_call` tiles, back to
back, the tiles cycled in a seeded order, until `--seconds` have passed:
each call keeps the CLI's own in-flight depth (the main thread reads and
dispatches, one worker finalizes and writes the json, three tiles in
flight). The window ends with the last call.

- `tiles_per_s`: tiles whose json was written, over the window's seconds.
- `tile_p95_ms`: the 95th percentile over every tile of the window of the
  time from its read (`cv2.imread`, wrapped to note the time) to its json
  written (the manager's "done" log record).

`correct` (after the window, the manager freed): `check_tiles` tiles drawn
from `--seed` among the first `check_within` of the window. For each, the
program's head map (the stitched map the finalize receives) against the
reference's float32 map; its json nuclei against the oracle's nuclei on
the reference map (printed, not compared); and, by themselves, the program's
post-processing and finalize (energy, K1, tables, contours, json): its
json nuclei against the oracle run on the program's own head map.
"""

from __future__ import annotations

import logging
import os
import pathlib
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from .. import common
from ..reference import compare
from ..reference.geometry import tile_canvas
from ..reference.paint import paint_tile
from ..roofline import patch_flops

LOGGER = "hover_net_tpu_torch"


class _Events(logging.Handler):
    """Notes the host time of each tile's "done" record; passes warnings
    and errors on to standard error."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.done = {}

    def emit(self, record):
        if isinstance(record.msg, str) and record.msg.startswith("done %s"):
            self.done[record.args[0]] = time.perf_counter()
        elif record.levelno >= logging.WARNING:
            common.log(self.format(record))


def paint_tiles(ctx, src=None):
    """The cell's tiles from `--seed` (RGB arrays), written as
    `src/t<k>.png` when `src` is given."""
    import cv2

    cell = ctx.cell
    n, size = cell["tiles"], cell["tile_size"]
    lo, hi = cell["nuclei_per_tile"]
    rng = np.random.default_rng(ctx.seed)
    counts = rng.permutation(np.linspace(lo, hi, n).round().astype(int))
    seeds = rng.integers(1 << 62, size=n)

    def one(k):
        img = paint_tile(size, size, int(counts[k]), int(seeds[k]),
                         ctx.cfg["nr_types"], device=ctx.device)
        if src is not None:
            cv2.imwrite(os.path.join(src, f"t{k:03d}.png"),
                        cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        return img

    with ThreadPoolExecutor(4) as pool:
        return list(pool.map(one, range(n)))


def plan(ctx):
    """(the window's tile sequence, its names, the indices checked), all
    from `--seed`."""
    cell = ctx.cell
    rng = np.random.default_rng([ctx.seed, 1])
    order = rng.permutation(cell["tiles"])
    total = cell["tiles_per_call"] * cell["max_calls"]
    seq = [int(order[i % len(order)]) for i in range(total)]
    names = [f"s{i:05d}_t{k:03d}" for i, k in enumerate(seq)]
    check_idx = sorted(rng.choice(cell["check_within"], cell["check_tiles"],
                                  replace=False).tolist())
    return seq, names, check_idx


def _link_dir(path: str, items):
    """A directory of symlinks named `<name>.png` -> source png, in
    order."""
    os.makedirs(path)
    for name, src in items:
        os.symlink(src, os.path.join(path, f"{name}.png"))


def run(ctx: common.Context) -> dict:
    import cv2
    import torch

    from hover_net_tpu_torch.infer.tile import TileInferManager

    cell, cfg = ctx.cell, ctx.cfg
    work = ctx.workdir()
    weights = ctx.weights()
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
        model_path=weights, mode=cfg["mode"], nr_types=cfg["nr_types"],
        type_info_path=common.write_type_info(ctx), width=cfg["width"],
        dtype=getattr(torch, cfg["dtype"]), batch_size=cfg["batch_size"],
        device=ctx.device)
    mgr.process_file_list(os.path.join(work, "in", "warm"),
                          os.path.join(work, "out", "warm"),
                          save_format="json")
    mgr.timings.clear()

    # taps: the head map of the sampled tiles, and the
    # read time of every tile
    kept, finalized = {}, [0]
    finalize = mgr.finalize_prediction

    def tapped(img, dev_out, *a, **k):
        i = finalized[0]
        finalized[0] += 1
        if i in check_idx:
            kept[i] = dev_out[0]
        return finalize(img, dev_out, *a, **k)

    mgr.finalize_prediction = tapped
    read_at = {}
    imread = cv2.imread

    def timed_imread(path, *a):
        read_at[pathlib.Path(path).stem] = time.perf_counter()
        return imread(path, *a)

    stretch = None
    if ctx.trace:
        from ..trace import Stretch, span

        stretch = Stretch(work)
        mgr.finalize_prediction = span("bench.finalize",
                                       mgr.finalize_prediction)
        mgr._save_outputs = span("bench.save", mgr._save_outputs)
        mgr.predict_image_async = span("bench.dispatch",
                                       mgr.predict_image_async)
        timed_imread = span("bench.read", timed_imread)
    trace_calls = range(cell["trace_from_call"],
                        cell["trace_from_call"] + cell["trace_calls"])
    if ctx.device.startswith("cuda"):
        torch.cuda.synchronize()
    setup_s = ctx.elapsed()

    cv2.imread = timed_imread
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
    lat = [events.done[nm] - read_at[nm] for nm in names[:attempted]
           if nm in events.done and nm in read_at]
    device = common.device_info(ctx.device)
    timings = list(mgr.timings)
    kept = {i: full.float().cpu().numpy() for i, full in kept.items()}
    del mgr, tapped
    logger.removeHandler(events)
    common.free_cuda()

    out = {"attempted": attempted, "failed": attempted - written,
           "device": device,
           "e2e": {"setup_s": setup_s, "tiles_per_s": written / window_s,
                   "tile_p95_ms": float(np.percentile(lat, 95)) * 1e3
                   if lat else None},
           "checks": check(ctx, weights, imgs, seq, names, kept,
                           os.path.join(work, "out"), per_call)}
    common.log(f"window {window_s:.3f} s, {written} tiles in {calls} calls; "
               f"setup {setup_s:.3f} s")
    if stretch is not None:
        summary = stretch.summary()
        size = (cell["tile_size"],) * 2
        win, step = cfg["patch_input"], cfg["patch_output"]
        grid, canvas = tile_canvas(size, win, step)
        out["trace"] = summary
        out["facts"] = {
            "timings": timings, "trace": summary, "tiles": traced_tiles,
            "flops_per_tile": patch_flops(cfg["mode"], cfg["nr_types"],
                                          cfg["width"], win)
            * grid[0] * grid[1],
            "k1_pixels_per_tile": canvas[0] * canvas[1],
        }
    return out


def check(ctx, weights, imgs, seq, names, kept, out_dir, per_call) -> dict:
    """The numbers that decide `correct`, each [value, limit]."""
    from ..reference.infer import Reference
    from ..reference.postproc import proc_np_hv

    typed = ctx.cfg["nr_types"] is not None
    tally = compare.Tally(typed)
    limits = ctx.cell["limits"]
    if len(kept) < ctx.cell["check_tiles"]:
        return {"checked_tiles_missing": [ctx.cell["check_tiles"] - len(kept),
                                          0]}
    ref = Reference(ctx.cfg, weights, ctx.device)
    c = 1 if typed else 0
    for i, port_full in sorted(kept.items()):
        img = imgs[seq[i]]
        h, w = img.shape[:2]
        ref_map = ref.tile(img)
        port_map = port_full[:h, :w]
        tally.add_maps(port_map, ref_map)
        ref_inst, ref_types = compare.reference_instances(ref_map, typed)
        nuc = compare.load_nuclei(os.path.join(
            out_dir, f"c{i // per_call:04d}", "json", f"{names[i]}.json"))
        lab, types = compare.raster(nuc, (0, 0), (h, w))
        everywhere = np.ones((h, w), bool)
        tally.add_match(*compare.match(ref_inst, ref_types, lab, types,
                                       everywhere))
        oracle = proc_np_hv(port_map[..., c:c + 3])
        counted, missed, _ = compare.match(oracle, None, lab, None,
                                           everywhere)
        tally.add_stage(counted, missed)
    common.log(f"readings (not compared) {tally.readings()}")
    return {k: [v, limits[k]] for k, v in tally.numbers().items()}
