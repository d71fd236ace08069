"""Stage split of the post-processing tail K1, through its ablation
variants K4.

Counterpart of scripts/probe_pp_stages.py. Each variant of
`post_proc_cuda.proc_tail` leaves one stage out (`skip`), and the cost of
a stage is t(full) - t(without it):

    python -m hover_net_tpu_torch.cli.probe_pp_stages --size 1000
    python -m hover_net_tpu_torch.cli.probe_pp_stages --size 164 --device cpu

The input is the JAX probe's: the canonical fast-mode canvas of a
`--size`^2 source tile (1148^2 for 1000^2), covered by the JAX bench's
synthetic prediction map (1200 discs of radius 5-10, seed 0), with the
valid mask over the source and the masked min-max Sobel energy
(`post_proc_device.energy_inputs`). Two differences from the JAX probe:
each variant is timed with CUDA events (median of REPS calls after a
warm-up call) in place of the lax.scan K-delta harness, and the blur
reflects at the map edge as K1 does, where the TPU probe filled zeros.
On `--device cpu` the plain version runs and the times are host-clock
times of the plain PyTorch code, not of any kernel.
"""

from __future__ import annotations

import argparse
import statistics
import time
from typing import Dict, Optional, Sequence

import torch

from ..data.tiling import bucket_grid_dim, prepare_tile_patching
from ..ops.post_proc_cuda import SKIPS, proc_tail
from ..ops.post_proc_device import energy_inputs
from .recipe import synth_pred_map

WINDOW, STEP = 256, 164  # fast mode's patch input and output
REPS = 20  # timed calls per variant


def canvas_inputs(size: int, device) -> tuple:
    """(blb, sob) [1, H, W] of the canonical canvas of a size^2 tile."""
    _, _, grid = prepare_tile_patching((size, size), WINDOW, STEP)
    h = w = bucket_grid_dim(grid[0]) * STEP
    pred = torch.from_numpy(synth_pred_map(h, w))[None].to(device)
    valid = torch.zeros((1, h, w), dtype=torch.bool, device=device)
    valid[:, :size, :size] = True
    return energy_inputs(pred, valid)


def time_variant(blb: torch.Tensor, sob: torch.Tensor, skip: str) -> float:
    """Median ms of `proc_tail(skip=skip)` over REPS calls after one
    warm-up call: CUDA events on the card, the host clock on the CPU."""
    proc_tail(blb, sob, skip=skip)
    times = []
    for _ in range(REPS):
        if blb.device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            proc_tail(blb, sob, skip=skip)
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            proc_tail(blb, sob, skip=skip)
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, float]:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--size", type=int, default=1000,
                    help="side of the source tile (default 1000)")
    ap.add_argument("--device", default="cuda",
                    help="cuda (the kernels, default) or cpu (the plain "
                         "version)")
    args = ap.parse_args(argv)

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("probe_pp_stages: CUDA is not available (pass "
                         "--device cpu to time the plain version)")
    blb, sob = canvas_inputs(args.size, device)
    where = (torch.cuda.get_device_name(device) if device.type == "cuda"
             else "the CPU, plain version")
    print(f"# map {blb.shape[1]}^2, whole map on {where}", flush=True)

    results = {}
    for skip in SKIPS:
        t0 = time.perf_counter()
        results[skip] = time_variant(blb, sob, skip)
        print(f"variant[{skip}]: {results[skip]:.3f} ms  "
              f"({time.perf_counter() - t0:.0f}s)", flush=True)

    full = results["none"]
    print(f"-- watershed total:   {full - results['ws']:.3f} ms")
    # the JAX probe printed t(ws_phase2) - t(ws) as "phase2"; that
    # difference is phase 1, so both phases are printed by name here
    print(f"-- ws phase1 (cost):  {results['ws_phase2'] - results['ws']:.3f}"
          " ms")
    print(f"-- ws phase2 (ties):  {full - results['ws_phase2']:.3f} ms")
    print(f"-- remove_small (2x): {full - results['rmsmall']:.3f} ms")
    print(f"-- fill_holes:        {full - results['fill']:.3f} ms")
    print(f"-- 5x5 opening:       {full - results['open']:.3f} ms")
    print(f"full kernel:          {full:.3f} ms")
    return results


if __name__ == "__main__":
    main()
