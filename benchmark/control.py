"""The readings that set the limits of `correct`: the low-precision
control, the bf16 witness, and the program's own numbers over many seeds.

    python3 -m benchmark.control --workload <cell> --seeds 1 2 3
    python3 -m benchmark.control --workload <cell> --seeds 1 2 3 --program

Without `--program` it puts the control in the program's place: the
reference forward with every convolution's input and weight rounded to
fp8 (reference/lowp.py; the step below the configurations' bf16 body),
post-processed by the oracle, on the very tiles or slide regions that a
run with that seed checks, against the float32 reference, and judges its
numbers by the cell's limits as a run's are judged (`run.judge`): a
sound limit makes the control's `correct` false. `--rounding bf16` puts
the bf16 witness there instead (the same reference, rounded to the
precision the configuration states), which reads how far bf16 rounding
alone moves the maps.
With `--program` it drives the cell's run for each seed in one process
(short windows, the program's numbers as a run computes them), which
gives the lower readings; `--dtype float32` runs the program's forward in
float32 with TF32 off, the reference's own precision, instead of the
configuration's dtype (a witness beside the bf16 one); `--fault drop_nuclei` plants a fault in the
program (the json loses one nucleus in 20), whose readings bound the
numbers the control does not reach (`pp_miss`). A training cell's
control is the program's own bf16 path (`--program --fault autocast_bf16`)
and its planted fault `half_batch`. One JSON line a seed.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np

from . import common


def control_checks(ctx, weights: str, rounding: str = "fp8") -> dict:
    """{name: [value, limit]}: the reference under `rounding` in the
    program's place against the float32 reference, on the tiles or slide
    regions that a run with the seed checks, each number beside the
    cell's limit."""
    from .reference import compare
    from .reference.infer import Reference

    cfg, cell = ctx.cfg, ctx.cell
    if cell["kind"] == "train":
        raise SystemExit("a training cell's control is the program's bf16 "
                         "path: --program --fault autocast_bf16")
    typed = cfg["nr_types"] is not None
    ref = Reference(cfg, weights, ctx.device)
    ctl = Reference(cfg, weights, ctx.device, rounding=rounding)
    tally = compare.Tally(typed)

    def add(ref_map, ctl_map, interior):
        tally.add_maps(ctl_map, ref_map)
        ref_inst, ref_types = compare.reference_instances(ref_map, typed)
        ctl_inst, ctl_types = compare.reference_instances(ctl_map, typed)
        tally.add_match(*compare.match(ref_inst, ref_types, ctl_inst,
                                       ctl_types, interior))

    if cell["kind"] == "tile":
        from .traffic.tile import paint_tiles, plan

        imgs = paint_tiles(ctx)
        seq, _, check_idx = plan(ctx)
        for i in check_idx:
            img = imgs[seq[i]]
            add(ref.tile(img), ctl.tile(img), np.ones(img.shape[:2], bool))
    else:
        from .reference.geometry import slide_patches
        from .traffic.wsi import checked_slide, draw_regions, paint_one

        img, mask = paint_one(ctx, checked_slide(ctx))
        boxes = slide_patches(img.shape[:2], mask, cell["chunk_shape"],
                              cfg["patch_input"], cfg["patch_output"])
        r, m = cell["check_region"], cell["margin"]
        interior = np.zeros((r, r), bool)
        interior[m:r - m, m:r - m] = True
        for y, x in draw_regions(ctx, mask):
            add(ref.region(img, boxes, (y, x), r),
                ctl.region(img, boxes, (y, x), r), interior)
    limits = cell["limits"]
    return {k: [v, limits[k]] for k, v in tally.numbers().items()}


def drop_nuclei(every: int = 20):
    """The planted fault of `--fault drop_nuclei`: the program's json
    loses every `every`-th nucleus where it is written (an answer altered
    where it is produced)."""
    from hover_net_tpu_torch.infer import base

    save = base.save_json

    def dropped(path, inst_info, mag=None):
        keep = {k: v for i, (k, v) in enumerate(inst_info.items())
                if i % every != every - 1}
        return save(path, keep, mag)

    base.save_json = dropped


def train_fault(kind: str):
    """The training step as the control or a planted fault runs it:
    `autocast_bf16`, the program's own bf16 path (a float32 model under
    bf16 autocast: the control of a float32 cell); `half_batch`, each step
    on the first half of its batch, the mean taken over it."""
    import torch

    from hover_net_tpu_torch.parallel import train_parallel

    make = train_parallel.make_train_step

    def made(*args, **kwargs):
        if kind == "autocast_bf16":
            return make(*args, autocast_dtype=torch.bfloat16, **kwargs)
        step = make(*args, **kwargs)

        def half(state, batch):
            n = next(iter(batch.values())).shape[0] // 2
            return step(state, {k: v[:n] for k, v in batch.items()})

        return half

    train_parallel.make_train_step = made


def main(argv=None):
    p = argparse.ArgumentParser("benchmark.control")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--program", action="store_true")
    p.add_argument("--seconds", type=float, default=8.0)
    p.add_argument("--fault", default=None,
                   choices=("drop_nuclei", "autocast_bf16", "half_batch"))
    p.add_argument("--rounding", default="fp8", choices=("fp8", "bf16"))
    p.add_argument("--dtype", default=None, choices=("float32",))
    args = p.parse_args(argv)
    common.setup_env()
    from . import run

    if args.fault == "drop_nuclei":
        drop_nuclei()
    elif args.fault:
        train_fault(args.fault)
    for seed in args.seeds:
        t0 = time.perf_counter()
        ctx = run.make_context(argparse.Namespace(
            workload=args.workload, seed=seed, seconds=args.seconds,
            trace=0))
        if args.dtype:
            import torch

            ctx.cfg["dtype"] = args.dtype
            torch.backends.cudnn.allow_tf32 = False
            torch.backends.cuda.matmul.allow_tf32 = False
        if args.program:
            res = run.execute(ctx)
            checks = {k: [v["value"], v["limit"]]
                      for k, v in res["checks"].items()}
            correct = res["correct"]
        else:
            checks = control_checks(ctx, ctx.weights(), args.rounding)
            correct = run.judge(checks)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "program": args.program, "fault": args.fault,
                          "rounding": None if args.program else args.rounding,
                          "dtype": ctx.cfg["dtype"], "correct": correct,
                          "checks": {k: {"value": v, "limit": lim}
                                     for k, (v, lim) in checks.items()},
                          "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
