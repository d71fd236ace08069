"""Training traffic: fine-tuning as `run_train`'s second phase runs it (the
whole model unfrozen, batch 4, float32 with cuDNN's default TF32), its
train step (`parallel/train_parallel.make_train_step`) fed by the real
loader (`TrainLoader` with `nr_procs_train` forkserver workers and the full
augmentation, behind `PrefetchLoader`), step after step as the train
engine drives it, each step's loss terms pulled to the host.

Set-up paints `patches` CoNSeP-like 540^2 patches (image, instance and
type maps, `nuclei_per_patch` nuclei each, from `--seed`) as the .npy
files `extract_patches` writes, loads the configuration's recipe weights
(the second phase starts from trained weights), builds the step,
its optimizer and the loader once, and drives that one object through
`check_steps` steps (whose batches, losses, Adam state and parameters it
keeps for the check) and `warm_steps` more. The window then steps on
until `--seconds` have passed.

- `train_patches_per_s`: the patches stepped in the window over its
  seconds.

`correct` (after the window): the reference follows the first
`check_steps` steps from the same weights on the same batches
(reference/train_ref.py).
"""

from __future__ import annotations

import os
import time

import numpy as np

from .. import common
from ..reference.paint import paint_tile
from ..roofline import patch_flops


def paint_patches(ctx, out_dir: str):
    """The cell's patches as `out_dir/p<k>.npy`, uint8 [S, S, 5]: RGB,
    instance map, type map."""
    cell = ctx.cell
    size, (lo, hi) = cell["patch_size"], cell["nuclei_per_patch"]
    rng = np.random.default_rng(ctx.seed)
    counts = rng.permutation(np.linspace(lo, hi, cell["patches"])
                             .round().astype(int))
    seeds = rng.integers(1 << 62, size=cell["patches"])
    for k in range(cell["patches"]):
        img, inst, tp = paint_tile(size, size, int(counts[k]), int(seeds[k]),
                                   ctx.cfg["nr_types"], with_labels=True,
                                   device=ctx.device)
        if inst.max() > 255:
            raise ValueError("more nuclei than a uint8 patch holds")
        np.save(os.path.join(out_dir, f"p{k:04d}.npy"),
                np.dstack([img, inst, tp]).astype(np.uint8))


def initial_state(ctx) -> dict:
    """The weights the steps start from, on the device: the configuration's
    recipe weights (reference/recipe.py), as the second phase of
    `run_train` starts from the first phase's."""
    import torch

    state = torch.load(ctx.weights(), map_location=ctx.device,
                       weights_only=True)["desc"]
    return {k: v.detach().clone() for k, v in state.items()}


def run(ctx: common.Context) -> dict:
    import torch

    from hover_net_tpu_torch.data.train_pipeline import (
        PatchDataset,
        PrefetchLoader,
        TrainLoader,
    )
    from hover_net_tpu_torch.models.hovernet import HoVerNet, HoVerNetConfig
    from hover_net_tpu_torch.parallel import train_parallel

    cell, cfg = ctx.cell, ctx.cfg
    work = ctx.workdir()
    patches = os.path.join(work, "patches")
    os.makedirs(patches)
    paint_patches(ctx, patches)
    init = initial_state(ctx)

    model = HoVerNet(HoVerNetConfig(mode=cfg["mode"], nr_types=cfg["nr_types"],
                                    width=cfg["width"]))
    model.load_state_dict(init, strict=True)
    batch = cell["batch_size"]
    dataset = PatchDataset([patches])
    loader = TrainLoader(
        dataset, batch_size=batch,
        input_shape=(cfg["patch_input"],) * 2,
        mask_shape=(cfg["patch_output"],) * 2, mode="train",
        with_type=cfg["nr_types"] is not None,
        num_workers=cell["nr_procs_train"], seed=ctx.seed % (1 << 31))
    feed = PrefetchLoader(loader, ctx.device)
    tx, schedule = train_parallel.make_optimizer(
        lr=cell["lr"], step_epochs=cell["lr_step_epochs"],
        steps_per_epoch=max(loader.steps_per_epoch(), 1))
    state = train_parallel.init_train_state(model, tx, ctx.device)
    step = train_parallel.make_train_step(model, schedule,
                                          freeze_encoder=False)

    def batches():
        while True:
            yield from feed

    stream = batches()
    step_s = []

    def one_step():
        nonlocal state
        b = next(stream)
        t0 = time.perf_counter()
        state, (terms, viz) = step(state, b)
        terms = {k: float(v) for k, v in terms.items()}
        step_s.append(time.perf_counter() - t0)
        return b, terms, viz

    try:
        kept, losses = [], []
        params = dict(model.named_parameters())
        for i in range(cell["check_steps"]):
            b, terms, viz = one_step()
            kept.append({k: v.clone() for k, v in b.items()})
            losses.append(terms["overall_loss"])
            if i == 0:
                # the step's own outputs: its first two samples' np
                # probabilities and hv maps
                out1 = {k: viz[k].clone() for k in ("np", "hv")}
                opt_state = state.optimizer.state
                grad1 = {k: (opt_state[p]["exp_avg"] / (1 - 0.9)).clone()
                         for k, p in params.items()}
        params_after = {k: p.detach().clone() for k, p in params.items()}
        for _ in range(cell["warm_steps"]):
            one_step()

        stretch = None
        if ctx.trace:
            from ..trace import Stretch, span

            stretch = Stretch(work)
            step = span("bench.train_step", step)
        traced = range(cell["trace_from_step"],
                       cell["trace_from_step"] + cell["trace_steps"])
        if ctx.device.startswith("cuda"):
            torch.cuda.synchronize()
        setup_s = ctx.elapsed()
        n_wait0, n_step0 = len(feed.wait_s), len(step_s)
        steps = 0
        t_start = time.perf_counter()
        while time.perf_counter() - t_start < ctx.seconds:
            if stretch is not None and steps == traced.start:
                stretch.start()
            one_step()
            steps += 1
            if stretch is not None and steps == traced.stop:
                stretch.stop()
        window_s = time.perf_counter() - t_start
        if stretch is not None and stretch.prof is not None \
                and stretch.host_s is None:
            stretch.stop()
        wait_s = feed.wait_s[n_wait0:]
        window_step_s = step_s[n_step0:]
        device = common.device_info(ctx.device)
    finally:
        feed.close()
    del state, step, model
    common.free_cuda()

    out = {"attempted": steps, "failed": 0, "device": device,
           "e2e": {"setup_s": setup_s,
                   "train_patches_per_s": steps * batch / window_s},
           "checks": check(ctx, init, kept, losses, grad1, params_after,
                           out1)}
    common.log(f"window {window_s:.3f} s, {steps} steps; setup "
               f"{setup_s:.3f} s")
    if stretch is not None:
        summary = stretch.summary()
        out["trace"] = summary
        t0 = traced.start
        out["facts"] = {
            "trace": summary, "steps": min(steps, traced.stop) - t0,
            "wait_s": wait_s[t0:traced.stop],
            "step_s": window_step_s[t0:traced.stop],
            "window_wait_s": wait_s, "window_step_s": window_step_s,
            # a training step: forward and backward, about three forwards
            "flops_per_step": 3 * batch * patch_flops(
                cfg["mode"], cfg["nr_types"], cfg["width"],
                cfg["patch_input"]),
        }
    return out


def check(ctx, init, kept, losses, grad1, params_after, out1) -> dict:
    from ..reference.train_ref import numbers

    res = numbers(ctx.cfg, init, kept, ctx.cell["lr"], ctx.device, losses,
                  grad1, params_after, out1)
    common.log(f"training check: {res}")
    limits = ctx.cell["limits"]
    return {k: [res[k], limits[k]] for k in limits}
