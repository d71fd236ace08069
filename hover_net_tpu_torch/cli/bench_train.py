"""Train-step throughput: width-64 fast mode, synthetic patches through the
port's PrefetchLoader, on one CUDA card.

Counterpart of scripts/bench_train.py:

    python -m hover_net_tpu_torch.cli.bench_train [--batch 16] [--steps 30]
    python -m hover_net_tpu_torch.cli.bench_train --real_loader [--loader_only]
    python -m hover_net_tpu_torch.cli.bench_train --device cpu --width 8 \
        --batch 2 --steps 2

The model is the JAX script's: fast mode, untyped, float32 parameters
and Adam state with a bf16 body (`torch.autocast`) and float32 heads and
loss (`make_train_step(autocast_dtype=torch.bfloat16)`), weights from a
seeded `torch.Generator`, Adam 1e-4 with the 25-epoch step schedule. By
default the samples are eight pre-generated 256^2 `synth_nuclei_image`
tiles with their targets, drawn in random batches, so the device step
rate is measured without host augmentation; the line adds ms per step,
the final loss and the peak device memory.

`--real_loader` feeds the step from the port's `TrainLoader` workers
instead (.npy read, the whole augmentation chain, hv targets, collate) on
`--n_patches` synthetic 540^2 patches written once into `--workdir`;
`--loader_only` measures that loader's samples/s alone, with no device.
"""

from __future__ import annotations

import argparse
import json
import os
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..data.train_pipeline import PatchDataset, PrefetchLoader, TrainLoader
from ..infer.base import resolve_device
from ..models.hovernet import HoVerNet, HoVerNetConfig
from ..ops.targets import gen_targets
from ..parallel.train_parallel import (
    init_train_state,
    make_optimizer,
    make_train_step,
)
from .recipe import BENCH_DIR, card_line, synth_nuclei_image


def bf16_trainer(width: int, device, seed: int = 0):
    """(state, step) of the benchmark's model: float32 parameters, a bf16
    autocast body, float32 heads and loss, Adam 1e-4 (25 epochs of 100
    steps, then x0.1)."""
    model = HoVerNet(HoVerNetConfig(mode="fast", nr_types=None, width=width),
                     generator=torch.Generator().manual_seed(seed))
    tx, schedule = make_optimizer(lr=1e-4, step_epochs=25, steps_per_epoch=100)
    state = init_train_state(model, tx, device)
    step = make_train_step(model, schedule, autocast_dtype=torch.bfloat16)
    return state, step


def synchronize(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _peak_gib(device):
    if device.type != "cuda":
        return None
    return torch.cuda.max_memory_allocated(device) / 2**30


def bench_real_loader(args, device):
    """The worker-pool loader's rate: .npy read -> augmentation -> hv
    targets -> collate (-> the device step unless `--loader_only`), at
    the reference shapes (540^2 source patches, 256 -> 164)."""
    pdir = os.path.join(args.workdir, "patches")
    os.makedirs(pdir, exist_ok=True)
    existing = len([f for f in os.listdir(pdir) if f.endswith(".npy")])
    for i in range(existing, args.n_patches):
        img, inst = synth_nuclei_image(540, 540, seed=i, n_nuclei=300)
        np.save(os.path.join(pdir, f"p{i:04d}.npy"),
                np.dstack([img, inst.astype(np.int32)]))

    loader = TrainLoader(
        PatchDataset([pdir]), batch_size=args.batch,
        input_shape=(256, 256), mask_shape=(164, 164), mode="train",
        with_type=False, num_workers=args.workers)
    try:
        n_warm = 0  # warms the pool (the workers' start and imports)
        for b in loader:
            n_warm += b["img"].shape[0]
            if n_warm >= 4 * args.batch:
                break
        if args.loader_only:
            t0 = time.perf_counter()
            n = sum(b["img"].shape[0] for b in loader)
            dt = time.perf_counter() - t0
            return {"metric": "train_loader_samples_per_sec",
                    "value": n / dt, "unit": "samples/s",
                    "workers": args.workers, "batch": args.batch}

        state, step = bf16_trainer(args.width, device)
        for b in PrefetchLoader(loader, device):  # a warm-up step
            state, _ = step(state, b)
            break
        synchronize(device)
        t0 = time.perf_counter()
        n = 0
        for b in PrefetchLoader(loader, device):
            n += b["img"].shape[0]
            state, (terms, _) = step(state, b)
        loss = float(terms["overall_loss"])
        dt = time.perf_counter() - t0
        return {"metric": "train_e2e_samples_per_sec_per_chip",
                "value": n / dt, "unit": "samples/s",
                "workers": args.workers, "batch": args.batch,
                "final_loss": loss, "peak_gib": _peak_gib(device)}
    finally:
        loader.close()


def bench_step(args, device):
    """The device step rate on pre-generated samples."""
    state, step = bf16_trainer(args.width, device)
    samples = []
    for i in range(8):
        img, inst = synth_nuclei_image(256, 256, seed=i, n_nuclei=70)
        t = gen_targets(inst, (164, 164))
        samples.append((img.astype(np.float32), t["np_map"].astype(np.int32),
                        t["hv_map"].astype(np.float32)))
    rng = np.random.default_rng(0)

    def host_batches(n):
        for _ in range(n):
            idx = rng.integers(0, len(samples), args.batch)
            yield {k: np.stack([samples[j][c] for j in idx])
                   for c, k in enumerate(("img", "np_map", "hv_map"))}

    for b in PrefetchLoader(host_batches(2), device):  # warm-up
        state, _ = step(state, b)
    synchronize(device)
    t0 = time.perf_counter()
    for b in PrefetchLoader(host_batches(args.steps), device):
        state, (terms, _) = step(state, b)
    loss = float(terms["overall_loss"])  # waits for the last step
    dt = time.perf_counter() - t0
    if not np.isfinite(loss):
        raise FloatingPointError(f"bench_train: final loss {loss}")
    return {"metric": "train_samples_per_sec_per_chip",
            "value": args.steps * args.batch / dt, "unit": "samples/s",
            "ms_per_step": dt / args.steps * 1e3, "batch": args.batch,
            "steps": args.steps, "final_loss": loss,
            "param_dtype": str(next(state.model.parameters()).dtype),
            "peak_gib": _peak_gib(device)}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu")
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--real_loader", action="store_true",
                    help="feed the step from the worker-pool loader "
                    "(augmentation and targets) instead of pre-generated "
                    "batches")
    ap.add_argument("--loader_only", action="store_true",
                    help="the loader's rate alone (no device)")
    ap.add_argument("--workers", type=int, default=8)
    ap.add_argument("--n_patches", type=int, default=512)
    ap.add_argument("--workdir", default=os.path.join(BENCH_DIR, "train"))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    card = card_line(device)
    print(f"# {card}", flush=True)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    if args.real_loader or args.loader_only:
        out = bench_real_loader(args, device)
    else:
        out = bench_step(args, device)
    out.update(width=args.width, device=str(device), card=card)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
