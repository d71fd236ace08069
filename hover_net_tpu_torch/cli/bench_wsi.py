"""WSI throughput on a synthetic pseudo-slide, on one CUDA card.

Counterpart of scripts/bench_wsi.py. Paints an H&E-like `--size`^2 slide
of disk nuclei (bench's `synth_nuclei_image`, seed 7, one nucleus per
850 px) with a full tissue mask, runs the whole WSI pipeline
(`WSIInferManager.process_wsi_list`: chunked inference, the 3-phase
post-processing, the json) and prints Mpx/s:

    python -m hover_net_tpu_torch.cli.bench_wsi [--size 8000]
    python -m hover_net_tpu_torch.cli.bench_wsi --device cpu --width 8 \
        --size 700 --chunk_shape 512 --tile_shape 256 --model_path m.tar

The forward uses the trained checkpoint of cli/bench.py (trained and
cached at the first run). The old `slide.json` is removed before the run
(resume would skip the slide); the painted slide is kept in `--workdir`
and reused. On a card the encoder's d0..d2 run as kernel K3, as in the
WSI CLI (`infer/steps._use_fused_enc`); `main` inside
`steps.standard_encoder()` runs the standard encoder instead.
`--force_striped` runs the striped mesh path on two slots of the one
device (`devices=[device] * 2`), which prices the striping against the
single-device path. The JSON line adds the slide's `timings` (inference
and each post-processing phase), the forward and window batches, and the
launches of K1 and K3 in the run; any failure raises.
"""

from __future__ import annotations

import argparse
import json
import logging
import os
import time
from typing import Optional, Sequence

import cv2
import numpy as np
import torch

from ..infer.base import resolve_device
from ..ops.fused_block_cuda import fused_block_apply
from ..ops.post_proc_cuda import proc_tail
from .bench import BENCH_DIR, add_common_args, card_line, resolve_checkpoint
from .bench import synth_nuclei_image


def paint_slide(workdir: str, n: int):
    """(slide dir, mask dir) holding slide.npy and slide.png, painted once
    per size."""
    slide_dir = os.path.join(workdir, "in")
    mask_dir = os.path.join(workdir, "mask")
    os.makedirs(slide_dir, exist_ok=True)
    os.makedirs(mask_dir, exist_ok=True)
    slide_path = os.path.join(slide_dir, "slide.npy")
    meta = os.path.join(workdir, "slide_size.txt")
    painted = os.path.exists(slide_path) and os.path.exists(meta)
    if painted:
        with open(meta) as f:
            painted = f.read() == str(n)
    if not painted:
        print(f"# painting a {n}^2 slide", flush=True)
        img, _ = synth_nuclei_image(n, n, seed=7, n_nuclei=n * n // 850)
        np.save(slide_path, img)
        cv2.imwrite(os.path.join(mask_dir, "slide.png"),
                    np.full((n // 64, n // 64), 255, np.uint8))
        with open(meta, "w") as f:
            f.write(str(n))
    return slide_dir, mask_dir


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_common_args(ap)
    ap.add_argument("--size", type=int, default=8000)
    ap.add_argument("--workdir", default=os.path.join(BENCH_DIR, "wsi"))
    ap.add_argument("--n_devices", type=int, default=1)
    ap.add_argument("--chunk_shape", type=int, default=4096)
    ap.add_argument("--tile_shape", type=int, default=2048)
    ap.add_argument("--ambiguous_size", type=int, default=128)
    ap.add_argument("--hbm_pred_budget", type=int, default=4 << 30,
                    help="bytes of device memory for the resident pred map; "
                    "0 forces the mmap path")
    ap.add_argument("--force_striped", action="store_true",
                    help="run the striped mesh path on two slots of the one "
                    "device")
    args = ap.parse_args(argv)
    logging.basicConfig(level=logging.INFO, format="%(asctime)s %(message)s")
    from ..infer.wsi import WSIInferManager

    dev = resolve_device(args.device)
    card = card_line(dev)
    print(f"# {card}", flush=True)
    n = args.size
    slide_dir, mask_dir = paint_slide(args.workdir, n)
    ckpt = resolve_checkpoint(args)
    devices = dict(devices=[dev] * 2) if args.force_striped else dict(
        device=dev, n_devices=args.n_devices)
    mgr = WSIInferManager(
        model_path=ckpt, mode="fast", nr_types=None, width=args.width,
        batch_size=32, dtype=torch.bfloat16,
        chunk_shape=args.chunk_shape, tile_shape=args.tile_shape,
        ambiguous_size=args.ambiguous_size, proc_mag=40,
        cache_path=os.path.join(args.workdir, "cache"),
        hbm_pred_budget=args.hbm_pred_budget, **devices)
    out_dir = os.path.join(args.workdir, "out")
    out_json = os.path.join(out_dir, "slide.json")
    if os.path.exists(out_json):
        os.remove(out_json)  # a fresh run: resume would skip the slide
    k1, k3 = proc_tail.launches, fused_block_apply.launches
    t0 = time.perf_counter()
    written = mgr.process_wsi_list(slide_dir, out_dir, input_mask_dir=mask_dir)
    dt = time.perf_counter() - t0
    if written != 1 or not os.path.exists(out_json):
        raise RuntimeError(f"bench_wsi: the slide was not written "
                           f"({written} written; see the log above)")
    with open(out_json) as f:
        nuc = json.load(f)["nuc"]
    mpx = n * n / 1e6
    out = {
        "metric": "wsi_mpx_per_sec_per_chip",
        "value": mpx / dt, "unit": "Mpx/s",
        "wall_s": dt, "n_nuclei": len(nuc),
        "path": ("striped" if len(mgr.devices) > 1
                 else "mmap" if args.hbm_pred_budget == 0 else "auto"),
        "fused_enc": fused_block_apply.launches > k3,
        "timings": mgr.timings["slide"],
        "n_forward_batches": mgr.n_forward_batches,
        "n_window_batches": mgr.n_window_batches,
        "k1_launches": proc_tail.launches - k1,
        "k3_launches": fused_block_apply.launches - k3,
        "size": n, "chunk_shape": args.chunk_shape, "width": args.width,
        "device": str(dev), "card": card,
    }
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
