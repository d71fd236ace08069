"""Instance drift of the fused-block encoder (K3) from the standard forward,
with trained weights, on one CUDA card.

Counterpart of scripts/fused_encoder_drift.py. The parity sweep
(cli/parity_drift_sweep.py) post-processes one forward's output two ways,
so an encoder change cancels out of it; this isolates the encoder. The
same tile runs through the tile CLI's pipeline (`TileInferManager`, fast,
the recipe checkpoint of cli/recipe.py) with the bf16 standard encoder
(cuDNN, `steps.standard_encoder()`) and with the default one
(`models/encoder_fused.fused_encode`: d0..d2 as K3, BatchNorm folded into
scale and offset pairs); both stitched maps go through the same
post-processing (the energy and K1), and the two label maps are scored
against each other by AJI and count. The tile also runs the standard
forward in float32 (TF32 off), and the bf16 standard forward is scored
against it: the bf16 floor that K3's drift is read against.

    python -m hover_net_tpu_torch.cli.fused_encoder_drift [--n 20]
    python -m hover_net_tpu_torch.cli.fused_encoder_drift --device cpu \
        --width 8 --size 300 --n 2 --model_path m.tar

The tiles are `synth_nuclei_image`s of 200..2400 nuclei (seeds from rng
5), as in the JAX script. One difference: the JAX script zero-pads each
tile to its canonical canvas and post-processes the crop, where this
runs the tile CLI's own pipeline (reflect padding, the min-max over the
valid mask). With the trained checkpoint on the H100 the zero-padded way
kept 5-7 nuclei a tile in all three forwards, where the pipeline finds
hundreds: the black padding is far outside what the net was trained on.
On the CPU the gate keeps the standard forward (K3 runs on a GPU only),
so there the K3 pair reads 1. The JSON line, last, holds K3 against the
standard bf16 forward, the floor, and K3 against float32, and the K3
launches of the fused passes beside their forward batches (K3 runs 4
times a batch, so `k3_launches` = 4 * `fused_forward_batches` shows that
every fused pass ran K3; 0 where the gate keeps the standard forward).
"""

from __future__ import annotations

import argparse
import json
import sys
from typing import Optional, Sequence

import numpy as np
import torch

from ..infer.base import resolve_device
from ..infer.steps import standard_encoder
from ..ops.fused_block_cuda import fused_block_apply
from .recipe import (
    add_common_args,
    card_line,
    checkpoint_sha256,
    e2e_manager,
    resolve_checkpoint,
    synth_nuclei_image,
)
from .parity_drift_sweep import pair_aji, summarize

PAIRS = {"fused_vs_standard": ("standard", "fused"),
         "floor_standard_vs_float32": ("float32", "standard"),
         "fused_vs_float32": ("float32", "fused")}


def tile_labels(mgr, img, fused: bool = False) -> np.ndarray:
    """The tile's label map through the manager's pipeline, its encoder
    standard or, where the gate allows it (a CUDA device, bf16, 4 * width
    a multiple of 128), fused (K3)."""
    with standard_encoder(not fused):
        dev_out, _ = mgr.predict_image_async(img)
    return mgr.finalize_prediction(img, dev_out, pull_pred_map=False)[1]


def count_forward_batches(mgr):
    """[n]: n grows by one at each forward batch of `mgr`'s model (d3
    runs once a batch in the standard and in the fused forward)."""
    n = [0]

    def hook(*_):
        n[0] += 1

    for dev in mgr.devices:
        mgr.model_on(dev).d3.register_forward_hook(hook)
    return n


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_common_args(ap)
    ap.add_argument("--n", type=int, default=20)
    ap.add_argument("--size", type=int, default=1000)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = card_line(dev)
    print(f"# {card}", flush=True)
    ckpt = resolve_checkpoint(args)
    mgrs = {dtype: e2e_manager(ckpt, width=args.width, dtype=dtype, device=dev)
            for dtype in (torch.bfloat16, torch.float32)}

    rng = np.random.default_rng(5)
    scores = {k: ([], [], []) for k in PAIRS}
    batches = count_forward_batches(mgrs[torch.bfloat16])
    k3_launches = fused_batches = 0
    for i in range(args.n):
        n_nuclei = int(rng.integers(200, 2400))
        img, _ = synth_nuclei_image(args.size, args.size,
                                    seed=int(rng.integers(1 << 30)),
                                    n_nuclei=n_nuclei)
        maps = {"standard": tile_labels(mgrs[torch.bfloat16], img)}
        k3, nb = fused_block_apply.launches, batches[0]
        maps["fused"] = tile_labels(mgrs[torch.bfloat16], img, fused=True)
        k3_launches += fused_block_apply.launches - k3
        fused_batches += batches[0] - nb
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            maps["float32"] = tile_labels(mgrs[torch.float32], img)
        counts = {k: len(np.unique(v[v > 0])) for k, v in maps.items()}
        line = []
        for name, (a, b) in PAIRS.items():
            aji = pair_aji(maps[a], maps[b])
            for lst, v in zip(scores[name], (aji, counts[b] - counts[a],
                                             counts[a])):
                lst.append(v)
            line.append(f"{name} {aji:.4f}")
        print(f"# tile {i}: nuclei " + ", ".join(
            f"{k} {v}" for k, v in counts.items()) + "; AJI " +
            ", ".join(line), file=sys.stderr, flush=True)

    out = {"n_tiles": args.n, "tile_size": args.size,
           "k3_launches": k3_launches, "fused_forward_batches": fused_batches}
    for name, (ajis, deltas, counts) in scores.items():
        out[name] = summarize(ajis, deltas, counts)
    out.update(checkpoint_sha256=checkpoint_sha256(ckpt), width=args.width,
               device=str(dev), card=card)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
