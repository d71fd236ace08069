"""The device post-processing's drift from the host oracle, over trained-
checkpoint tiles, on one CUDA card.

Counterpart of scripts/parity_drift_sweep.py. N synthetic nuclei tiles
(`synth_nuclei_image` of 200..2400 nuclei, seeds from rng 2024) each run
through ONE forward of the tile pipeline (fast, bf16, the trained
checkpoint of cli/recipe.py), and the stitched prediction map is
post-processed twice:

  (a) by the host oracle, `ops/post_proc_host.proc_np_hv` (cv2, scipy and
      the priority-flood watershed: the reference algorithm), and
  (b) by the device path the tile pipeline runs (the energy and K1),

and each tile's AJI and instance-count change between the two are
reported, with their distribution and the JAX package's record of the
same sweep on a TPU beside them (an AJI record, not a time):

    python -m hover_net_tpu_torch.cli.parity_drift_sweep [--n 50]
    python -m hover_net_tpu_torch.cli.parity_drift_sweep --device cpu \
        --width 8 --size 300 --n 2 --model_path m.tar

Writes the per-tile rows to `--csv` and one JSON line last.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from typing import Optional, Sequence

import numpy as np
import torch

from ..infer.base import resolve_device
from ..metrics.stats import get_fast_aji, remap_label
from ..ops.post_proc_host import proc_np_hv
from .recipe import (
    BENCH_DIR,
    add_common_args,
    card_line,
    checkpoint_sha256,
    e2e_manager,
    resolve_checkpoint,
    synth_nuclei_image,
)

# the JAX package's sweep of 50 tiles on a TPU v5 lite
# (scripts/parity_drift_sweep_r5_tpu.csv): AJI mean and min
TPU_RECORD = {"source": "scripts/parity_drift_sweep_r5_tpu.csv",
              "n_tiles": 50, "aji_mean": 0.981, "aji_min": 0.960}


def pair_aji(a: np.ndarray, b: np.ndarray) -> float:
    """AJI of two label maps of any id range (`get_fast_aji` on the
    remapped maps): 1 when both are empty, 0 when one is."""
    a, b = remap_label(np.asarray(a)), remap_label(np.asarray(b))
    na, nb = int(a.max()), int(b.max())
    if na == 0 or nb == 0:
        return float(na == nb)
    return float(get_fast_aji(a, b))


def summarize(ajis, deltas, counts) -> dict:
    """The distribution of per-tile AJIs and count changes (|a - b|,
    also relative to the first map's count)."""
    ajis, deltas = np.asarray(ajis, float), np.abs(np.asarray(deltas))
    rel = deltas / np.maximum(np.asarray(counts), 1)
    return {"aji_mean": float(ajis.mean()),
            "aji_p5": float(np.percentile(ajis, 5)),
            "aji_min": float(ajis.min()),
            "count_delta_mean": float(deltas.mean()),
            "count_delta_max": int(deltas.max()),
            "count_rel_delta_max": float(rel.max())}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_common_args(ap)
    ap.add_argument("--n", type=int, default=50)
    ap.add_argument("--size", type=int, default=1000)
    ap.add_argument("--csv", default=os.path.join(BENCH_DIR,
                                                  "parity_drift_sweep.csv"))
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = card_line(dev)
    print(f"# {card}", flush=True)
    ckpt = resolve_checkpoint(args)
    mgr = e2e_manager(ckpt, width=args.width, dtype=torch.bfloat16,
                      device=dev)

    rng = np.random.default_rng(2024)
    rows = []
    t0 = time.perf_counter()
    for k in range(args.n):
        # sparse to crowded tiles: crowding is where ties matter
        n_nuc = int(rng.integers(200, 2400))
        img, _ = synth_nuclei_image(args.size, args.size,
                                    seed=int(rng.integers(1 << 30)),
                                    n_nuclei=n_nuc)
        dev_out, _ = mgr.predict_image_async(img)
        pred_map, inst_dev, _ = mgr.finalize_prediction(img, dev_out)
        inst_host = remap_label(proc_np_hv(pred_map))  # the same map
        inst_dev = remap_label(inst_dev)
        n_h, n_d = int(inst_host.max()), int(inst_dev.max())
        rows.append((k, n_nuc, n_h, n_d, pair_aji(inst_host, inst_dev)))
        print(f"# tile {k}: nuclei {n_h} (host) vs {n_d} (device), AJI "
              f"{rows[-1][4]:.4f} ({time.perf_counter() - t0:.0f}s)",
              file=sys.stderr, flush=True)
    os.makedirs(os.path.dirname(os.path.abspath(args.csv)), exist_ok=True)
    with open(args.csv, "w") as f:
        f.write("tile,n_painted,n_host,n_device,aji\n")
        for r in rows:
            f.write(",".join(str(v) for v in r) + "\n")
    out = {"n_tiles": args.n, "tile_size": args.size}
    out.update(summarize([r[4] for r in rows], [r[3] - r[2] for r in rows],
                         [r[2] for r in rows]))
    out.update(tpu_record=TPU_RECORD, csv=args.csv,
               checkpoint_sha256=checkpoint_sha256(ckpt), width=args.width,
               device=str(dev), card=card)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
