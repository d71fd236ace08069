"""The CoNSeP evaluation recipe of the port, in one process.

Counterpart of scripts/eval_consep.sh: typed tile inference over the test
images (cli/run_infer), the ground-truth `.mat` files with CoNSeP's type
merge (`prepare_truth`), then cli/compute_stats in instance mode (DICE,
AJI, DQ, SQ, PQ, AJI+) and type mode (F1_d, accuracy, F1 of each type).

  python -m hover_net_tpu_torch.cli.eval_consep <consep_root> <ckpt> \
      <out_dir> [mode] [width] [--device cuda]

`consep_root` holds Test/Images/*.png and Test/Labels/*.mat (the CoNSeP
download's layout); the checkpoint is a reference-format `.tar` such as
the published hovernet_original_consep_type_tf2pytorch.tar, or a
`.msgpack` the JAX package's trainer wrote, each read directly; `mode`
is `original` (the published checkpoint's, default) or `fast`; `width`
64 is the reference model. It runs on the card unless
`--device cpu` is given. Writes `out_dir/{json,mat,overlay}` and the
merged truth under `out_dir/true`, and prints both metric lines.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def prepare_truth(lbl_dir: str, dst: str) -> None:
    """Write the ground truth that compute_stats reads: each `.mat` of
    `lbl_dir` with its `inst_map` and, where it has a `type_map`, the map
    merged as CoNSeP merges it ({3, 4} -> 3, {5, 6, 7} -> 4, so 5 classes
    with background) and each instance's centroid (x, y) and majority
    type. A copy of the heredoc of scripts/eval_consep.sh:51-83."""
    import scipy.io as sio

    os.makedirs(dst, exist_ok=True)
    for name in sorted(os.listdir(lbl_dir)):
        if not name.endswith(".mat"):
            continue
        m = sio.loadmat(os.path.join(lbl_dir, name))
        inst = m["inst_map"].astype(np.int32)
        out = {"inst_map": inst}
        if "type_map" in m:
            t = m["type_map"].astype(np.int32)
            t[(t == 3) | (t == 4)] = 3
            t[(t == 5) | (t == 6) | (t == 7)] = 4
            out["type_map"] = t
            ids = np.unique(inst)[1:]
            cents, types = [], []
            for i in ids:
                ys, xs = np.nonzero(inst == i)
                cents.append((xs.mean(), ys.mean()))
                vals, cnts = np.unique(t[ys, xs], return_counts=True)
                types.append(int(vals[np.argmax(cnts)]))
            out["inst_centroid"] = np.asarray(cents, np.float64).reshape(-1, 2)
            out["inst_type"] = np.asarray(types, np.int32).reshape(-1, 1)
        sio.savemat(os.path.join(dst, name), out)
    print(f"prepared ground truth: {dst}")


def build_parser():
    p = argparse.ArgumentParser("hover_net_tpu_torch.eval_consep")
    p.add_argument("consep_root",
                   help="directory holding Test/Images and Test/Labels")
    p.add_argument("checkpoint",
                   help="reference-format .tar or JAX .msgpack checkpoint")
    p.add_argument("out_dir")
    p.add_argument("mode", nargs="?", default="original",
                   choices=["original", "fast"])
    p.add_argument("width", nargs="?", type=int, default=64)
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (cuda, cuda:1, cpu)")
    return p


def main(argv=None):
    """Runs the recipe; returns {"manager": the tile manager, "instance":
    the per-image instance metrics, "type": the type metrics}."""
    from . import compute_stats, run_infer

    args = build_parser().parse_args(argv)
    img_dir = os.path.join(args.consep_root, "Test", "Images")
    lbl_dir = os.path.join(args.consep_root, "Test", "Labels")
    for d in (img_dir, lbl_dir):
        if not os.path.isdir(d):
            sys.exit(f"missing {d}")
    os.makedirs(args.out_dir, exist_ok=True)

    # CoNSeP's merged types: 4 classes + background
    mgr = run_infer.main([
        "--model_path", args.checkpoint, "--model_mode", args.mode,
        "--nr_types", "5", "--width", str(args.width),
        "--type_info_path", os.path.join(REPO, "type_info.json"),
        "--device", args.device,
        "tile", "--input_dir", img_dir, "--output_dir", args.out_dir])
    true_dir = os.path.join(args.out_dir, "true")
    prepare_truth(lbl_dir, true_dir)
    pred_dir = os.path.join(args.out_dir, "mat")
    print("== instance metrics (DICE, AJI, DQ, SQ, PQ, AJI+) ==", flush=True)
    inst = compute_stats.main(["--mode", "instance", "--pred_dir", pred_dir,
                               "--true_dir", true_dir])
    print("== type metrics (F1_det, F1 per type w=[2,2,1,1]) ==", flush=True)
    typ = compute_stats.main(["--mode", "type", "--pred_dir", pred_dir,
                              "--true_dir", true_dir])
    return {"manager": mgr, "instance": inst, "type": typ}


if __name__ == "__main__":
    main()
