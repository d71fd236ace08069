"""Dry run of the CoNSeP evaluation recipe (cli/eval_consep) on synthetic
stand-ins.

Counterpart of scripts/eval_consep_dryrun.py: writes a miniature
CoNSeP-layout dataset (Test/Images/*.png and Test/Labels/*.mat with
inst_map and type_map in the raw type ids 1..7, the JAX dryrun's seed,
sizes and layout), a seeded width-8 model of the port saved as a `.tar`,
then runs cli/eval_consep end to end on them at width 8, in fast mode
unless `--mode original` is given. The day the CoNSeP test set and the
published checkpoint are at hand, the same recipe reproduces the
reference README table:

    python -m hover_net_tpu_torch.cli.eval_consep <consep_root> \
        hovernet_original_consep_type_tf2pytorch.tar out/

Run:  python -m hover_net_tpu_torch.cli.eval_consep_dryrun [workdir]
          [--mode fast|original] [--device cuda]
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np


def build_standins(root, n_images=2, size=180, seed=0):
    """`n_images` RGB tiles of `size`^2 with 25 disc nuclei each, and
    their labels with raw CoNSeP type ids 1..7, under root/Test."""
    import cv2
    import scipy.io as sio

    rng = np.random.default_rng(seed)
    img_dir = os.path.join(root, "Test", "Images")
    lbl_dir = os.path.join(root, "Test", "Labels")
    os.makedirs(img_dir, exist_ok=True)
    os.makedirs(lbl_dir, exist_ok=True)
    yy, xx = np.mgrid[-10:11, -10:11]
    for i in range(n_images):
        img = np.full((size, size, 3), 225, np.float32)
        img += rng.normal(0, 4, img.shape)
        inst = np.zeros((size, size), np.int32)
        tmap = np.zeros((size, size), np.int32)
        k = 1
        for _ in range(25):
            cy = int(rng.integers(12, size - 12))
            cx = int(rng.integers(12, size - 12))
            r = int(rng.integers(4, 9))
            m = (yy**2 + xx**2) <= r * r
            sub = inst[cy - 10 : cy + 11, cx - 10 : cx + 11]
            tsub = tmap[cy - 10 : cy + 11, cx - 10 : cx + 11]
            paint = m & (sub == 0)
            sub[paint] = k
            tsub[paint] = int(rng.integers(1, 8))  # raw CoNSeP ids 1..7
            k += 1
            col = np.array([120, 70, 150]) + rng.normal(0, 10, 3)
            img[cy - 10 : cy + 11, cx - 10 : cx + 11][m] = col
        cv2.imwrite(
            os.path.join(img_dir, f"test_{i}.png"),
            cv2.cvtColor(np.clip(img, 0, 255).astype(np.uint8),
                         cv2.COLOR_RGB2BGR),
        )
        sio.savemat(
            os.path.join(lbl_dir, f"test_{i}.mat"),
            {"inst_map": inst, "type_map": tmap},
        )


def build_checkpoint(path, mode="fast"):
    """A seeded width-8 typed (5 classes) model of the port, saved as a
    reference-format `.tar`."""
    import torch

    from ..models.hovernet import HoVerNet, HoVerNetConfig

    net = HoVerNet(HoVerNetConfig(mode=mode, nr_types=5, width=8),
                   generator=torch.Generator().manual_seed(0))
    torch.save({"desc": net.state_dict()}, path)


def main(argv=None):
    """Runs the dry run; returns what cli/eval_consep.main returns."""
    from . import eval_consep

    p = argparse.ArgumentParser("hover_net_tpu_torch.eval_consep_dryrun")
    p.add_argument("workdir", nargs="?", default=None)
    p.add_argument("--mode", default="fast", choices=["fast", "original"])
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    work = args.workdir or tempfile.mkdtemp(prefix="consep_dryrun_")
    root = os.path.join(work, "CoNSeP")
    out = os.path.join(work, "out")
    ckpt = os.path.join(work, "tiny.tar")
    build_standins(root)
    # width 8: the reference geometry, quick on any device
    build_checkpoint(ckpt, mode=args.mode)
    res = eval_consep.main([root, ckpt, out, args.mode, "8",
                            "--device", args.device])
    print(f"dry run complete: {out}")
    return res


if __name__ == "__main__":
    main()
