"""Offline patch extraction CLI (extract_patches.py parity).

The port's copy of hover_net_tpu/cli/extract_patches.py (same flags,
same output: one [win, win, 3+1(+1)] .npy per window).

  python -m hover_net_tpu_torch.cli.extract_patches \
      --dataset consep --with_type \
      --img_dir CoNSeP/Train/Images --img_ext .png \
      --ann_dir CoNSeP/Train/Labels \
      --out_dir patches/consep/train \
      --win_size 540 --step_size 164
"""

from __future__ import annotations

import argparse
import glob
import os
import pathlib

import numpy as np
import tqdm


def main(argv=None):
    p = argparse.ArgumentParser("hover_net_tpu_torch.extract_patches")
    p.add_argument("--dataset", default="consep")
    p.add_argument("--with_type", action="store_true")
    p.add_argument("--img_dir", required=True)
    p.add_argument("--img_ext", default=".png")
    p.add_argument("--ann_dir", required=True)
    p.add_argument("--out_dir", required=True)
    p.add_argument("--win_size", type=int, default=540)
    p.add_argument("--step_size", type=int, default=164)
    p.add_argument("--mode", default="mirror", choices=["mirror", "valid"])
    args = p.parse_args(argv)

    from ..data.datasets import get_dataset
    from ..data.patch_extract import extract_patches

    parser = get_dataset(args.dataset)
    os.makedirs(args.out_dir, exist_ok=True)

    files = sorted(glob.glob(f"{args.img_dir}/*{args.img_ext}"))
    assert files, f"no images under {args.img_dir}"
    for path in tqdm.tqdm(files, ascii=True):
        base = pathlib.Path(path).stem
        img = parser.load_img(path)
        ann = parser.load_ann(f"{args.ann_dir}/{base}.mat", args.with_type)
        patches = extract_patches(
            img, ann, (args.win_size,) * 2, (args.step_size,) * 2, args.mode
        )
        for idx, patch in enumerate(patches):
            np.save(f"{args.out_dir}/{base}_{idx:03d}.npy", patch)


if __name__ == "__main__":
    main()
