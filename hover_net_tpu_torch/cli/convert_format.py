"""Batch re-export of existing inference JSONs to QuPath TSVs.

The port's counterpart of hover_net_tpu/cli/convert_format.py, with the
same flags, and like it of the reference's `convert_format.py:53-102`
driver: walk a directory of `<name>.json` outputs (tile or WSI runs),
rescale coordinates by `--scale_factor` (e.g. back to the slide's lv0
magnification), and write one QuPath v0.2.3 TSV per json.

Usage:
    python -m hover_net_tpu_torch.cli.convert_format \
        --json_dir out/json --output_dir out/qupath \
        --type_info_path type_info.json --scale_factor 1.0
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import pathlib

import numpy as np

from ..infer.base import load_type_info
from ..utils.qupath import to_qupath


def convert_json_dir(json_dir: str, output_dir: str, type_info,
                     scale_factor: float = 1.0) -> int:
    """Re-export every json in `json_dir`; returns the file count."""
    if 0 not in type_info and None in type_info:
        # untyped runs store type=None per nucleus; map them to the
        # no-label entry
        type_info = dict(type_info)
        type_info[0] = type_info[None]
    os.makedirs(output_dir, exist_ok=True)
    paths = sorted(glob.glob(f"{json_dir}/*.json"))
    for path in paths:
        with open(path) as f:
            payload = json.load(f)
        nuc = payload["nuc"] if "nuc" in payload else payload
        cents, types = [], []
        for info in nuc.values():
            c = np.asarray(info["centroid"], np.float64) * scale_factor
            cents.append(c.astype(np.int32))
            types.append(int(info.get("type") or 0))
        name = pathlib.Path(path).stem
        to_qupath(
            f"{output_dir}/{name}.tsv",
            np.asarray(cents, np.int32).reshape(-1, 2),
            np.asarray(types, np.int64),
            type_info,
        )
    return len(paths)


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--json_dir", required=True,
                   help="directory of <name>.json inference outputs")
    p.add_argument("--output_dir", default=None,
                   help="TSV destination (default: json_dir)")
    p.add_argument("--scale_factor", type=float, default=1.0,
                   help="multiply coordinates (e.g. proc-mag -> lv0)")
    p.add_argument("--type_info_path", default=None)
    p.add_argument("--nr_types", type=int, default=0)
    args = p.parse_args(argv)

    type_info = load_type_info(args.type_info_path, args.nr_types or None)
    n = convert_json_dir(
        args.json_dir, args.output_dir or args.json_dir, type_info,
        args.scale_factor,
    )
    print(f"converted {n} json file(s)")


if __name__ == "__main__":
    main()
