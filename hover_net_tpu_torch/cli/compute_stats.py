"""Offline metric CLI (compute_stats.py parity).

Counterpart of hover_net_tpu/cli/compute_stats.py, with the same flags:

  python -m hover_net_tpu_torch.cli.compute_stats --mode instance \
      --pred_dir out/mat --true_dir gt/

`--mode instance` prints the mean [DICE, AJI, DQ, SQ, PQ, AJI+] over the
prediction `.mat` files; `--mode type` prints [F1_d, acc, F1 of each
type] from the centroids and types.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser("hover_net_tpu_torch.compute_stats")
    p.add_argument("--mode", default="instance", choices=["instance", "type"])
    p.add_argument("--pred_dir", default="")
    p.add_argument("--true_dir", default="")
    p.add_argument("--print_img_stats", action="store_true")
    args = p.parse_args(argv)

    from ..metrics.eval import run_nuclei_inst_stat, run_nuclei_type_stat

    if args.mode == "instance":
        return run_nuclei_inst_stat(args.pred_dir, args.true_dir,
                                    print_img_stats=args.print_img_stats)
    return run_nuclei_type_stat(args.pred_dir, args.true_dir)


if __name__ == "__main__":
    main()
