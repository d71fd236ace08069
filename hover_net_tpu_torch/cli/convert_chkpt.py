"""Checkpoint converter: a reference PyTorch `.tar` -> the JAX package's
msgpack.

Counterpart of hover_net_tpu/cli/convert_chkpt.py, with its arguments
and its output byte for byte (flax's msgpack, written by
models/msgpack_io.py without flax): a model trained or fine-tuned on the
card goes back to the JAX package as a `.msgpack`. The reverse, a
`.msgpack`'s variables to a reference `.tar`, is
`models.checkpoints.save_torch_tar`, as in the JAX package. Host work
on files: no device.

  python -m hover_net_tpu_torch.cli.convert_chkpt \\
      --input hovernet_fast_pannuke.tar --mode fast --nr_types 6 \\
      --output pannuke.msgpack
"""

from __future__ import annotations

import argparse


def main(argv=None):
    p = argparse.ArgumentParser("hover_net_tpu_torch.convert_chkpt")
    p.add_argument("--input", required=True)
    p.add_argument("--output", required=True)
    p.add_argument("--mode", default="fast", choices=["original", "fast"])
    p.add_argument("--nr_types", type=int, default=0,
                   help="0: an untyped model")
    args = p.parse_args(argv)

    from ..models.checkpoints import (
        jax_from_state_dict,
        load_torch_tar,
        name_map,
        save_checkpoint,
    )
    from ..models.hovernet import HoVerNetConfig

    cfg = HoVerNetConfig(
        mode=args.mode, nr_types=args.nr_types if args.nr_types > 0 else None
    )
    state = load_torch_tar(args.input)
    for key, _, _ in name_map(cfg):
        if key not in state:
            raise KeyError(f"missing torch key: {key}")
    save_checkpoint(args.output, jax_from_state_dict(state, cfg),
                    extra={"mode": args.mode, "nr_types": args.nr_types,
                           "source": args.input})
    print(f"wrote {args.output}")


if __name__ == "__main__":
    main()
