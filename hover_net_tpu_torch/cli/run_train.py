"""Training CLI (run_train.py parity) of the port.

  python -m hover_net_tpu_torch.cli.run_train --config my_config.py
  python -m hover_net_tpu_torch.cli.run_train --device cpu --config my_config.py
  python -m hover_net_tpu_torch.cli.run_train --view train --config my_config.py

Counterpart of hover_net_tpu/cli/run_train.py: the same flags plus
`--device` ('cuda' by default; without a GPU that raises, pass 'cpu' to
train on the CPU). `--n_devices N` trains data-parallel on N devices,
one process each (every card from `--device` on when it is not given, as
the JAX CLI takes every device; more than there are raises; with
`--device cpu`, N processes on the CPU). A config file is a Python module defining
`config = TrainConfig(...)` (hover_net_tpu_torch.config); with no file,
flags build the default two-phase CoNSeP setup
(models/hovernet/opt.py:23-142 equivalent). `--view` writes PNGs and
needs no matplotlib.

`--resume` continues the first phase whose log dir holds fewer epochs
than it runs, from its last `net_epoch=N` checkpoint: the port's `.tar`,
or the JAX trainer's `.msgpack` with its optax state `<path>.opt` (a
phase begun on the TPU; the parameters, BN statistics, Adam moments and
step carry over, and the phase goes on writing `.tar`). A phase's
`pretrained` may be a JAX `.msgpack` as well.
"""

from __future__ import annotations

import argparse
import importlib.util


def load_config(path):
    spec = importlib.util.spec_from_file_location("user_config", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.config


def view_dataset(config, mode: str):
    """Render augmented batches with their NP/HV targets
    (run_train.py:74-94 equivalent; writes PNGs instead of plt.show so
    it works headless)."""
    import cv2
    import numpy as np

    from ..data.train_pipeline import PatchDataset, TrainLoader
    from ..utils.viz import colorize

    dirs = (config.train_dir_list if mode == "train"
            else config.valid_dir_list)
    loader = TrainLoader(
        PatchDataset(dirs), batch_size=4, input_shape=config.act_shape,
        mask_shape=config.out_shape, mode=mode,
        with_type=config.type_classification, num_workers=0,
        seed=config.seed,
    )
    for bi, batch in enumerate(loader):
        panels = []
        for i in range(batch["img"].shape[0]):
            img = batch["img"][i].astype(np.uint8)
            np_map = colorize(batch["np_map"][i], 0, 1)
            hx = colorize(batch["hv_map"][i][..., 0] + 1, 0, 2)
            hy = colorize(batch["hv_map"][i][..., 1] + 1, 0, 2)
            h = max(img.shape[0], np_map.shape[0])

            def pad(x):
                py = (h - x.shape[0]) // 2
                return np.pad(x, ((py, h - x.shape[0] - py), (0, 0), (0, 0)),
                              constant_values=255)

            panels.append(np.concatenate([pad(img), pad(np_map), pad(hx), pad(hy)],
                                         axis=1))
        out = np.concatenate(panels, axis=0)
        path = f"view_{mode}_{bi}.png"
        cv2.imwrite(path, cv2.cvtColor(out, cv2.COLOR_RGB2BGR))
        print(f"wrote {path}")
        if bi >= 3:
            break
    loader.close()


def main(argv=None):
    p = argparse.ArgumentParser("hover_net_tpu_torch.run_train")
    p.add_argument("--config", default=None, help="python file with `config = TrainConfig(...)`")
    p.add_argument("--view", default=None, choices=["train", "valid"])
    p.add_argument("--resume", action="store_true",
                   help="resume the current phase from its last checkpoint")
    p.add_argument("--n_devices", type=int, default=None,
                   help="devices to train on, one process each (default: "
                        "every CUDA card from --device on; 1 on the CPU)")
    p.add_argument("--device", default="cuda",
                   help="torch device to train on ('cuda' or 'cpu')")
    p.add_argument("--pretrained", default=None,
                   help="phase-0 ImageNet preact-ResNet50 weights "
                        "(.npz TF- or torch-keyed, .tar or JAX "
                        ".msgpack); "
                        "overrides the config's value "
                        "(reference run_train.py:196-203, opt.py:55)")
    args = p.parse_args(argv)

    if args.config:
        config = load_config(args.config)
    else:
        from ..config import TrainConfig

        config = TrainConfig()

    if args.pretrained:
        config.phases[0].pretrained = args.pretrained

    if args.view:
        view_dataset(config, args.view)
        return

    from ..train.manager import TrainManager

    return TrainManager(config, n_devices=args.n_devices,
                        device=args.device).run(resume=args.resume)


if __name__ == "__main__":
    main()
