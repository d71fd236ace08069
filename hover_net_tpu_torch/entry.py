"""The port's entry points: `entry()` and `dryrun_multichip(n)`.

Counterpart of `entry()` in the repository's `__graft_entry__.py`: the
fast-mode HoVerNet with the 5-type branch at the reference width 64, a
bf16 body, seeded random weights (here from a `torch.Generator`), and a
batch of eight 256^2 RGB patches. It returns `(fn, args)`: `fn(*args)`
is `infer.steps.infer_output`, the [8, 164, 164, 4] float32 concat of
the type argmax, the foreground probability and the two hv maps.

    from hover_net_tpu_torch.entry import entry
    fn, args = entry()            # on cuda
    out = fn(*args)

`dryrun_multichip(n)`, the counterpart of `dryrun_multichip` there: one
data-parallel train step over n ranks (`dryrun_train_step`: one process
a device, the BN moments and the loss over the global batch), then one
round of the striped WSI post-processing over an n-slot mesh
(`infer.wsi.dryrun_striped_infer`). `devices` defaults to cuda:0..n-1
and may repeat a device (`["cpu"] * n` on the CPU).
"""

from __future__ import annotations

import torch

from .infer.base import resolve_device
from .infer.steps import infer_output
from .models.hovernet import HoVerNet, HoVerNetConfig
from .parallel.train_parallel import dryrun_train_step


def entry(device="cuda", width: int = 64):
    """(fn, (model, imgs)) of the flagship forward on `device` (a CUDA
    device unless `device="cpu"`; without a GPU, CUDA raises). `width`
    narrows the model (tests run width 8)."""
    dev = resolve_device(device)
    cfg = HoVerNetConfig(mode="fast", nr_types=5, width=width,
                         dtype=torch.bfloat16)
    model = HoVerNet(cfg, generator=torch.Generator().manual_seed(0))
    model = model.to(dev).eval()

    @torch.no_grad()
    def fn(model, imgs):
        return infer_output(model, imgs)

    size = cfg.patch_input_shape
    imgs = torch.zeros((8, size, size, 3), dtype=torch.float32, device=dev)
    return fn, (model, imgs)


def dryrun_multichip(n_devices: int, devices=None) -> None:
    """The train-step dryrun, then the striped-inference dryrun, over
    `n_devices` devices; each raises on a failed check and prints its
    line."""
    from .infer.wsi import dryrun_striped_infer

    dryrun_train_step(n_devices, devices)
    res = dryrun_striped_infer(n_devices, devices)
    print(f"dryrun_striped_infer ok: {n_devices} devices, "
          f"{res['n_instances']} instances")
