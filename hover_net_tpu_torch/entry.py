"""The flagship inference forward as an entry point: `entry()`.

Counterpart of `entry()` in the repository's `__graft_entry__.py`: the
fast-mode HoVerNet with the 5-type branch at the reference width 64, a
bf16 body, seeded random weights (here from a `torch.Generator`), and a
batch of eight 256^2 RGB patches. It returns `(fn, args)`: `fn(*args)`
is `infer.steps.infer_output`, the [8, 164, 164, 4] float32 concat of
the type argmax, the foreground probability and the two hv maps.

    from hover_net_tpu_torch.entry import entry
    fn, args = entry()            # on cuda
    out = fn(*args)
"""

from __future__ import annotations

import torch

from .infer.base import resolve_device
from .infer.steps import infer_output
from .models.hovernet import HoVerNet, HoVerNetConfig


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
