"""Kernel K2: the standalone marker watershed as a hand-written CUDA
kernel chain (`hnt_watershed` in csrc/post_proc_tail.cu), and its plain
PyTorch version.

Counterpart of hover_net_tpu/ops/watershed_pallas.py: `watershed` of
`watershed_pallas` (the TPU kernel `_kernel`), `watershed_blocked` of
`watershed_pallas_blocked`. Same packed cost `(level << 15) | hops`, same
(hops, label-min) tie rule and the same labels as
`post_proc_device.watershed_flood`, which is the plain version.

- CPU tensors go to `watershed_reference` (`watershed_flood`).
- CUDA tensors go to the kernel, which shares K1's library and its
  watershed sweeps (ops/post_proc_cuda.build: nvcc for sm_90a at first
  use into build/hover_net_tpu_torch/); a failed build raises. There is
  no fallback.

The TPU kernel held one map in VMEM (<= ~512^2); the CUDA kernel takes any
map of fewer than 2^31 pixels, so the blocked entry exists for parity
with the JAX API, not because a map must be cut.

`watershed.launches` counts the kernel launches (one per call).
"""

from __future__ import annotations

from typing import Optional

import torch

from .post_proc_cuda import (
    build,
    check_sweep_order,
    read_stats,
    stats_buffer,
)
from .post_proc_device import watershed_flood


def watershed_reference(energy_q: torch.Tensor, markers: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device."""
    return watershed_flood(energy_q.to(torch.int32), markers.to(torch.int32),
                           mask.bool())


def _watershed_cuda(energy_q, markers, mask, sweep_order, stats):
    if energy_q.dim() != 3 or not (
            energy_q.shape == markers.shape == mask.shape):
        raise ValueError(f"energy_q {tuple(energy_q.shape)}, markers "
                         f"{tuple(markers.shape)} and mask "
                         f"{tuple(mask.shape)} must be one [N, H, W] shape")
    if not (energy_q.device == markers.device == mask.device):
        raise ValueError("energy_q, markers and mask lie on different "
                         "devices")
    n, h, w = energy_q.shape
    if n * h * w >= 2**31:
        raise ValueError(f"unsupported map shape {tuple(energy_q.shape)}")
    check_sweep_order(sweep_order, n, h, w)
    out = torch.zeros((n, h, w), dtype=torch.int32, device=energy_q.device)
    if out.numel() == 0:
        return out
    energy_q = energy_q.to(torch.int32).contiguous()
    markers = markers.to(torch.int32).contiguous()
    mask = mask.to(torch.bool).contiguous().view(torch.uint8)
    lib = build()
    with torch.cuda.device(out.device):
        ws = torch.empty(lib.hnt_watershed_workspace_bytes(n, h, w),
                         dtype=torch.uint8, device=out.device)
        stream = torch.cuda.current_stream(out.device).cuda_stream
        buf = stats_buffer(stats)
        err = lib.hnt_watershed(energy_q.data_ptr(), markers.data_ptr(),
                                mask.data_ptr(), out.data_ptr(),
                                ws.data_ptr(), n, h, w, sweep_order, stream,
                                buf)
    if err:
        raise RuntimeError("watershed kernel failed: "
                           + lib.hnt_error_string(err).decode())
    watershed.launches += 1
    read_stats(buf, stats)
    return out


def watershed(energy_q: torch.Tensor, markers: torch.Tensor,
              mask: torch.Tensor, sweep_order: int = 0,
              stats: Optional[dict] = None) -> torch.Tensor:
    """[N, H, W] quantised energy (int32, levels in [0, 65535]), markers
    (int32, 0 = none, any positive label) and flood mask -> int32
    [N, H, W] labels, 0 outside the mask or where no marker reaches.
    CUDA tensors run the kernel (`sweep_order` picks its relaxation
    order; a `stats` dict receives the call's split, as for
    post_proc_cuda.proc_tail, with the seed pass as "markers"), CPU
    tensors the plain version."""
    if energy_q.device.type == "cuda":
        return _watershed_cuda(energy_q, markers, mask, sweep_order, stats)
    if energy_q.device.type != "cpu":
        raise ValueError(f"no watershed path for {energy_q.device}")
    if stats is not None:
        raise ValueError("stats are the kernel's: pass CUDA tensors")
    return watershed_reference(energy_q, markers, mask)


watershed.launches = 0


def watershed_blocked(energy_q: torch.Tensor, markers: torch.Tensor,
                      mask: torch.Tensor, core: int = 320, halo: int = 96
                      ) -> torch.Tensor:
    """`watershed` over overlapping windows, as
    `watershed_pallas_blocked` cuts the map: zero padding of `halo` before
    and up to a whole number of `core` blocks plus `halo` after, one
    (core + 2 halo)^2 window per block, each solved whole, then the cores
    reassembled and masked. A component smaller than `halo` gets the
    labels of the whole-map solve; a larger one may split at a seam."""
    n, h, w = energy_q.shape
    win = core + 2 * halo
    nby, nbx = -(-h // core), -(-w // core)
    pad = (halo, nbx * core + halo - w, halo, nby * core + halo - h)

    def windows(x):
        x = torch.nn.functional.pad(x.to(torch.int32), pad)
        x = x.unfold(1, win, core).unfold(2, win, core)
        return x.reshape(n * nby * nbx, win, win)

    lab = watershed(windows(energy_q), windows(markers),
                    windows(mask).bool())
    cores = lab[:, halo:halo + core, halo:halo + core]
    cores = cores.reshape(n, nby, nbx, core, core).permute(0, 1, 3, 2, 4)
    out = cores.reshape(n, nby * core, nbx * core)[:, :h, :w]
    return torch.where(mask.bool(), out, torch.zeros_like(out))
