"""Kernel K1: the post-processing tail as one hand-written CUDA kernel
chain (csrc/post_proc_tail.cu), and its plain PyTorch version.

`proc_tail(blb, sob)` takes the thresholded nuclei mask and the Sobel
energy ([N, H, W] bool and float32) and returns int32 seed-index
instance labels: blob CCL and small-object removal, the blurred and
quantised watershed energy, markers (threshold, fill-holes, 5x5
opening, CCL, removal) and the two-phase marker watershed. It replaces
the TPU's Pallas kernel `_make_kernel` in
hover_net_tpu/ops/post_proc_pallas.py. Each map is solved whole, so the
labels are those of the JAX exact path, `proc_np_hv_batch(exact=True)`.

- CPU tensors go to `proc_tail_reference`, the plain version built
  from ops/post_proc_device.py.
- CUDA tensors go to the kernel. The library is compiled with nvcc for
  sm_90a at first use by ops/nvcc_build.py, into build/hover_net_tpu_torch/
  at the repository root, keyed by a hash of the source; a failed build
  raises. There is no fallback.

`proc_tail.launches` counts the kernel launches (one per call).
"""

from __future__ import annotations

import ctypes

import torch

from hover_net_tpu.ops.cc_np import ellipse_structuring_element

from . import filters
from .nvcc_build import build_library
from .post_proc_device import (
    NUM_LEVELS,
    connected_components,
    fill_holes,
    remove_small,
    watershed_flood,
)

# the sweep orders the kernel's in-place watershed relaxations accept:
# 0 raster, 1 reversed raster, 2 strided permutation (tests only; the
# fixpoints are unique, so every order gives the same labels)
SWEEP_ORDERS = (0, 1, 2)
_STRIDE = 7919  # order 2 visits pixel (t * _STRIDE) % total


def proc_tail_reference(blb: torch.Tensor, sob: torch.Tensor,
                        marker_min_size: int = 10, blob_min_size: int = 10
                        ) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device."""
    blb = remove_small(connected_components(blb), blob_min_size) > 0
    blb_f = blb.float()
    overall = torch.clamp_min(sob - (1.0 - blb_f), 0.0)
    dist = -filters.gaussian_blur_3x3((1.0 - overall) * blb_f)
    energy_q = torch.round((dist + 1.0) * float(NUM_LEVELS - 1)).to(
        torch.int32)
    selem = ellipse_structuring_element(5, 5)
    marker = fill_holes(blb & ~(overall >= 0.4))
    marker = filters.dilate(filters.erode(marker, selem), selem)
    markers = remove_small(connected_components(marker), marker_min_size)
    return watershed_flood(energy_q, markers, blb)


# ------------------------------------------------------------ the kernel

def _bind(lib: ctypes.CDLL) -> None:
    lib.hnt_proc_tail_workspace_bytes.restype = ctypes.c_int64
    lib.hnt_proc_tail_workspace_bytes.argtypes = [ctypes.c_int64]
    lib.hnt_proc_tail.restype = ctypes.c_int
    lib.hnt_proc_tail.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
    ]
    lib.hnt_error_string.restype = ctypes.c_char_p
    lib.hnt_error_string.argtypes = [ctypes.c_int]


def build() -> ctypes.CDLL:
    """Compile csrc/post_proc_tail.cu (if this source has no library yet)
    and load it. Raises on any failure."""
    return build_library("post_proc_tail", _bind)


def _proc_tail_cuda(blb, sob, marker_min_size, blob_min_size, sweep_order):
    n, h, w = blb.shape
    if sob.shape != blb.shape or sob.device != blb.device:
        raise ValueError(f"blb {tuple(blb.shape)} on {blb.device} and sob "
                         f"{tuple(sob.shape)} on {sob.device} differ")
    if sob.dtype != torch.float32:
        raise TypeError(f"sob must be float32, got {sob.dtype}")
    if blb.dtype not in (torch.bool, torch.uint8):
        raise TypeError(f"blb must be bool or uint8, got {blb.dtype}")
    if h < 2 or w < 2 or n * h * w >= 2**31:
        raise ValueError(f"unsupported map shape {tuple(blb.shape)}")
    if sweep_order not in SWEEP_ORDERS or (
            sweep_order == 2 and (n * h * w) % _STRIDE == 0):
        raise ValueError(f"sweep_order {sweep_order} for {n * h * w} px")
    blb = blb.contiguous().view(torch.uint8)
    sob = sob.contiguous()
    lib = build()
    with torch.cuda.device(blb.device):
        out = torch.empty((n, h, w), dtype=torch.int32, device=blb.device)
        ws = torch.empty(lib.hnt_proc_tail_workspace_bytes(n * h * w),
                         dtype=torch.uint8, device=blb.device)
        stream = torch.cuda.current_stream(blb.device).cuda_stream
        err = lib.hnt_proc_tail(blb.data_ptr(), sob.data_ptr(),
                                out.data_ptr(), ws.data_ptr(), n, h, w,
                                marker_min_size, blob_min_size, sweep_order,
                                stream)
    if err:
        raise RuntimeError("post-processing kernel failed: "
                           + lib.hnt_error_string(err).decode())
    proc_tail.launches += 1
    return out


def proc_tail(blb: torch.Tensor, sob: torch.Tensor, marker_min_size: int = 10,
              blob_min_size: int = 10, sweep_order: int = 0) -> torch.Tensor:
    """[N, H, W] nuclei mask (bool/uint8) + Sobel energy (float32) ->
    int32 [N, H, W] seed-index labels. CUDA tensors run the kernel
    (`sweep_order` picks its relaxation order), CPU tensors the plain
    version."""
    if blb.device.type == "cuda":
        return _proc_tail_cuda(blb, sob, marker_min_size, blob_min_size,
                               sweep_order)
    if blb.device.type != "cpu":
        raise ValueError(f"no post-processing path for {blb.device}")
    return proc_tail_reference(blb.bool(), sob, marker_min_size,
                               blob_min_size)


proc_tail.launches = 0
