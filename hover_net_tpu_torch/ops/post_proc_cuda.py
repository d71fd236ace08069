"""Kernels K1 and K4: the post-processing tail as one hand-written CUDA
kernel chain (csrc/post_proc_tail.cu), its stage-ablation variants, and
their plain PyTorch version.

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

K4 is the same entry with `skip` naming one stage to leave out (SKIPS):
"ws" returns the marker labels with no watershed, "ws_phase2" runs the
watershed's phase 1 only, "rmsmall" skips both small-object removals,
"fill" skips fill-holes and "open" the 5x5 opening. It replaces the TPU
kernel of scripts/probe_pp_stages.py (`kernel` in `make_variant`), with
one difference: the TPU probe's blur fills zeros at its window edge,
while K4 blurs as K1 does (reflect-101), because it exists to time K1's
stages (cli/probe_pp_stages.py). skip="none" is K1.

`proc_tail.launches` counts K1's launches (skip="none"),
`proc_tail.skip_launches` K4's (any other skip); one per call.

`stats`, a dict passed to `proc_tail` (or to `watershed_cuda.watershed`)
with CUDA tensors, receives the call's split: "stage_ms", the device
time of each of STAGES (CUDA events at the stage boundaries), and
"sweeps", the sweep count of each watershed phase. The call then waits
for the kernel's end. Without it the call records nothing.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from . import filters
from .cc_np import ellipse_structuring_element
from .nvcc_build import build_library
from .post_proc_device import (
    INT_MAX,
    NUM_LEVELS,
    connected_components,
    fill_holes,
    remove_small,
    watershed_cost,
    watershed_flood,
)

# the sweep orders of the kernel's tiled watershed relaxations: the order
# of the tiles and of the pixels inside a tile, 0 raster, 1 reversed, 2
# strided (tests only; the fixpoints are unique, so every order gives the
# same labels)
SWEEP_ORDERS = (0, 1, 2)
_STRIDE = 7919  # order 2 visits tile (t * _STRIDE) % tiles
TILE = 32  # side of the kernel's tiles (csrc/post_proc_tiles.cuh)
# K4's stage switch: the kernel's `skip` code is the index here
SKIPS = ("none", "ws", "ws_phase2", "rmsmall", "fill", "open")
# the stages of one call's split (`stats`), in order; "markers" is the
# marker CCL, its removal and the watershed seeds (K2: its seed pass)
STAGES = ("blob_ccl", "energy", "fill_holes", "opening", "markers",
          "ws_phase1", "ws_phase2")


def check_sweep_order(sweep_order: int, n: int, h: int, w: int) -> None:
    """Raise unless the kernels accept `sweep_order` for [n, h, w] maps
    (order 2 permutes the tiles only if their count is no multiple of
    the stride)."""
    tiles = n * -(-h // TILE) * -(-w // TILE)
    if sweep_order not in SWEEP_ORDERS or (
            sweep_order == 2 and tiles % _STRIDE == 0):
        raise ValueError(f"sweep_order {sweep_order} for [{n}, {h}, {w}]")


def _skip_code(skip: str) -> int:
    if skip not in SKIPS:
        raise ValueError(f"skip must be one of {SKIPS}, got {skip!r}")
    return SKIPS.index(skip)


def watershed_inputs(blb: torch.Tensor, sob: torch.Tensor,
                     marker_min_size: int = 10, blob_min_size: int = 10,
                     skip: str = "none"):
    """The stages of the plain version before the watershed: (energy_q
    int32, markers int32, flood mask bool), each [N, H, W]. K1's labels
    are `watershed_flood` of these (and K2's, fed them)."""
    _skip_code(skip)
    rm = skip != "rmsmall"
    blb = connected_components(blb)
    blb = (remove_small(blb, blob_min_size) if rm else blb) > 0
    blb_f = blb.float()
    overall = torch.clamp_min(sob - (1.0 - blb_f), 0.0)
    dist = -filters.gaussian_blur_3x3((1.0 - overall) * blb_f)
    energy_q = torch.round((dist + 1.0) * float(NUM_LEVELS - 1)).to(
        torch.int32)
    selem = ellipse_structuring_element(5, 5)
    marker = blb & ~(overall >= 0.4)
    if skip != "fill":
        marker = fill_holes(marker)
    if skip != "open":
        marker = filters.dilate(filters.erode(marker, selem), selem)
    markers = connected_components(marker)
    if rm:
        markers = remove_small(markers, marker_min_size)
    return energy_q, markers, blb


def proc_tail_reference(blb: torch.Tensor, sob: torch.Tensor,
                        marker_min_size: int = 10, blob_min_size: int = 10,
                        skip: str = "none") -> torch.Tensor:
    """Plain PyTorch version of the kernel (K1, or K4 with `skip`), on
    any device."""
    energy_q, markers, blb = watershed_inputs(blb, sob, marker_min_size,
                                              blob_min_size, skip)
    if skip == "ws":
        return markers
    if skip == "ws_phase2":
        cost = watershed_cost(energy_q, markers, blb)
        lab0 = torch.where((markers > 0) & blb, markers,
                           torch.zeros_like(markers))
        return torch.where((cost != INT_MAX) & blb, lab0 + (cost & 0xFF),
                           torch.zeros_like(cost))
    return watershed_flood(energy_q, markers, blb)


# ------------------------------------------------------------ the kernel

def stats_buffer(stats):
    """The kernel's `stats` argument: None, or a double array for the
    split (STAGES' times, then the two phases' sweep counts)."""
    return None if stats is None else (ctypes.c_double * (len(STAGES) + 2))()


def read_stats(buf, stats) -> None:
    """Write the split of `buf` (see stats_buffer) into the dict."""
    if stats is None:
        return
    stats["stage_ms"] = dict(zip(STAGES, buf[:len(STAGES)]))
    stats["sweeps"] = {"ws_phase1": int(buf[len(STAGES)]),
                       "ws_phase2": int(buf[len(STAGES) + 1])}


def _bind(lib: ctypes.CDLL) -> None:
    lib.hnt_proc_tail_workspace_bytes.restype = ctypes.c_int64
    lib.hnt_proc_tail_workspace_bytes.argtypes = [ctypes.c_int] * 3
    lib.hnt_proc_tail.restype = ctypes.c_int
    lib.hnt_proc_tail.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p,
    ]
    lib.hnt_watershed_workspace_bytes.restype = ctypes.c_int64
    lib.hnt_watershed_workspace_bytes.argtypes = [ctypes.c_int] * 3
    lib.hnt_watershed.restype = ctypes.c_int
    lib.hnt_watershed.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
    ]
    lib.hnt_error_string.restype = ctypes.c_char_p
    lib.hnt_error_string.argtypes = [ctypes.c_int]


def build() -> ctypes.CDLL:
    """Compile csrc/post_proc_tail.cu (K1, K2 and K4; if this source has
    no library yet) and load it. Raises on any failure."""
    return build_library("post_proc_tail", _bind)


def _proc_tail_cuda(blb, sob, marker_min_size, blob_min_size, sweep_order,
                    skip, stats):
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
    check_sweep_order(sweep_order, n, h, w)
    code = _skip_code(skip)
    blb = blb.contiguous().view(torch.uint8)
    sob = sob.contiguous()
    lib = build()
    with torch.cuda.device(blb.device):
        out = torch.empty((n, h, w), dtype=torch.int32, device=blb.device)
        ws = torch.empty(lib.hnt_proc_tail_workspace_bytes(n, h, w),
                         dtype=torch.uint8, device=blb.device)
        stream = torch.cuda.current_stream(blb.device).cuda_stream
        buf = stats_buffer(stats)
        err = lib.hnt_proc_tail(blb.data_ptr(), sob.data_ptr(),
                                out.data_ptr(), ws.data_ptr(), n, h, w,
                                marker_min_size, blob_min_size, sweep_order,
                                code, stream, buf)
    if err:
        raise RuntimeError("post-processing kernel failed: "
                           + lib.hnt_error_string(err).decode())
    if code:
        proc_tail.skip_launches += 1
    else:
        proc_tail.launches += 1
    read_stats(buf, stats)
    return out


def proc_tail(blb: torch.Tensor, sob: torch.Tensor, marker_min_size: int = 10,
              blob_min_size: int = 10, sweep_order: int = 0,
              skip: str = "none", stats: Optional[dict] = None
              ) -> torch.Tensor:
    """[N, H, W] nuclei mask (bool/uint8) + Sobel energy (float32) ->
    int32 [N, H, W] seed-index labels (K1), or with `skip` the output of
    K1 without that stage (K4). CUDA tensors run the kernel
    (`sweep_order` picks its relaxation order; a `stats` dict receives
    the call's split), CPU tensors the plain version."""
    if blb.device.type == "cuda":
        return _proc_tail_cuda(blb, sob, marker_min_size, blob_min_size,
                               sweep_order, skip, stats)
    if blb.device.type != "cpu":
        raise ValueError(f"no post-processing path for {blb.device}")
    if stats is not None:
        raise ValueError("stats are the kernel's: pass CUDA tensors")
    return proc_tail_reference(blb.bool(), sob, marker_min_size,
                               blob_min_size, skip)


proc_tail.launches = 0
proc_tail.skip_launches = 0
