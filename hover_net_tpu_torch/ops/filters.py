"""Separable image filters of the post-processing energy, in PyTorch.

Counterpart of hover_net_tpu/ops/filters.py. The kernels are OpenCV's
(cv2.Sobel ksize=21, cv2.GaussianBlur (3, 3)), borders are
BORDER_REFLECT_101 (`F.pad(mode="reflect")`), maps are [N, H, W].

Every filter here is written as shift-and-add over the padded map rather
than as a convolution. On the GPU a float32 convolution goes through
cuDNN in TF32 by default (`torch.backends.cudnn.allow_tf32`), which
keeps ~3 decimal digits: enough noise on the min-max-normalised Sobel
energy to flip `overall >= 0.4` markers (hover_net_tpu/ops/filters.py
`_sep_filter` measures the same effect for bf16 passes on the TPU).
Shift-and-add has no such mode and fixes the summation order, so the
result is the same on every device:

- the Sobel taps are binomial integers, so each product of a float32
  value and a tap is exact in float64; the taps are summed in float64
  and rounded to float32 once per pass (like a float32 convolution up
  to the last ulp);
- the 3x3 blur is `(0.25*a + 0.5*b) + 0.25*c` in float32, rows first,
  then columns: the exact arithmetic of the CUDA post-proc kernel
  (csrc/post_proc_tail.cu), whose labels must equal the plain path's.
"""

from __future__ import annotations

import functools
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F


@functools.lru_cache(maxsize=None)
def sobel_kernels(ksize: int):
    """(deriv, smooth) 1-D correlation kernels of cv2.getDerivKernels:
    smooth = [1, 1]^(k-1), deriv = [1, 1]^(k-2) * [-1, 1]."""
    deriv = np.array([1.0])
    for _ in range(ksize - 2):
        deriv = np.convolve(deriv, [1.0, 1.0])
    deriv = np.convolve(deriv, [-1.0, 1.0])
    smooth = np.array([1.0])
    for _ in range(ksize - 1):
        smooth = np.convolve(smooth, [1.0, 1.0])
    return deriv.astype(np.float32), smooth.astype(np.float32)


def _correlate(x: torch.Tensor, taps, dim: int) -> torch.Tensor:
    """1-D correlation of float32 [N, H, W] along `dim` (1 = rows, 2 =
    columns) with reflect-101 borders; float64 accumulation, float32
    result."""
    p = len(taps) // 2
    pad = (0, 0, p, p) if dim == 1 else (p, p, 0, 0)
    xp = F.pad(x[:, None], pad, mode="reflect")[:, 0].double()
    n = x.shape[dim]
    acc = torch.zeros(x.shape, dtype=torch.float64, device=x.device)
    for t, k in enumerate(taps):
        if k:
            acc += float(k) * xp.narrow(dim, t, n)
    return acc.float()


def sobel_h(x: torch.Tensor, ksize: int = 21) -> torch.Tensor:
    """cv2.Sobel(x, dx=1, dy=0): smoothing along rows, derivative along
    columns. x: float32 [N, H, W]."""
    deriv, smooth = sobel_kernels(ksize)
    return _correlate(_correlate(x, smooth, 1), deriv, 2)


def sobel_v(x: torch.Tensor, ksize: int = 21) -> torch.Tensor:
    """cv2.Sobel(x, dx=0, dy=1)."""
    deriv, smooth = sobel_kernels(ksize)
    return _correlate(_correlate(x, deriv, 1), smooth, 2)


def _blur3(x: torch.Tensor, dim: int) -> torch.Tensor:
    pad = (0, 0, 1, 1) if dim == 1 else (1, 1, 0, 0)
    xp = F.pad(x[:, None], pad, mode="reflect")[:, 0]
    n = x.shape[dim]
    a, b, c = (xp.narrow(dim, t, n) for t in range(3))
    return (0.25 * a + 0.5 * b) + 0.25 * c


def gaussian_blur_3x3(x: torch.Tensor) -> torch.Tensor:
    """cv2.GaussianBlur(x, (3, 3), 0): [1, 2, 1] / 4 along rows, then
    along columns. x: float32 [N, H, W]."""
    return _blur3(_blur3(x, 1), 2)


def minmax_norm(x: torch.Tensor, where: Optional[torch.Tensor] = None
                ) -> torch.Tensor:
    """Per-sample min-max over the last two dims to [0, 1]; constant
    inputs map to 0 (cv2.normalize NORM_MINMAX).

    where ([N, H, W] bool): take the min/max over these elements only
    (values elsewhere still go through the same affine map). On the
    mirrored canvas of the tile path this restricts the statistics to
    the source image, as hover_net_tpu/ops/filters.minmax_norm does."""
    flat = x.flatten(1)
    if where is None:
        lo = flat.amin(1)
        hi = flat.amax(1)
    else:
        w = where.flatten(1)
        lo = torch.where(w, flat, torch.inf).amin(1)
        hi = torch.where(w, flat, -torch.inf).amax(1)
    lo = lo[:, None, None]
    rng = (hi[:, None, None] - lo)
    safe = torch.where(rng > 0, rng, torch.ones_like(rng))
    return torch.where(rng > 1e-12, (x - lo) / safe, torch.zeros_like(x))


def selem_count(mask: torch.Tensor, selem: np.ndarray, fill: int
                ) -> torch.Tensor:
    """Hit count of the 0/1 structuring element `selem` at every pixel of
    bool [N, H, W] `mask`; pixels outside the map count as `fill`."""
    kh, kw = selem.shape
    n, h, w = mask.shape
    m = F.pad(mask.to(torch.int32), (kw // 2, kw // 2, kh // 2, kh // 2),
              value=fill)
    cnt = torch.zeros((n, h, w), dtype=torch.int32, device=mask.device)
    for dy in range(kh):
        for dx in range(kw):
            if selem[dy, dx]:
                cnt += m[:, dy:dy + h, dx:dx + w]
    return cnt


def erode(mask: torch.Tensor, selem: np.ndarray) -> torch.Tensor:
    """Binary erosion with cv2.erode's default border: outside the map
    counts as foreground."""
    return selem_count(mask, selem, 1) >= int(selem.sum())


def dilate(mask: torch.Tensor, selem: np.ndarray) -> torch.Tensor:
    """Binary dilation; outside the map counts as background."""
    return selem_count(mask, selem, 0) > 0
