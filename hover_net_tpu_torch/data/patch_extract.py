"""Offline patch extraction: sliding window with mirror padding.

The port's copy of hover_net_tpu/data/patch_extract.py (same names,
same behaviour).

Parity with misc/patch_extractor.py:58-133 + extract_patches.py:25-95:
540x540 windows at 164x164 stride ('mirror' mode pads by half the
window-step margin with reflection so every source pixel is covered).
"""

from __future__ import annotations

import math

import numpy as np


def _steps(length: int, win: int, stride: int) -> int:
    return int(math.floor((length - win) / stride)) + 1


def extract_valid(x: np.ndarray, win_shape, step_shape) -> list:
    """Windows fully inside the image; trailing partial windows are
    re-anchored to the bottom/right edge (patch_extractor.py:90-133)."""
    h, w = x.shape[:2]
    wh, ww = win_shape
    sh, sw = step_shape
    out = []
    ys = [i * sh for i in range(_steps(h, wh, sh))]
    xs = [j * sw for j in range(_steps(w, ww, sw))]
    if ys and ys[-1] + wh < h:
        ys.append(h - wh)
    if xs and xs[-1] + ww < w:
        xs.append(w - ww)
    for y in ys:
        for x0 in xs:
            out.append(x[y : y + wh, x0 : x0 + ww])
    return out


def extract_mirror(x: np.ndarray, win_shape, step_shape) -> list:
    """Mirror-pad by (win-step)/2 then run the valid extractor
    (patch_extractor.py:58-88)."""
    wh, ww = win_shape
    sh, sw = step_shape
    pad_t = (wh - sh) // 2
    pad_b = wh - sh - pad_t
    pad_l = (ww - sw) // 2
    pad_r = ww - sw - pad_l
    pad = ((pad_t, pad_b), (pad_l, pad_r)) + (((0, 0),) if x.ndim == 3 else ())
    padded = np.pad(x, pad, mode="reflect")
    return extract_valid(padded, win_shape, step_shape)


def extract_patches(img: np.ndarray, ann: np.ndarray, win_shape=(540, 540),
                    step_shape=(164, 164), mode: str = "mirror") -> list:
    """Stack [RGB, ann...] channels then window (extract_patches.py:72-95)."""
    stacked = np.concatenate([img, ann], axis=-1)
    fn = extract_mirror if mode == "mirror" else extract_valid
    return fn(stacked, win_shape, step_shape)
