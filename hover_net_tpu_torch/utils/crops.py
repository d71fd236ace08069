"""Center-crop, padding and bounding-box primitives.

The port's copy of hover_net_tpu/utils/crops.py (same names, same
behaviour). The crops are pure slicing, so they work on numpy arrays and
torch tensors alike; `center_pad_to_shape` and `get_bounding_box` take
numpy arrays.

Behavioural reference: misc/utils.py:18-52,95-107 and
models/hovernet/utils.py:11-50 in the upstream repo.
"""

from __future__ import annotations

import numpy as np


def crop_op(x, cropping, layout: str = "NHWC"):
    """Center crop by a fixed *amount* (`cropping` = total pixels removed).

    Top/left get ``amount // 2``; bottom/right get the remainder — the same
    asymmetric split as the reference (models/hovernet/utils.py:20-27).
    """
    ct = cropping[0] // 2
    cb = cropping[0] - ct
    cl = cropping[1] // 2
    cr = cropping[1] - cl
    if layout == "NHWC":
        return x[:, ct : x.shape[1] - cb, cl : x.shape[2] - cr, :]
    if layout == "NCHW":
        return x[:, :, ct : x.shape[2] - cb, cl : x.shape[3] - cr]
    raise ValueError(f"unknown layout {layout}")


def crop_to_shape(x, target_hw, layout: str = "NHWC"):
    """Center crop ``x`` so its spatial dims equal ``target_hw`` (h, w)."""
    if layout == "NHWC":
        dh, dw = x.shape[1] - target_hw[0], x.shape[2] - target_hw[1]
    else:
        dh, dw = x.shape[2] - target_hw[0], x.shape[3] - target_hw[1]
    assert dh >= 0 and dw >= 0, "target must be smaller than source"
    return crop_op(x, (dh, dw), layout)


def cropping_center(x, crop_shape, batch: bool = False):
    """Center crop of a (H, W, ...) array (or (N, H, W, ...) when batch).

    Matches misc/utils.py:32-52: offsets use ``int((size - crop) * 0.5)``.
    """
    if not batch:
        h0 = int((x.shape[0] - crop_shape[0]) * 0.5)
        w0 = int((x.shape[1] - crop_shape[1]) * 0.5)
        return x[h0 : h0 + crop_shape[0], w0 : w0 + crop_shape[1]]
    h0 = int((x.shape[1] - crop_shape[0]) * 0.5)
    w0 = int((x.shape[2] - crop_shape[1]) * 0.5)
    return x[:, h0 : h0 + crop_shape[0], w0 : w0 + crop_shape[1]]


def center_pad_to_shape(img, size, cval=255):
    """Pad (H, W[, C]) array up to ``size`` with constant ``cval``.

    Matches misc/utils.py:95-107 (smaller half first).
    """
    pad_h = size[0] - img.shape[0]
    pad_w = size[1] - img.shape[1]
    pad_h = (pad_h // 2, pad_h - pad_h // 2)
    pad_w = (pad_w // 2, pad_w - pad_w // 2)
    pad = (pad_h, pad_w) if img.ndim == 2 else (pad_h, pad_w, (0, 0))
    return np.pad(img, pad, "constant", constant_values=cval)


def get_bounding_box(mask):
    """[rmin, rmax, cmin, cmax] of the nonzero region, max-exclusive.

    Matches misc/utils.py:18-28.
    """
    rows = np.any(mask, axis=1)
    cols = np.any(mask, axis=0)
    rmin, rmax = np.where(rows)[0][[0, -1]]
    cmin, cmax = np.where(cols)[0][[0, -1]]
    return [int(rmin), int(rmax) + 1, int(cmin), int(cmax) + 1]
