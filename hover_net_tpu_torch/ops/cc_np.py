"""Host-side (NumPy/SciPy) connected-component + morphology helpers.

The port's copy of the functions it uses from hover_net_tpu/ops/cc_np.py
(same names, same behaviour): the tissue mask of the WSI manager, the
5x5 ellipse of the post-processing tail, and the small-object removal of
the training targets.
"""

from __future__ import annotations

import numpy as np
from scipy import ndimage


def label(mask, connectivity: int = 1):
    """Connected components; connectivity 1 = 4-neighbourhood, 2 = 8."""
    structure = ndimage.generate_binary_structure(2, connectivity)
    lab, num = ndimage.label(mask, structure=structure)
    return lab, num


def remove_small_objects(arr, min_size: int = 64, connectivity: int = 1):
    """Zero out components smaller than min_size.

    Matches misc/utils.py:142-182 (labelled input used as-is; bool input
    labelled first).
    """
    out = arr.copy()
    if min_size == 0:
        return out
    if out.dtype == bool:
        ccs, _ = label(arr, connectivity)
    else:
        ccs = out
    component_sizes = np.bincount(ccs.ravel())
    too_small = component_sizes < min_size
    out[too_small[ccs]] = 0
    return out


def remove_small_holes(mask, area_threshold: int, connectivity: int = 1):
    """Fill background holes smaller than area_threshold (skimage equiv)."""
    inv = ~mask.astype(bool)
    lab, _ = label(inv, connectivity)
    sizes = np.bincount(lab.ravel())
    # component 0 is the foreground region of `inv`'s complement; border
    # -connected background should not be filled: find labels touching
    # the border
    border_labels = np.unique(
        np.concatenate([lab[0, :], lab[-1, :], lab[:, 0], lab[:, -1]])
    )
    fill = np.ones(sizes.shape, bool)
    fill[border_labels] = False
    fill &= sizes < area_threshold
    return mask.astype(bool) | fill[lab]


def ellipse_structuring_element(h: int, w: int):
    """cv2.getStructuringElement(MORPH_ELLIPSE, (w, h)) equivalent.

    Implements OpenCV's integer ellipse rasterisation so results are
    bit-identical to the reference's 5x5 kernel (post_proc.py:83).
    """
    r, c = h // 2, w // 2
    inv_r2 = 1.0 / (r * r) if r > 0 else 0.0
    kernel = np.zeros((h, w), np.uint8)
    for i in range(h):
        j1, j2 = 0, 0
        dy = i - r
        if abs(dy) <= r:
            if r == 0:
                dx = c
            else:
                dx = int(round(c * np.sqrt(max(0.0, 1.0 - dy * dy * inv_r2))))
            j1 = max(c - dx, 0)
            j2 = min(c + dx + 1, w)
            kernel[i, j1:j2] = 1
    return kernel


def binary_dilation_disk(mask, radius: int):
    """skimage.morphology.binary_dilation(mask, disk(radius)) equivalent."""
    yy, xx = np.mgrid[-radius : radius + 1, -radius : radius + 1]
    disk = (xx * xx + yy * yy) <= radius * radius
    return ndimage.binary_dilation(mask, structure=disk)
