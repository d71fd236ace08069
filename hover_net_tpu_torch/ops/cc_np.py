"""Host-side (NumPy/SciPy) connected-component + morphology helpers.

The port's copy of the functions it uses from hover_net_tpu/ops/cc_np.py
(same names, same behaviour): the tissue mask of the WSI manager, the
5x5 ellipse of the post-processing tail, the small-object removal of
the training targets, and the fill-holes, opening and priority-flood
watershed of the host post-processing oracle (ops/post_proc_host.py).
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


def binary_fill_holes(mask):
    return ndimage.binary_fill_holes(mask)


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


def binary_opening(mask, selem):
    """Opening with cv2.morphologyEx border semantics: erosion treats
    outside-of-image as foreground (cv2 default borderValue=+inf),
    dilation as background."""
    er = ndimage.binary_erosion(mask, structure=selem, border_value=1)
    return ndimage.binary_dilation(er, structure=selem, border_value=0)


def binary_dilation_disk(mask, radius: int):
    """skimage.morphology.binary_dilation(mask, disk(radius)) equivalent."""
    yy, xx = np.mgrid[-radius : radius + 1, -radius : radius + 1]
    disk = (xx * xx + yy * yy) <= radius * radius
    return ndimage.binary_dilation(mask, structure=disk)


def watershed(image, markers, mask=None, connectivity: int = 1):
    """Marker-based watershed (priority flood), skimage-compatible.

    Pixels are flooded in increasing `image` order starting from
    `markers`; ties broken by insertion order (matching
    skimage.segmentation.watershed's stable heap semantics closely
    enough for instance-level parity).
    """
    import heapq

    image = np.asarray(image)
    output = np.array(markers, dtype=np.int32, copy=True)
    if mask is not None:
        valid = mask.astype(bool)
    else:
        valid = np.ones(image.shape, bool)
    output[~valid] = 0

    if connectivity == 1:
        neigh = ((-1, 0), (1, 0), (0, -1), (0, 1))
    else:
        neigh = tuple(
            (dy, dx) for dy in (-1, 0, 1) for dx in (-1, 0, 1) if (dy, dx) != (0, 0)
        )

    h, w = image.shape
    heap = []
    counter = 0
    seeded = (output > 0) & valid
    ys, xs = np.nonzero(seeded)
    order = np.argsort(image[ys, xs], kind="stable")
    for k in order:
        y, x = int(ys[k]), int(xs[k])
        heapq.heappush(heap, (image[y, x], counter, y, x))
        counter += 1

    while heap:
        _, _, y, x = heapq.heappop(heap)
        lab_v = output[y, x]
        for dy, dx in neigh:
            ny, nx = y + dy, x + dx
            if 0 <= ny < h and 0 <= nx < w and valid[ny, nx] and output[ny, nx] == 0:
                output[ny, nx] = lab_v
                heapq.heappush(heap, (image[ny, nx], counter, ny, nx))
                counter += 1
    return output
