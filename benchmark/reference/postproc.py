"""The post-processing oracle: np + hv maps -> instance labels.

A frozen copy of `proc_np_hv` (hover_net_tpu_torch/ops/post_proc_host.py,
algorithmically the reference's models/hovernet/post_proc.py:26-90:
threshold at 0.5, Sobel-21 energy of the min-max-normalised hv maps,
markers, a marker watershed) with the helpers it takes from
hover_net_tpu_torch/ops/cc_np.py: 4-connected labelling, small-object
removal, fill-holes, cv2's 5x5 ellipse, cv2's opening and the
priority-flood watershed. `instance_types` is the reference's majority
vote of a nucleus's type (post_proc.py:152-169).
"""

from __future__ import annotations

import cv2
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
    ccs = out
    component_sizes = np.bincount(ccs.ravel())
    too_small = component_sizes < min_size
    out[too_small[ccs]] = 0
    return out


def binary_fill_holes(mask):
    return ndimage.binary_fill_holes(mask)


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


def _minmax_norm(x):
    """cv2.normalize(..., NORM_MINMAX, alpha=0, beta=1) equivalent."""
    x = x.astype(np.float32)
    lo, hi = float(x.min()), float(x.max())
    if hi - lo < 1e-12:
        return np.zeros_like(x, np.float32)
    return (x - lo) / (hi - lo)


def proc_np_hv(pred: np.ndarray) -> np.ndarray:
    """NP prob + HV maps (H, W, 3) -> int32 instance map.

    Channel order: 0 = nuclei probability, 1 = horizontal, 2 = vertical
    (post_proc.py:26-90).
    """
    pred = np.array(pred, dtype=np.float32)
    blb_raw = pred[..., 0]
    h_dir_raw = pred[..., 1]
    v_dir_raw = pred[..., 2]

    blb = (blb_raw >= 0.5).astype(np.int32)
    blb = label(blb)[0]
    blb = remove_small_objects(blb, min_size=10)
    blb[blb > 0] = 1

    h_dir = _minmax_norm(h_dir_raw)
    v_dir = _minmax_norm(v_dir_raw)

    sobelh = cv2.Sobel(h_dir, cv2.CV_64F, 1, 0, ksize=21)
    sobelv = cv2.Sobel(v_dir, cv2.CV_64F, 0, 1, ksize=21)
    sobelh = 1 - _minmax_norm(sobelh)
    sobelv = 1 - _minmax_norm(sobelv)

    overall = np.maximum(sobelh, sobelv)
    overall = overall - (1 - blb)
    overall[overall < 0] = 0

    dist = (1.0 - overall) * blb
    dist = -cv2.GaussianBlur(dist, (3, 3), 0)

    overall = (overall >= 0.4).astype(np.int32)
    marker = blb - overall
    marker[marker < 0] = 0
    marker = binary_fill_holes(marker).astype(np.uint8)
    selem = ellipse_structuring_element(5, 5)
    marker = binary_opening(marker, selem).astype(np.uint8)
    marker = label(marker)[0]
    marker = remove_small_objects(marker, min_size=10)

    return watershed(dist, markers=marker, mask=blb).astype(np.int32)


def instance_types(inst: np.ndarray, tp: np.ndarray) -> np.ndarray:
    """[n + 1] type of each label 1..n of `inst` (0 for label 0 and absent
    labels): the most frequent type of its pixels, or the second most
    frequent where the first is 0 and there is a second."""
    n = int(inst.max())
    out = np.zeros(n + 1, np.int64)
    if n == 0:
        return out
    nt = int(tp.max()) + 1
    fg = inst > 0
    hist = np.bincount(inst[fg].astype(np.int64) * nt + tp[fg].astype(np.int64),
                       minlength=(n + 1) * nt).reshape(n + 1, nt)
    order = np.argsort(-hist, axis=1, kind="stable")
    first, second = order[:, 0], order[:, 1] if nt > 1 else order[:, 0]
    has_second = hist[np.arange(n + 1), second] > 0
    out[:] = np.where((first == 0) & has_second, second, first)
    out[0] = 0
    return out
