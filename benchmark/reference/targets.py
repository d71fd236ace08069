"""HoVer-Net training targets: the np map and the hv distance map.

A frozen copy of `gen_instance_hv_map` and `gen_targets` in
hover_net_tpu_torch/ops/targets.py (the NumPy formulation of the
reference's models/hovernet/targets.py:17-114), with `remove_small_objects`
and `cropping_center` beside them. Left out: `fix_mirror_padding`, which
relabels fragments that mirrored augmentation duplicates; the benchmark's
tiles are painted whole, so each id is one fragment and it is the
identity there.
"""

from __future__ import annotations

import numpy as np


def cropping_center(x, crop_shape):
    """Centre crop of an (H, W, ...) array (misc/utils.py:32-52)."""
    h0 = int((x.shape[0] - crop_shape[0]) * 0.5)
    w0 = int((x.shape[1] - crop_shape[1]) * 0.5)
    return x[h0:h0 + crop_shape[0], w0:w0 + crop_shape[1]]


def remove_small_objects(arr, min_size: int = 64):
    """Zero the labels of a label map that cover fewer than `min_size`
    pixels (misc/utils.py:142-182)."""
    out = arr.copy()
    sizes = np.bincount(out.ravel())
    out[(sizes < min_size)[out]] = 0
    return out


def gen_instance_hv_map(ann, crop_shape):
    """Per-pixel horizontal/vertical offsets from each instance's center
    of mass, normalized to [-1, 1] within the instance
    (reference targets.py:17-96 semantics, vectorized).
    """
    ann = np.asarray(ann)
    hgt, wdt = ann.shape[:2]

    x_map = np.zeros((hgt, wdt), dtype=np.float32)
    y_map = np.zeros((hgt, wdt), dtype=np.float32)

    fixed_ann = ann
    # instances counted only if they survive the center crop with >= 30px
    crop_ann = remove_small_objects(
        cropping_center(fixed_ann, crop_shape), min_size=30
    )

    ys, xs = np.nonzero(fixed_ann)
    if ys.size == 0:
        return np.dstack([x_map, y_map])
    vals = fixed_ann[ys, xs]
    # bincount-rank "unique": ids are small ints
    vmax = int(vals.max())
    present = np.zeros(vmax + 1, bool)
    present[vals] = True
    uniq = np.flatnonzero(present)
    lab = (np.cumsum(present) - 1)[vals]  # lab: 0..K-1
    k = uniq.size

    cnt = np.bincount(lab, minlength=k)
    sum_y = np.bincount(lab, weights=ys, minlength=k)
    sum_x = np.bincount(lab, weights=xs, minlength=k)
    rmin = np.full(k, hgt, np.int64)
    rmax = np.zeros(k, np.int64)
    cmin = np.full(k, wdt, np.int64)
    cmax = np.zeros(k, np.int64)
    np.minimum.at(rmin, lab, ys)
    np.maximum.at(rmax, lab, ys)
    np.minimum.at(cmin, lab, xs)
    np.maximum.at(cmax, lab, xs)

    # bbox expanded by 2px, min side clamped at 0, max side clamped by the
    # image (the reference's unclamped slice end behaves the same)
    rmin_e = np.maximum(rmin - 2, 0)
    rmax_e = np.minimum(rmax + 1 + 2, hgt)
    cmin_e = np.maximum(cmin - 2, 0)
    cmax_e = np.minimum(cmax + 1 + 2, wdt)

    cmax = int(crop_ann.max())
    surv_present = np.zeros(cmax + 1, bool)
    surv_present[crop_ann.ravel()] = True
    surv_present[0] = False
    surv = (uniq <= cmax) & surv_present[np.minimum(uniq, cmax)]
    ok = surv & (rmax_e - rmin_e >= 2) & (cmax_e - cmin_e >= 2)

    # center of mass in expanded-bbox coordinates, rounded half-up —
    # integer sums keep the float64 division identical to
    # ndimage.center_of_mass on the cropped mask
    icom_y = np.floor((sum_y - cnt * rmin_e) / cnt + 0.5).astype(np.int64)
    icom_x = np.floor((sum_x - cnt * cmin_e) / cnt + 0.5).astype(np.int64)
    anchor_y = rmin_e + icom_y - 1  # offset = row - anchor (1-based grid)
    anchor_x = cmin_e + icom_x - 1

    y_off = (ys - anchor_y[lab]).astype(np.float32)
    x_off = (xs - anchor_x[lab]).astype(np.float32)

    # per-instance normalization denominators over the signed halves
    neg_y = np.zeros(k, np.float32)
    pos_y = np.zeros(k, np.float32)
    neg_x = np.zeros(k, np.float32)
    pos_x = np.zeros(k, np.float32)
    np.minimum.at(neg_y, lab, y_off)
    np.maximum.at(pos_y, lab, y_off)
    np.minimum.at(neg_x, lab, x_off)
    np.maximum.at(pos_x, lab, x_off)

    def _norm(off, neg, pos):
        dn = np.where(neg < 0, -neg, 1.0).astype(np.float32)[lab]
        dp = np.where(pos > 0, pos, 1.0).astype(np.float32)[lab]
        return np.where(off < 0, off / dn, np.where(off > 0, off / dp, off))

    y_off = _norm(y_off, neg_y, pos_y)
    x_off = _norm(x_off, neg_x, pos_x)

    keep = ok[lab]
    y_map[ys[keep], xs[keep]] = y_off[keep]
    x_map[ys[keep], xs[keep]] = x_off[keep]
    return np.dstack([x_map, y_map])


def gen_targets(ann, crop_shape, **kwargs):
    """{np_map, hv_map} center-cropped to crop_shape
    (reference targets.py:100-114)."""
    hv_map = gen_instance_hv_map(ann, crop_shape)
    np_map = np.asarray(ann).copy()
    np_map[np_map > 0] = 1
    return {
        "hv_map": cropping_center(hv_map, crop_shape),
        "np_map": cropping_center(np_map, crop_shape),
    }
