"""Instance horizontal/vertical distance maps (the HV training target).

The port's copy of `gen_targets`, `gen_instance_hv_map` and its helper
`fix_mirror_padding` from hover_net_tpu/ops/targets.py (same names, same
behaviour). The stage probe (cli/probe_pp_stages.py) builds its synthetic
prediction map with it, and the training loader its targets. The fused native
pass comes from the port's own library (ops/instance_table.py); the
NumPy formulation below is its compiler-free fallback.
"""

from __future__ import annotations

import numpy as np
from scipy.sparse import coo_matrix
from scipy.sparse.csgraph import connected_components

from ..utils.crops import cropping_center
from .cc_np import remove_small_objects
from .instance_table import fragment_labels, hv_targets_native


def fix_mirror_padding(ann):
    """Re-label instance fragments duplicated by mirrored shape
    augmentation (reference dataloader/augs.py:18-32).

    Two pixels belong to the same fragment iff they are 4-connected and
    share the same nonzero id. Fragment numbering reproduces the
    reference exactly: ids are visited in ascending order; the fragment
    whose first pixel comes earliest in raster order keeps the original
    id, fragments j = 2..k of that id get `running_max + j`, and the
    running max then advances by k.
    """
    ann = np.asarray(ann)
    out = ann.copy()
    flat = ann.ravel()
    fg_idx = np.flatnonzero(flat)
    if fg_idx.size == 0:
        return out

    h, w = ann.shape
    n = ann.size

    native = fragment_labels(ann)
    if native is not None:
        # one native union-find pass (fragments numbered in first-
        # raster-pixel order, 1-based)
        frag_map, n_frag = native
        frag = frag_map.ravel()[fg_idx] - 1
    else:
        node = np.full(n, -1, np.int64)
        node = node.reshape(h, w)
        node.ravel()[fg_idx] = np.arange(fg_idx.size)

        same_v = (ann[:-1] == ann[1:]) & (ann[:-1] != 0)
        same_h = (ann[:, :-1] == ann[:, 1:]) & (ann[:, :-1] != 0)
        ei = np.concatenate([node[:-1][same_v], node[:, :-1][same_h]])
        ej = np.concatenate([node[1:][same_v], node[:, 1:][same_h]])

        g = coo_matrix(
            (np.ones(ei.size, np.uint8), (ei, ej)),
            shape=(fg_idx.size, fg_idx.size),
        )
        n_frag, frag = connected_components(g, directed=False)

    orig_id = np.zeros(n_frag, flat.dtype)
    orig_id[frag] = flat[fg_idx]

    # per-original-id fragment counts; ids with a single fragment keep it
    vmax = int(orig_id.max())
    present = np.zeros(vmax + 1, bool)
    present[orig_id] = True
    rank = np.cumsum(present) - 1
    id_pos = rank[orig_id]
    frag_count = np.bincount(id_pos)
    if frag_count.max() == 1:
        return out
    first_pix = np.full(n_frag, n, np.int64)
    np.minimum.at(first_pix, frag, fg_idx)

    new_of_frag = orig_id.astype(np.int64).copy()
    running = int(ann.max())
    for p in np.flatnonzero(frag_count > 1):  # ascending id order
        frs = np.flatnonzero(id_pos == p)
        frs = frs[np.argsort(first_pix[frs])]
        k = frs.size
        new_of_frag[frs[1:]] = running + np.arange(2, k + 1)
        running += k
    out.ravel()[fg_idx] = new_of_frag[frag]
    return out


def gen_instance_hv_map(ann, crop_shape):
    """Per-pixel horizontal/vertical offsets from each instance's center
    of mass, normalized to [-1, 1] within the instance
    (reference targets.py:17-96 semantics, vectorized).
    """
    ann = np.asarray(ann)
    hgt, wdt = ann.shape[:2]

    native = hv_targets_native(ann, crop_shape)
    if native is not None:
        # fused C++ pass (bit-exact vs the path below)
        return native

    x_map = np.zeros((hgt, wdt), dtype=np.float32)
    y_map = np.zeros((hgt, wdt), dtype=np.float32)

    fixed_ann = fix_mirror_padding(ann)
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
