"""Host (NumPy/cv2) post-processing: the oracle HV maps -> instance map,
and the finalize: instance label map or device tables -> per-nucleus
info dicts.

The port's copy of hover_net_tpu/ops/post_proc_host.py (same names,
same behaviour): `proc_np_hv` and `process`, the host oracle,
algorithmically the reference pipeline (models/hovernet/post_proc.py:
26-90: threshold, Sobel-21 energy of the min-max-normalised HV maps,
markers, priority-flood watershed from ops/cc_np.py), which the tile
manager runs with `device_post_proc=False`; `extract_instance_info` from
a label map, `instance_info_from_tables` from the device-computed
tables, and their helpers. The native calls go to the port's own
library (ops/instance_table.py).
"""

from __future__ import annotations

import cv2
import numpy as np

from ..metrics.stats import remap_label
from .cc_np import (
    binary_fill_holes,
    binary_opening,
    ellipse_structuring_element,
    label as cc_label,
    remove_small_objects,
    watershed,
)
from .instance_table import (
    apply_lut,
    instance_table,
    trace_contours,
    trace_contours_coo,
)


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
    blb = cc_label(blb)[0]
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
    marker = cc_label(marker)[0]
    marker = remove_small_objects(marker, min_size=10)

    return watershed(dist, markers=marker, mask=blb).astype(np.int32)


def extract_instance_info(pred_inst, pred_type=None, n_types: int = 16):
    """Per-instance bbox / centroid / contour (+ majority-vote type).

    Returns ``(pred_inst, inst_info)`` where inst_info matches the output
    contract of post_proc.py:94-186 — dict[id] = {bbox, centroid,
    contour, type, type_prob} with (x, y) centroid/contour coordinates
    and bbox as [[rmin, cmin], [rmax, cmax]] — and pred_inst is kept in
    EXACT sync with the dict: instances whose contour degenerates to
    fewer than 3 points (1-2 px watershed artifacts) are erased from the
    returned map and the remaining ids renumbered 1..N, so every nonzero
    map id always has a dict entry.

    bbox/centroid/size/type-histograms come from one O(area) native pass
    and contours from one native border-following pass; without a
    compiler the per-instance cv2 loop on bbox crops is the fallback.

    Requires contiguous instance ids 1..N (remap first).
    """
    pred_inst = np.ascontiguousarray(pred_inst, np.int32)
    inst_info, lut = instance_info_lut(pred_inst, pred_type, n_types)
    if lut is not None:
        pred_inst = apply_lut(pred_inst.copy(), lut)
    return pred_inst, inst_info


def instance_info_lut(pred_inst, pred_type=None, n_types: int = 16):
    """`extract_instance_info` without the map: (inst_info, lut), where
    `lut` (int32, one entry an id of `pred_inst` and 0) renumbers the map
    as the dict is keyed, or is None where every instance was kept. For a
    caller that holds the map elsewhere (the WSI manager's labels on the
    device). `pred_inst`: ids 1..N."""
    pred_inst = np.ascontiguousarray(pred_inst, np.int32)
    bbox_t, centroid_t, size_t, hist_t = instance_table(
        pred_inst, pred_type, n_types=n_types
    )
    native_contours = trace_contours(pred_inst, bbox_t)
    if native_contours is None:
        # no compiler available: per-instance cv2 on bbox crops
        native_contours = []
        for idx in range(bbox_t.shape[0]):
            if size_t[idx] == 0:
                native_contours.append(np.zeros((0, 2), np.int32))
                continue
            rmin, rmax, cmin, cmax = (int(v) for v in bbox_t[idx])
            inst_mask = (pred_inst[rmin:rmax, cmin:cmax] == idx + 1).astype(
                np.uint8)
            contours = cv2.findContours(
                inst_mask, cv2.RETR_TREE, cv2.CHAIN_APPROX_SIMPLE
            )
            if not contours[0]:
                native_contours.append(np.zeros((0, 2), np.int32))
                continue
            contour = np.squeeze(contours[0][0].astype("int32"))
            if contour.ndim != 2:
                contour = contour.reshape(-1, 2)
            contour = contour + np.asarray([[cmin, rmin]])
            native_contours.append(contour)

    inst_info, skipped = assemble_instance_info(
        bbox_t, centroid_t, size_t, hist_t, native_contours,
        typed=pred_type is not None,
    )

    if skipped:
        # erase artifact ids and renumber survivors 1..N so the map and
        # the dict cannot desynchronize
        lut = np.zeros(bbox_t.shape[0] + 1, np.int32)
        keep = sorted(inst_info)
        lut[keep] = np.arange(1, len(keep) + 1, dtype=np.int32)
        return {int(lut[k]): inst_info[k] for k in keep}, lut
    return inst_info, None


def assemble_instance_info(bbox_t, centroid_t, size_t, hist_t, contours,
                           typed: bool):
    """(tables, contours) -> ({id: info}, skipped ids). The shared tail
    of extract_instance_info and instance_info_from_tables; instances
    whose contour has < 3 points are skipped (post_proc.py:140-143).

    The bboxes, centroids and majority votes are computed for all ids at
    once; each entry's `bbox` and `centroid` are its own rows of those
    arrays, so the loop only builds the dicts."""
    n = bbox_t.shape[0]
    size_t = np.asarray(size_t)
    bboxes = np.asarray(bbox_t, np.int64)[:, [0, 2, 1, 3]].reshape(n, 2, 2)
    centroids = np.array(centroid_t, np.float64).reshape(n, 2)
    if typed:
        hist = np.asarray(hist_t)
        order = np.argsort(-hist, axis=1, kind="stable")
        types = order[:, 0].copy()
        if hist.shape[1] > 1:
            # background wins only where no other type was voted
            rows = np.arange(n)
            swap = (types == 0) & (hist[rows, order[:, 1]] > 0)
            types[swap] = order[swap, 1]
        probs = hist[np.arange(n), types] / (size_t + 1.0e-6)
    inst_info = {}
    skipped = []
    for idx in np.flatnonzero(size_t).tolist():
        contour = contours[idx]
        if contour.shape[0] < 3:
            skipped.append(idx + 1)
            continue
        info = {
            "bbox": bboxes[idx],
            "centroid": centroids[idx],
            "contour": contour,
            "type_prob": None,
            "type": None,
        }
        if typed:
            info["type"] = int(types[idx])
            info["type_prob"] = float(probs[idx])
        inst_info[idx + 1] = info
    return inst_info, skipped


def sums_from_runs(yx, lm, n_labels: int):
    """Exact per-instance size and coordinate sums from the boundary
    COO alone (the tables built with with_sums=False).

    Every horizontal run of an instance starts and ends on a boundary
    pixel (its W/E neighbour differs), so pairing run starts with run
    ends per (label, row) enumerates every interior run:
    size = sum(len), sum_x = sum of arithmetic series, sum_y = y*len.

    yx: [n] int32 packed (y << 16) | x; lm: [n] int32 packed
    (label << 8) | neighbour-bitmask (bit 0 = E same, bit 4 = W same,
    post_proc_device._DIRS8 order).
    Returns (size [n_labels+1] int64, sum_yx [n_labels+1, 2] int64) or
    None when the table is inconsistent (caller falls back to the
    dense-map path)."""
    y = (yx >> 16).astype(np.int64)
    x = (yx & 0xFFFF).astype(np.int64)
    lab = (lm >> 8).astype(np.int64)
    m8 = lm & 0xFF
    is_start = (m8 & 0x10) == 0  # W neighbour is a different label
    is_end = (m8 & 0x01) == 0    # E neighbour is a different label

    def pick(mask):
        l, yy, xx = lab[mask], y[mask], x[mask]
        o = np.lexsort((xx, yy, l))
        return l[o], yy[o], xx[o]

    ls, ys, xs = pick(is_start)
    le, ye, xe = pick(is_end)
    if (ls.shape != le.shape or np.any(ls != le) or np.any(ys != ye)
            or np.any(xe < xs) or (ls.size and ls.max() > n_labels)):
        return None
    run = xe - xs + 1
    size = np.bincount(ls, weights=run, minlength=n_labels + 1)
    sum_y = np.bincount(ls, weights=ys * run, minlength=n_labels + 1)
    sum_x = np.bincount(ls, weights=(xs + xe) * run // 2,
                        minlength=n_labels + 1)
    return (size.astype(np.int64),
            np.stack([sum_y, sum_x], axis=1).astype(np.int64))


def instance_info_from_tables(tables, n_labels: int, typed: bool):
    """Build the inst_info dict from DEVICE-computed tables — the full
    instance map never crosses to the host (ops/post_proc_device
    .instance_tables + the native COO tracer).

    tables: dict of HOST numpy arrays (the pulled device tables).
    Returns (inst_info, lut | None): lut renumbers surviving ids 1..N
    (apply to the map if/when it is pulled) or None when nothing was
    skipped. Returns (None, None) when a capacity was exceeded — the
    caller falls back to the full-map path.
    """
    if n_labels == 0:
        return {}, None
    stat_cap = np.asarray(tables["bbox"]).shape[0] - 1
    coo = np.asarray(tables["coo"])
    coo_n = int(tables["coo_n"])
    if n_labels > stat_cap or coo_n > coo.shape[0]:
        return None, None

    yx = coo[:coo_n, 0]
    lm = coo[:coo_n, 1]
    if "size" in tables:
        size = np.asarray(tables["size"])
        # int32 y/x-coordinate sums are exact below ~1e6 px per
        # instance; a degenerate giant blob would overflow them
        if n_labels and int(size[1 : n_labels + 1].max()) > 400_000:
            return None, None
        size_full = size.astype(np.int64)
        sum_full = np.asarray(tables["sum_yx"]).astype(np.int64)
    else:
        # size/centroid reconstructed from boundary-run pairing (the
        # device skipped its only full-pixel scatter — int64 host
        # sums, no overflow bound)
        rs = sums_from_runs(yx, lm, n_labels)
        if rs is None:
            return None, None
        size_full, sum_full = rs

    contours = trace_contours_coo(yx, lm, n_labels)
    if contours is None:
        return None, None

    bbox_t = np.asarray(tables["bbox"])[1 : n_labels + 1]
    sum_yx = sum_full[1 : n_labels + 1]
    size_t = size_full[1 : n_labels + 1]
    with np.errstate(invalid="ignore"):
        centroid_t = np.stack(
            [sum_yx[:, 1] / np.maximum(size_t, 1),
             sum_yx[:, 0] / np.maximum(size_t, 1)],
            axis=1,
        )
    hist_t = (np.asarray(tables["type_hist"])[1 : n_labels + 1]
              if typed else None)
    inst_info, skipped = assemble_instance_info(
        bbox_t, centroid_t, size_t, hist_t, contours, typed=typed
    )
    lut = None
    if skipped:
        lut = np.zeros(n_labels + 1, np.int32)
        keep = sorted(inst_info)
        lut[keep] = np.arange(1, len(keep) + 1, dtype=np.int32)
        inst_info = {int(lut[k]): inst_info[k] for k in keep}
    return inst_info, lut


def process(pred_map, nr_types=None, return_centroids=False):
    """Full tile post-processing (post_proc.py:94-186).

    pred_map: (H, W, C) with channels [tp?, np, hv_x, hv_y].
    Returns (inst_map int32, inst_info_dict | None).
    """
    pred_type = None
    if nr_types is not None:
        pred_type = pred_map[..., 0].astype(np.int32)
        pred_inst_in = pred_map[..., 1:]
    else:
        pred_inst_in = pred_map

    pred_inst = proc_np_hv(np.squeeze(pred_inst_in))
    # contiguous ids 1..N (the reference leaves gaps from removed small
    # markers and warns "ID MAY NOT BE CONTIGUOUS", post_proc.py:184;
    # we normalise — downstream consumers only rely on dict-key/map
    # agreement)
    pred_inst = remap_label(pred_inst)

    inst_info = None
    if return_centroids or nr_types is not None:
        pred_inst, inst_info = extract_instance_info(pred_inst, pred_type)
    return pred_inst, inst_info
