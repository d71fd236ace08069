"""Instance-segmentation metrics: DICE, AJI, AJI+, PQ, detection pairing,
and the instance-id helper of the inference managers.

The port's copy of hover_net_tpu/metrics/stats.py (same names, same
behaviour). Metric definitions match metrics/stats_utils.py in the
reference; one confusion matrix from a single bincount over the joint
(true, pred) label image replaces its per-instance mask loops.

Instance IDs must be contiguous (call remap_label first), as in the
reference.
"""

from __future__ import annotations

import numpy as np
import scipy.spatial
from scipy.optimize import linear_sum_assignment


def _confusion(true, pred):
    """inter[t, p] = |true_t ∩ pred_p| for t in 0..T, p in 0..P (incl bg)."""
    true = np.asarray(true, np.int64)
    pred = np.asarray(pred, np.int64)
    n_t = int(true.max()) + 1
    n_p = int(pred.max()) + 1
    joint = true.ravel() * n_p + pred.ravel()
    inter = np.bincount(joint, minlength=n_t * n_p).reshape(n_t, n_p)
    t_sizes = inter.sum(axis=1)
    p_sizes = inter.sum(axis=0)
    return inter.astype(np.float64), t_sizes.astype(np.float64), p_sizes.astype(np.float64)


def get_dice_1(true, pred):
    """Binary foreground dice (stats_utils.py:323-332)."""
    t = np.asarray(true) > 0
    p = np.asarray(pred) > 0
    denom = t.sum() + p.sum()
    return 2.0 * np.logical_and(t, p).sum() / denom


def get_fast_aji(true, pred):
    """MoNuSeg AJI: each GT greedily takes its best-IoU prediction; a
    prediction may be reused (stats_utils.py:11-89)."""
    inter, t_sizes, p_sizes = _confusion(true, pred)
    if inter.shape[0] <= 1 or inter.shape[1] <= 1:
        return 0.0
    ii = inter[1:, 1:]
    union = t_sizes[1:, None] + p_sizes[None, 1:] - ii
    iou = ii / (union + 1.0e-6)

    best_pred = np.argmax(iou, axis=1)
    best_iou = np.max(iou, axis=1)
    paired_true = np.nonzero(best_iou > 0.0)[0]
    paired_pred = best_pred[paired_true]

    overall_inter = ii[paired_true, paired_pred].sum()
    overall_union = union[paired_true, paired_pred].sum()

    unpaired_true = np.setdiff1d(np.arange(ii.shape[0]), paired_true)
    unpaired_pred = np.setdiff1d(np.arange(ii.shape[1]), np.unique(paired_pred))
    overall_union += t_sizes[1:][unpaired_true].sum()
    overall_union += p_sizes[1:][unpaired_pred].sum()
    return overall_inter / overall_union


def get_fast_aji_plus(true, pred):
    """AJI+ — Munkres 1-1 maximal pairing variant (stats_utils.py:93-174)."""
    inter, t_sizes, p_sizes = _confusion(true, pred)
    if inter.shape[0] <= 1 or inter.shape[1] <= 1:
        return 0.0
    ii = inter[1:, 1:]
    union = t_sizes[1:, None] + p_sizes[None, 1:] - ii
    iou = ii / (union + 1.0e-6)

    rows, cols = linear_sum_assignment(-iou)
    sel = iou[rows, cols] > 0.0
    paired_true, paired_pred = rows[sel], cols[sel]

    overall_inter = ii[paired_true, paired_pred].sum()
    overall_union = union[paired_true, paired_pred].sum()
    unpaired_true = np.setdiff1d(np.arange(ii.shape[0]), paired_true)
    unpaired_pred = np.setdiff1d(np.arange(ii.shape[1]), paired_pred)
    overall_union += t_sizes[1:][unpaired_true].sum()
    overall_union += p_sizes[1:][unpaired_pred].sum()
    return overall_inter / overall_union


def get_fast_pq(true, pred, match_iou: float = 0.5):
    """Panoptic quality [dq, sq, pq] + pairing info
    (stats_utils.py:178-279). IoU > 0.5 pairs are provably unique; below
    0.5 a Munkres assignment is used.
    """
    assert match_iou >= 0.0
    inter, t_sizes, p_sizes = _confusion(true, pred)
    n_true = inter.shape[0] - 1
    n_pred = inter.shape[1] - 1
    if n_true == 0 or n_pred == 0:
        iou = np.zeros((max(n_true, 0), max(n_pred, 0)))
    else:
        ii = inter[1:, 1:]
        union = t_sizes[1:, None] + p_sizes[None, 1:] - ii
        with np.errstate(divide="ignore", invalid="ignore"):
            iou = np.where(ii > 0, ii / union, 0.0)

    if match_iou >= 0.5:
        matched = iou > match_iou
        paired_true, paired_pred = np.nonzero(matched)
        paired_iou = iou[paired_true, paired_pred]
        paired_true = paired_true + 1
        paired_pred = paired_pred + 1
    else:
        rows, cols = linear_sum_assignment(-iou)
        pi = iou[rows, cols]
        sel = pi > match_iou
        paired_true = rows[sel] + 1
        paired_pred = cols[sel] + 1
        paired_iou = pi[sel]

    unpaired_true = np.setdiff1d(np.arange(1, n_true + 1), paired_true)
    unpaired_pred = np.setdiff1d(np.arange(1, n_pred + 1), paired_pred)

    tp = len(paired_true)
    fp = len(unpaired_pred)
    fn = len(unpaired_true)
    dq = tp / (tp + 0.5 * fp + 0.5 * fn) if (tp + fp + fn) else 0.0
    sq = paired_iou.sum() / (tp + 1.0e-6)
    return [dq, sq, dq * sq], [
        list(paired_true),
        list(paired_pred),
        list(unpaired_true),
        list(unpaired_pred),
    ]


def get_fast_dice_2(true, pred):
    """Ensemble dice over overlapping instance pairs
    (stats_utils.py:283-319)."""
    inter, t_sizes, p_sizes = _confusion(true, pred)
    if inter.shape[0] <= 1 or inter.shape[1] <= 1:
        return 0.0
    ii = inter[1:, 1:]
    mask = ii > 0
    total_inter = ii[mask].sum()
    sizes = t_sizes[1:, None] + p_sizes[None, 1:]
    total = sizes[mask].sum()
    return 2.0 * total_inter / total if total else 0.0


# alias: the reference's slow pseudocode version computes the same value
get_dice_2 = get_fast_dice_2


def remap_label(pred, by_size: bool = False):
    """Make instance IDs contiguous 1..N (stats_utils.py:360-389)."""
    pred = np.asarray(pred)
    pred_ids = np.unique(pred)
    pred_ids = pred_ids[pred_ids != 0]
    if pred_ids.size == 0:
        return pred
    if by_size:
        sizes = np.array([(pred == i).sum() for i in pred_ids])
        pred_ids = pred_ids[np.argsort(-sizes, kind="stable")]
    lut = np.zeros(int(pred.max()) + 1, np.int32)
    lut[pred_ids] = np.arange(1, len(pred_ids) + 1)
    return lut[pred]


def pair_coordinates(set_a, set_b, radius):
    """Munkres centroid pairing within `radius`
    (stats_utils.py:393-429). Returns (pairs Nx2, unpaired_a, unpaired_b).
    """
    dist = scipy.spatial.distance.cdist(set_a, set_b, metric="euclidean")
    rows, cols = linear_sum_assignment(dist)
    cost = dist[rows, cols]
    paired_a = rows[cost <= radius]
    paired_b = cols[cost <= radius]
    pairing = np.stack([paired_a, paired_b], axis=-1)
    unpaired_a = np.delete(np.arange(set_a.shape[0]), paired_a)
    unpaired_b = np.delete(np.arange(set_b.shape[0]), paired_b)
    return pairing, unpaired_a, unpaired_b
