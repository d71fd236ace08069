"""Validation-epoch aggregation (run_desc.py:263-344 parity).

The port's copy of hover_net_tpu/train/validation.py (same names, same
behaviour).

Computes np_acc / np_dice, per-type dice, hv_mse over the accumulated
raw outputs of the validation engine plus a true-vs-pred panel image.
"""

from __future__ import annotations

import numpy as np

from ..utils.viz import viz_train_panel


def proc_valid_step_output(raw_data, nr_types=None, viz_samples: int = 8):
    track = {"scalar": {}, "image": {}}

    prob_np = np.asarray(raw_data["prob_np"])
    true_np = np.asarray(raw_data["true_np"])
    pred_np = (prob_np > 0.5).astype(np.int32)

    inter = ((pred_np == 1) & (true_np == 1)).sum()
    total = (pred_np == 1).sum() + (true_np == 1).sum()
    correct = (pred_np == true_np).sum()
    nr_pixels = true_np.size
    track["scalar"]["np_acc"] = correct / nr_pixels
    track["scalar"]["np_dice"] = 2 * inter / (total + 1.0e-8)

    if nr_types is not None:
        pred_tp = np.asarray(raw_data["pred_tp"])
        true_tp = np.asarray(raw_data["true_tp"])
        for t in range(nr_types):
            it = ((pred_tp == t) & (true_tp == t)).sum()
            tt = (pred_tp == t).sum() + (true_tp == t).sum()
            track["scalar"][f"tp_dice_{t}"] = 2 * it / (tt + 1.0e-8)

    pred_hv = np.asarray(raw_data["pred_hv"])
    true_hv = np.asarray(raw_data["true_hv"])
    track["scalar"]["hv_mse"] = ((pred_hv - true_hv) ** 2).sum() / nr_pixels

    imgs = np.asarray(raw_data["imgs"])
    n = min(viz_samples, len(imgs))
    idx = np.random.randint(0, len(imgs), size=(n,))
    kwargs = {}
    if nr_types is not None:
        kwargs = {"true_tp": np.asarray(raw_data["true_tp"])[idx],
                  "pred_tp": np.asarray(raw_data["pred_tp"])[idx],
                  "nr_types": nr_types}
    track["image"]["output"] = viz_train_panel(
        imgs[idx].astype(np.uint8), true_np[idx], prob_np[idx],
        true_hv[idx], pred_hv[idx], **kwargs,
    )
    return track


def viz_train_step_output(raw, nr_types=None):
    """Panel from a train step's raw dict (run_desc.py:201-256)."""
    imgs = np.asarray(raw["img"]).astype(np.uint8)
    true_np, pred_np = (np.asarray(v) for v in raw["np"])
    true_hv, pred_hv = (np.asarray(v) for v in raw["hv"])
    kwargs = {}
    if nr_types is not None and "tp" in raw:
        true_tp, pred_tp = (np.asarray(v) for v in raw["tp"])
        kwargs = {"true_tp": true_tp, "pred_tp": pred_tp, "nr_types": nr_types}
    return viz_train_panel(imgs, true_np, pred_np, true_hv, pred_hv, **kwargs)
