"""Instance-id helpers of the inference managers.

The port's copy of `remap_label` from hover_net_tpu/metrics/stats.py
(same name, same behaviour).
"""

from __future__ import annotations

import numpy as np


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
