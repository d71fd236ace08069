"""Offline evaluation drivers (compute_stats.py parity).

The port's copy of hover_net_tpu/metrics/eval.py (same names, same
printed line, same return values).

run_nuclei_inst_stat: per-image [DICE, AJI, DQ, SQ, PQ, AJI+] averaged.
run_nuclei_type_stat: centroid pairing (radius 12) -> detection F1 and
per-type F1 with weights [2, 2, 1, 1] (compute_stats.py:22-179).
"""

from __future__ import annotations

import glob
import os

import numpy as np
import scipy.io as sio

from .stats import (
    get_dice_1,
    get_fast_aji,
    get_fast_aji_plus,
    get_fast_pq,
    pair_coordinates,
    remap_label,
)


def run_nuclei_inst_stat(pred_dir, true_dir, print_img_stats=False, ext=".mat"):
    files = sorted(glob.glob(f"{pred_dir}/*{ext}"))
    assert files, f"no prediction {ext} files under {pred_dir}"
    metrics = [[], [], [], [], [], []]
    for path in files:
        basename = os.path.basename(path).split(".")[0]
        true = sio.loadmat(os.path.join(true_dir, basename + ".mat"))["inst_map"]
        pred = sio.loadmat(path)["inst_map"]
        true = remap_label(true.astype("int32"))
        pred = remap_label(pred.astype("int32"))

        pq_info = get_fast_pq(true, pred, match_iou=0.5)[0]
        metrics[0].append(get_dice_1(true, pred))
        metrics[1].append(get_fast_aji(true, pred))
        metrics[2].append(pq_info[0])
        metrics[3].append(pq_info[1])
        metrics[4].append(pq_info[2])
        metrics[5].append(get_fast_aji_plus(true, pred))
        if print_img_stats:
            print(basename, [f"{m[-1]:.5f}" for m in metrics])

    metrics = np.array(metrics)
    means = metrics.mean(axis=-1)
    np.set_printoptions(formatter={"float": "{: 0.5f}".format})
    print(means)
    return metrics


def run_nuclei_type_stat(pred_dir, true_dir, type_uid_list=None, exhaustive=True):
    files = sorted(glob.glob(f"{pred_dir}/*.mat"))
    assert files, f"no prediction .mat files under {pred_dir}"
    paired_all, unpaired_true_all, unpaired_pred_all = [], [], []
    true_types_all, pred_types_all = [], []
    true_offset = pred_offset = 0
    for path in files:
        basename = os.path.basename(path).split(".")[0]
        t = sio.loadmat(os.path.join(true_dir, basename + ".mat"))
        p = sio.loadmat(path)

        def unpack(info):
            cent = info["inst_centroid"].astype("float32")
            typ = info["inst_type"].astype("int32")
            if cent.shape[0] != 0:
                typ = typ[:, 0]
            else:
                cent = np.array([[0.0, 0.0]], np.float32)
                typ = np.array([0], np.int32)
            return cent, typ

        tc, tt = unpack(t)
        pc, pt = unpack(p)

        paired, unpaired_t, unpaired_p = pair_coordinates(tc, pc, 12)
        if paired.shape[0] != 0:
            paired = paired + np.array([true_offset, pred_offset])
            paired_all.append(paired)
        unpaired_true_all.append(unpaired_t + true_offset)
        unpaired_pred_all.append(unpaired_p + pred_offset)
        true_types_all.append(tt)
        pred_types_all.append(pt)
        true_offset += tt.shape[0]
        pred_offset += pt.shape[0]

    paired_all = (np.concatenate(paired_all) if paired_all
                  else np.zeros((0, 2), np.int64))
    unpaired_true_all = np.concatenate(unpaired_true_all)
    unpaired_pred_all = np.concatenate(unpaired_pred_all)
    true_types_all = np.concatenate(true_types_all)
    pred_types_all = np.concatenate(pred_types_all)

    paired_true_t = true_types_all[paired_all[:, 0]]
    paired_pred_t = pred_types_all[paired_all[:, 1]]
    unpaired_true_t = true_types_all[unpaired_true_all]
    unpaired_pred_t = pred_types_all[unpaired_pred_all]

    def f1_type(type_id, w):
        sel = (paired_true_t == type_id) | (paired_pred_t == type_id)
        pt_, pp_ = paired_true_t[sel], paired_pred_t[sel]
        tp_dt = ((pt_ == type_id) & (pp_ == type_id)).sum()
        tn_dt = ((pt_ != type_id) & (pp_ != type_id)).sum()
        fp_dt = ((pt_ != type_id) & (pp_ == type_id)).sum()
        fn_dt = ((pt_ == type_id) & (pp_ != type_id)).sum()
        if not exhaustive:
            fp_dt -= (pt_ == -1).sum()
        fp_d = (unpaired_pred_t == type_id).sum()
        fn_d = (unpaired_true_t == type_id).sum()
        return (2 * (tp_dt + tn_dt)) / (
            2 * (tp_dt + tn_dt)
            + w[0] * fp_dt + w[1] * fn_dt + w[2] * fp_d + w[3] * fn_d
        )

    tp_d = paired_pred_t.shape[0]
    fp_d = unpaired_pred_t.shape[0]
    fn_d = unpaired_true_t.shape[0]
    tp_tn_dt = (paired_pred_t == paired_true_t).sum()
    fp_fn_dt = (paired_pred_t != paired_true_t).sum()
    if not exhaustive:
        fp_fn_dt -= (paired_true_t == -1).sum()
    acc_type = tp_tn_dt / (tp_tn_dt + fp_fn_dt) if (tp_tn_dt + fp_fn_dt) else 0.0
    f1_d = 2 * tp_d / (2 * tp_d + fp_d + fn_d)

    if type_uid_list is None:
        type_uid_list = np.unique(true_types_all).tolist()
    results = [f1_d, acc_type] + [
        f1_type(t, [2, 2, 1, 1]) for t in type_uid_list
    ]
    np.set_printoptions(formatter={"float": "{: 0.5f}".format})
    print(np.array(results))
    return results
