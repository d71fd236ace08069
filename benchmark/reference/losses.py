"""HoVer-Net training loss over NCHW tensors, for the weights recipe.

A frozen copy of hover_net_tpu_torch/ops/losses.py (numerically the
reference's models/hovernet/utils.py:54-172), one device, no cross-replica
reduction: np and tp take cross-entropy (clipped at 1e-7) plus soft dice,
hv takes MSE plus the MSE of its Sobel-like gradients inside nuclei
(kernel h on channel 0, v on channel 1, as the reference's code does).
Every weight is 1 (models/hovernet/opt.py:47-52).
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def xentropy(true, pred):
    pred = pred / torch.sum(pred, dim=1, keepdim=True)
    pred = torch.clamp(pred, 1.0e-7, 1.0 - 1.0e-7)
    return torch.mean(-torch.sum(true * torch.log(pred), dim=1, keepdim=True))


def dice(true, pred, smooth: float = 1.0e-3):
    inse = torch.sum(pred * true, dim=(0, 2, 3))
    l, r = torch.sum(pred, dim=(0, 2, 3)), torch.sum(true, dim=(0, 2, 3))
    return torch.sum(1.0 - (2.0 * inse + smooth) / (l + r + smooth))


def mse(true, pred):
    return torch.mean((pred - true) ** 2)


def _gradient_hv(hv):
    r = np.arange(-2, 3, dtype=np.float32)
    h, v = np.meshgrid(r, r, indexing="ij")
    k = np.stack([h / (h * h + v * v + 1.0e-15), v / (h * h + v * v + 1.0e-15)])
    k = torch.from_numpy(k[:, None]).to(device=hv.device, dtype=hv.dtype)
    return F.conv2d(hv, k, padding=2, groups=2)


def msge(true, pred, focus):
    focus = focus.to(pred.dtype)[:, None].repeat(1, 2, 1, 1)
    err = _gradient_hv(pred) - _gradient_hv(true)
    return torch.sum(focus * err * err) / (torch.sum(focus) + 1.0e-8)


def hovernet_loss(out, np_map, hv_map, tp_map=None):
    """out: {branch: NCHW logits}; np_map, tp_map: NHW int; hv_map: NHW2.
    Returns (total, {term name: value})."""
    dt = out["np"].dtype
    np_true = F.one_hot(np_map.long(), 2).permute(0, 3, 1, 2).to(dt)
    np_pred = torch.softmax(out["np"], dim=1)
    hv_true = hv_map.permute(0, 3, 1, 2).to(dt)
    hv_pred = out["hv"]
    terms = {"np_bce": xentropy(np_true, np_pred),
             "np_dice": dice(np_true, np_pred),
             "hv_mse": mse(hv_true, hv_pred),
             "hv_msge": msge(hv_true, hv_pred, np_map.to(dt))}
    if tp_map is not None and "tp" in out:
        n = out["tp"].shape[1]
        tp_true = F.one_hot(tp_map.long(), n).permute(0, 3, 1, 2).to(dt)
        tp_pred = torch.softmax(out["tp"], dim=1)
        terms["tp_bce"] = xentropy(tp_true, tp_pred)
        terms["tp_dice"] = dice(tp_true, tp_pred)
    return sum(terms.values()), terms
