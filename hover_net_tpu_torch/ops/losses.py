"""HoVer-Net training losses over NCHW tensors.

Counterpart of hover_net_tpu/ops/losses.py (there over NHWC): the class
and hv channels are dim 1 here. Numerically the reference's
models/hovernet/utils.py:54-172, with its two quirks kept:

- `xentropy_loss` clips with epsilon 1e-7 (10e-8 in the reference);
- `msge_loss` applies the *horizontal* kernel to channel 0 and the
  *vertical* kernel to channel 1 — the reference docstring says the
  opposite of what its code does (utils.py:106-162); the code behaviour
  is kept.

Every term is a ratio of sums over the batch. `reduce`, when given, sums
a tensor of such sums over the replicas of data-parallel training
(`parallel.distributed.all_reduce_sum`), so that each replica gets the
term of the global batch, as the JAX package's meshed step computes it;
`reduce=None` is the one-device graph.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn.functional as F


def _mean(x, reduce=None):
    """The mean of `x`, over the global batch under `reduce`."""
    if reduce is None:
        return torch.mean(x)
    total = reduce(torch.stack([torch.sum(x), x.new_tensor(x.numel())]))
    return total[0] / total[1]


def _sums(reduce, *sums):
    """The local sums, or under `reduce` the global ones (one
    collective)."""
    if reduce is None:
        return sums
    return reduce(torch.stack(sums)).unbind(0)


def xentropy_loss(true, pred, reduction: str = "mean", reduce=None):
    """Manual CE over softmaxed predictions, NCHW (utils.py:54-72).

    `pred` must already be post-softmax probabilities.
    """
    epsilon = 1.0e-7  # 10e-8 in the reference
    pred = pred / torch.sum(pred, dim=1, keepdim=True)
    pred = torch.clamp(pred, epsilon, 1.0 - epsilon)
    loss = -torch.sum(true * torch.log(pred), dim=1, keepdim=True)
    if reduction == "mean":
        return _mean(loss, reduce)
    return _sums(reduce, torch.sum(loss))[0]


def dice_loss(true, pred, smooth: float = 1.0e-3, reduce=None):
    """Per-channel soft dice summed over channels (utils.py:76-83)."""
    inse, l, r = _sums(reduce, torch.sum(pred * true, dim=(0, 2, 3)),
                       torch.sum(pred, dim=(0, 2, 3)),
                       torch.sum(true, dim=(0, 2, 3)))
    loss = 1.0 - (2.0 * inse + smooth) / (l + r + smooth)
    return torch.sum(loss)


def mse_loss(true, pred, reduce=None):
    return _mean((pred - true) ** 2, reduce)


@functools.lru_cache(maxsize=None)
def _sobel_like_kernels(size: int):
    """h/(h^2+v^2) 'Sobel-like' gradient kernels (utils.py:124-145), as
    NumPy arrays."""
    assert size % 2 == 1
    rng = np.arange(-(size // 2), size // 2 + 1, dtype=np.float32)
    # torch.meshgrid default is 'ij': h varies along rows
    h, v = np.meshgrid(rng, rng, indexing="ij")
    kernel_h = h / (h * h + v * v + 1.0e-15)
    kernel_v = v / (h * h + v * v + 1.0e-15)
    return kernel_h, kernel_v


def gradient_hv(hv):
    """Per-channel directional gradients of the NCHW(2) hv map
    (utils.py:148-162: kernel_h on ch0, kernel_v on ch1), 'SAME' zero
    padding."""
    kernel_h, kernel_v = _sobel_like_kernels(5)
    k = torch.from_numpy(np.stack([kernel_h, kernel_v])[:, None])
    k = k.to(device=hv.device, dtype=hv.dtype)
    return F.conv2d(hv, k, padding=2, groups=2)


def msge_loss(true, pred, focus, reduce=None):
    """Masked MSE of hv gradients inside nuclei (utils.py:106-172).

    focus: NHW float/bool mask (the positive NP channel).
    """
    focus = focus.to(pred.dtype)[:, None]
    focus = torch.cat([focus, focus], dim=1)
    err = gradient_hv(pred) - gradient_hv(true)
    loss = focus * (err * err)
    num, den = _sums(reduce, torch.sum(loss), torch.sum(focus))
    return num / (den + 1.0e-8)


LOSS_FNS = {
    "bce": xentropy_loss,
    "dice": dice_loss,
    "mse": mse_loss,
    "msge": msge_loss,
}

# loss weights per branch (models/hovernet/opt.py:47-52)
DEFAULT_LOSS_WEIGHTS = {
    "np": {"bce": 1.0, "dice": 1.0},
    "hv": {"mse": 1.0, "msge": 1.0},
    "tp": {"bce": 1.0, "dice": 1.0},
}


def hovernet_loss(pred_dict, true_dict, focus, weights=None, reduce=None):
    """Total weighted loss + per-term scalars (run_desc.py:67-79).

    pred_dict: post-softmax np/tp probs + raw hv, NCHW. true_dict:
    one-hot np/tp + hv, NCHW. focus: positive-class NP mask (NHW).
    reduce: None, or the sum over the replicas that makes every term the
    global batch's.
    """
    weights = weights or DEFAULT_LOSS_WEIGHTS
    terms = {}
    total = 0.0
    for branch, branch_losses in weights.items():
        if branch not in pred_dict:
            continue
        for name, w in branch_losses.items():
            fn = LOSS_FNS[name]
            if name == "msge":
                val = fn(true_dict[branch], pred_dict[branch], focus,
                         reduce=reduce)
            else:
                val = fn(true_dict[branch], pred_dict[branch], reduce=reduce)
            terms[f"loss_{branch}_{name}"] = val
            total = total + w * val
    terms["overall_loss"] = total
    return total, terms
