"""HoVer-Net building blocks as NCHW PyTorch modules.

Counterpart of hover_net_tpu/models/blocks.py. Submodule names follow the
reference PyTorch module tree (net_utils.py), so `state_dict()` keys are
the reference's ('d1.units.0.conv1/bn.weight', ...) and a reference
`.tar` loads with strict=True.

Geometry matches the JAX package exactly:
- XLA/TF 'SAME' padding splits the total pad with the smaller half first,
  so a stride-2 3x3 conv on an even input pads 0 top/left and 1
  bottom/right (`same_pad`), not torch's symmetric `padding=1`;
- BatchNorm eps 1e-5 (torch's default), momentum 0.1 (flax 0.9); in
  train mode the running variance takes the *biased* batch variance, as
  flax does, where `nn.BatchNorm2d` would take the unbiased one
  (`BatchNorm2d` below);
- the encoder's freeze cut (`ResidualBlock(..., freeze_units=True)`)
  detaches each unit tower and leaves the shortcut conv and the closing
  BN live, as the JAX package's `stop_gradient` and the reference's
  `set_grad_enabled(False)` (net_utils.py:256-263) do;
- the dense concat center-crops the running map with
  utils/crops.crop_to_shape;
- the grouped decoder conv is a native `groups=4` conv.
"""

from __future__ import annotations

import contextlib
from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.crops import crop_to_shape

BN_EPS = 1e-5


def same_pad(x: torch.Tensor, ksize: int, stride: int) -> torch.Tensor:
    """Zero-pad NCHW `x` as XLA 'SAME' does for a (ksize, stride) conv:
    total = max((ceil(n / stride) - 1) * stride + ksize - n, 0), with
    total // 2 before and the rest after."""
    pads = []
    for n in (x.shape[3], x.shape[2]):  # F.pad order: W then H
        total = max((-(-n // stride) - 1) * stride + ksize - n, 0)
        pads += [total // 2, total - total // 2]
    if not any(pads):
        return x
    return F.pad(x, pads)


class BatchNorm2d(nn.BatchNorm2d):
    """`nn.BatchNorm2d` whose train-mode update of `running_var` folds in
    the biased batch variance, as flax's BatchNorm does
    (hover_net_tpu/models/blocks.py), instead of torch's unbiased one.

    The normalisation is torch's own (biased batch variance in both).
    torch updates a copy of the running variance to
    (1 - m) rv + m * var * n / (n - 1), over the n = N*H*W elements of a
    channel; the buffer takes (1 - m) rv + m * var from it, on the
    C-element vector only. The copy keeps the buffer out of autograd's
    saved tensors.

    Inside `global_batch_stats(model, reduce)` a train-mode forward takes
    the moments over the global batch of data-parallel training instead:
    `reduce` sums a tensor over the replicas, differentiably."""

    reduce = None

    def forward(self, x):
        if not (self.training and self.track_running_stats):
            return super().forward(x)
        self._check_input_dim(x)
        self.num_batches_tracked.add_(1)
        if self.reduce is not None:
            return self._global_forward(x)
        keep = 1.0 - self.momentum
        rv = self.running_var.clone()
        out = F.batch_norm(x, self.running_mean, rv, self.weight, self.bias,
                           True, self.momentum, self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            unbiased = rv.sub(self.running_var, alpha=keep)  # m * var_u
            self.running_var.mul_(keep).add_(unbiased, alpha=(n - 1) / n)
        return out

    def _global_forward(self, x):
        """Normalise by the mean and the biased variance of the global
        batch, in two passes (the sum and count, then the sum of squared
        deviations: no E[x^2] - E[x]^2 cancellation), and fold both into
        the running stats. The output takes the input's dtype, as
        `F.batch_norm` gives it."""
        c = x.shape[1]
        count = x.new_full((1,), x.numel() // c)
        sums = self.reduce(torch.cat([x.sum(dim=(0, 2, 3)), count]))
        n = sums[c]
        mean = sums[:c] / n
        dev = x - mean[None, :, None, None]
        var = self.reduce(dev.square().sum(dim=(0, 2, 3))) / n
        scale = torch.rsqrt(var + self.eps) * self.weight
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
        out = dev * scale[None, :, None, None] + self.bias[None, :, None, None]
        return out.to(x.dtype)


@contextlib.contextmanager
def global_batch_stats(model: nn.Module, reduce):
    """Within the block, every `BatchNorm2d` of `model` in train mode takes
    its moments over the global batch, `reduce` summing over the replicas
    (`parallel.distributed.all_reduce_sum`); `reduce=None` leaves them
    per replica."""
    if reduce is None:
        yield
        return
    bns = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    for m in bns:
        m.reduce = reduce
    try:
        yield
    finally:
        for m in bns:
            del m.reduce


def _bn(ch: int) -> BatchNorm2d:
    return BatchNorm2d(ch, eps=BN_EPS)


def _conv(cin: int, cout: int, k: int, stride: int = 1, groups: int = 1,
          bias: bool = False) -> nn.Conv2d:
    return nn.Conv2d(cin, cout, k, stride=stride, padding=0, groups=groups,
                     bias=bias)


class ConvBNRelu(nn.Module):
    """Stem `conv0`: kxk conv -> BN -> ReLU, 'SAME' (fast mode) or 'VALID'.
    Children '/' and 'bn' as in the reference (state keys 'conv0./.weight',
    'conv0.bn.*')."""

    def __init__(self, cin: int, cout: int, ksize: int, same: bool):
        super().__init__()
        self.ksize = ksize
        self.same = same
        self.add_module("/", _conv(cin, cout, ksize))
        self.bn = _bn(cout)

    def forward(self, x):
        if self.same:
            x = same_pad(x, self.ksize, 1)
        return F.relu(self.bn(self._modules["/"](x)))


class ResidualUnit(nn.Module):
    """One pre-activation bottleneck unit (1x1 -> kxk 'SAME' -> 1x1). The
    first unit of a block has no pre-activation (the previous block ends
    with BN+ReLU)."""

    def __init__(self, cin: int, ch: Sequence[int], ksize: int = 3,
                 stride: int = 1, preact: bool = True):
        super().__init__()
        self.ksize = ksize
        self.stride = stride
        self.preact = preact
        if preact:
            self.add_module("preact/bn", _bn(cin))
        self.add_module("conv1", _conv(cin, ch[0], 1))
        self.add_module("conv1/bn", _bn(ch[0]))
        self.add_module("conv2", _conv(ch[0], ch[1], ksize, stride=stride))
        self.add_module("conv2/bn", _bn(ch[1]))
        self.add_module("conv3", _conv(ch[1], ch[2], 1))

    def forward(self, x):
        m = self._modules
        if self.preact:
            x = F.relu(m["preact/bn"](x))
        x = F.relu(m["conv1/bn"](m["conv1"](x)))
        x = same_pad(x, self.ksize, self.stride)
        x = F.relu(m["conv2/bn"](m["conv2"](x)))
        return m["conv3"](x)


class _BNRelu(nn.Module):
    """'blk_bna' / 'preact_bna' wrapper: a child named 'bn', then ReLU."""

    def __init__(self, ch: int):
        super().__init__()
        self.bn = _bn(ch)

    def forward(self, x):
        return F.relu(self.bn(x))


class ResidualBlock(nn.Module):
    """Preact-ResNet group of `count` bottleneck units with the rolling
    shortcut (each unit's sum is the next unit's shortcut) and a 1x1
    strided conv shortcut, closed by BN+ReLU. `freeze_units` runs the
    unit towers without autograd: their parameters get no gradient, and
    the gradient reaches the block's input only through the shortcut."""

    def __init__(self, cin: int, ch: Sequence[int], count: int,
                 stride: int = 1, ksize: int = 3):
        super().__init__()
        self.units = nn.ModuleList(
            ResidualUnit(cin if i == 0 else ch[2], ch, ksize,
                         stride if i == 0 else 1, preact=i != 0)
            for i in range(count)
        )
        self.shortcut = (_conv(cin, ch[-1], 1, stride=stride)
                         if cin != ch[-1] or stride != 1 else None)
        self.blk_bna = _BNRelu(ch[-1])

    def forward(self, x, freeze_units: bool = False):
        shortcut = x if self.shortcut is None else self.shortcut(x)
        prev = x
        for unit in self.units:
            with torch.no_grad() if freeze_units else contextlib.nullcontext():
                new = unit(prev)
            prev = new + shortcut
            shortcut = prev
        return self.blk_bna(prev)


class DenseUnit(nn.Module):
    """BN-ReLU -> 1x1 -> BN-ReLU -> grouped kxk 'VALID' conv."""

    def __init__(self, cin: int, ch: Sequence[int], ksize: int,
                 groups: int = 4):
        super().__init__()
        self.add_module("preact_bna/bn", _bn(cin))
        self.add_module("conv1", _conv(cin, ch[0], 1))
        self.add_module("conv1/bn", _bn(ch[0]))
        self.add_module("conv2", _conv(ch[0], ch[1], ksize, groups=groups))

    def forward(self, x):
        m = self._modules
        x = F.relu(m["preact_bna/bn"](x))
        x = F.relu(m["conv1/bn"](m["conv1"](x)))
        return m["conv2"](x)


class DenseBlock(nn.Module):
    """Dense decoder block: each unit shrinks the map by ksize - 1, the
    running map is center-cropped to match before the channel concat;
    closed by BN+ReLU."""

    def __init__(self, cin: int, ch: Sequence[int], count: int, ksize: int,
                 groups: int = 4):
        super().__init__()
        self.units = nn.ModuleList(
            DenseUnit(cin + i * ch[1], ch, ksize, groups) for i in range(count)
        )
        self.blk_bna = _BNRelu(cin + count * ch[1])

    def forward(self, x):
        for unit in self.units:
            new = unit(x)
            x = crop_to_shape(x, new.shape[2:], layout="NCHW")
            x = torch.cat([x, new], dim=1)
        return self.blk_bna(x)


class UpSample2x(nn.Module):
    """Nearest-neighbour 2x unpool. Holds the reference's constant
    ones(2, 2) `unpool_mat` buffer only so that state dicts match."""

    def __init__(self):
        super().__init__()
        self.register_buffer("unpool_mat", torch.ones(2, 2))

    def forward(self, x):
        return upsample2x(x)


def upsample2x(x: torch.Tensor) -> torch.Tensor:
    """[N, C, H, W] -> [N, C, 2H, 2W], each pixel repeated 2x2."""
    return F.interpolate(x, scale_factor=2, mode="nearest")
