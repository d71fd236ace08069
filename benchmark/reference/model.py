"""Plain float32 HoVer-Net: the benchmark's reference forward.

Written from the published description (Graham et al., HoVer-Net, Medical
Image Analysis 2019; vqdang/hover_net models/hovernet/net_desc.py and
net_utils.py). It imports nothing of the measured package: it is a frozen,
independent copy of the architecture whose module tree, and so whose
`state_dict()` keys, are the reference PyTorch repository's, so one `.tar`
({"desc": state_dict}) loads into it and into the measured program alike.

- stem `conv0`: 7x7, 'SAME' in fast mode (256 -> 164), 'VALID' in original
  mode (270 -> 80);
- encoder d0..d3: pre-activation ResNet-50 groups [3, 4, 6, 3], strides 1,
  2, 2, 2, 'SAME' padding as XLA/TF splits it (smaller half first);
- `conv_bot` 1x1; one decoder per branch (tp, np, hv): u3 and u2 'VALID'
  with dense blocks (kernel 5 original, 3 fast), u1 'SAME', u0 BN-ReLU and
  a 1x1 head with bias; skips are nearest 2x upsampling plus a centre crop;
- input scaled by 1/255; BatchNorm eps 1e-5.

Every convolution goes through `Conv.forward`, which applies the module's
`quant` to its input and weight when one is set (`set_quant`): the
low-precision control of `reference/lowp.py` uses it.
"""

from __future__ import annotations

import contextlib
import math
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

MODE_SHAPES = {"original": (270, 80), "fast": (256, 164)}


def same_pad(x, k: int, stride: int):
    """XLA 'SAME' zero padding of NCHW `x` for a (k, stride) conv."""
    pads = []
    for n in (x.shape[3], x.shape[2]):
        total = max((-(-n // stride) - 1) * stride + k - n, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads) if any(pads) else x


def crop_by(x, dh: int, dw: int):
    """Centre crop of NCHW `x` by (dh, dw) pixels, the smaller half on top
    and left."""
    t, l = dh // 2, dw // 2
    return x[:, :, t:x.shape[2] - (dh - t), l:x.shape[3] - (dw - l)]


class Conv(nn.Conv2d):
    quant: Optional[Callable] = None

    def __init__(self, cin, cout, k, stride=1, groups=1, bias=False):
        super().__init__(cin, cout, k, stride=stride, groups=groups,
                         bias=bias)

    def forward(self, x):
        w = self.weight
        if self.quant is not None:
            x, w = self.quant(x, "act"), self.quant(w, "weight")
        return F.conv2d(x, w, self.bias, self.stride, 0, 1, self.groups)


def bn(ch):
    return nn.BatchNorm2d(ch, eps=1e-5)


class Stem(nn.Module):
    def __init__(self, cout, same):
        super().__init__()
        self.same = same
        self.add_module("/", Conv(3, cout, 7))
        self.bn = bn(cout)

    def forward(self, x):
        if self.same:
            x = same_pad(x, 7, 1)
        return F.relu(self.bn(self._modules["/"](x)))


class ResUnit(nn.Module):
    def __init__(self, cin, ch, stride, preact):
        super().__init__()
        self.stride, self.preact = stride, preact
        if preact:
            self.add_module("preact/bn", bn(cin))
        self.add_module("conv1", Conv(cin, ch[0], 1))
        self.add_module("conv1/bn", bn(ch[0]))
        self.add_module("conv2", Conv(ch[0], ch[1], 3, stride=stride))
        self.add_module("conv2/bn", bn(ch[1]))
        self.add_module("conv3", Conv(ch[1], ch[2], 1))

    def forward(self, x):
        m = self._modules
        if self.preact:
            x = F.relu(m["preact/bn"](x))
        x = F.relu(m["conv1/bn"](m["conv1"](x)))
        x = F.relu(m["conv2/bn"](m["conv2"](same_pad(x, 3, self.stride))))
        return m["conv3"](x)


class BNRelu(nn.Module):
    def __init__(self, ch):
        super().__init__()
        self.bn = bn(ch)

    def forward(self, x):
        return F.relu(self.bn(x))


class ResBlock(nn.Module):
    def __init__(self, cin, ch, count, stride):
        super().__init__()
        self.units = nn.ModuleList(
            ResUnit(cin if i == 0 else ch[2], ch, stride if i == 0 else 1,
                    preact=i != 0) for i in range(count))
        self.shortcut = (Conv(cin, ch[2], 1, stride=stride)
                         if cin != ch[2] or stride != 1 else None)
        self.blk_bna = BNRelu(ch[2])

    def forward(self, x, frozen=False):
        shortcut = x if self.shortcut is None else self.shortcut(x)
        prev = x
        for unit in self.units:
            with torch.no_grad() if frozen else contextlib.nullcontext():
                new = unit(prev)
            prev = new + shortcut
            shortcut = prev
        return self.blk_bna(prev)


class DenseUnit(nn.Module):
    def __init__(self, cin, ch, k):
        super().__init__()
        self.add_module("preact_bna/bn", bn(cin))
        self.add_module("conv1", Conv(cin, ch[0], 1))
        self.add_module("conv1/bn", bn(ch[0]))
        self.add_module("conv2", Conv(ch[0], ch[1], k, groups=4))

    def forward(self, x):
        m = self._modules
        x = F.relu(m["preact_bna/bn"](x))
        x = F.relu(m["conv1/bn"](m["conv1"](x)))
        return m["conv2"](x)


class DenseBlock(nn.Module):
    def __init__(self, cin, ch, count, k):
        super().__init__()
        self.units = nn.ModuleList(DenseUnit(cin + i * ch[1], ch, k)
                                   for i in range(count))
        self.blk_bna = BNRelu(cin + count * ch[1])

    def forward(self, x):
        for unit in self.units:
            new = unit(x)
            x = crop_by(x, x.shape[2] - new.shape[2], x.shape[3] - new.shape[3])
            x = torch.cat([x, new], dim=1)
        return self.blk_bna(x)


class UpLevel(nn.Module):
    def __init__(self, cin, cmid, count, cout, k, w):
        super().__init__()
        self.conva = Conv(cin, cmid, k)
        self.dense = DenseBlock(cmid, (2 * w, w // 2), count, k)
        self.convf = Conv(cmid + count * (w // 2), cout, 1)

    def forward(self, x):
        return self.convf(self.dense(self.conva(x)))


class U1(nn.Module):
    def __init__(self, cin, cout, k):
        super().__init__()
        self.k = k
        self.conva = Conv(cin, cout, k)

    def forward(self, x):
        return self.conva(same_pad(x, self.k, 1))


class U0(nn.Module):
    def __init__(self, cin, cout):
        super().__init__()
        self.bn = bn(cin)
        self.conv = Conv(cin, cout, 1, bias=True)

    def forward(self, x):
        return self.conv(F.relu(self.bn(x)))


class Branch(nn.Module):
    def __init__(self, w, k, out_ch):
        super().__init__()
        self.u3 = UpLevel(16 * w, 4 * w, 8, 8 * w, k, w)
        self.u2 = UpLevel(8 * w, 2 * w, 4, 4 * w, k, w)
        self.u1 = U1(4 * w, w, k)
        self.u0 = U0(w, out_ch)

    def forward(self, d0, d1, d2, d3):
        up = lambda t: F.interpolate(t, scale_factor=2, mode="nearest")
        x = self.u3(up(d3) + d2)
        x = self.u2(up(x) + d1)
        x = self.u1(up(x) + d0)
        return self.u0(x)


class Unpool(nn.Module):
    """The reference's constant 2x2 `unpool_mat`, kept for its state key."""

    def __init__(self):
        super().__init__()
        self.register_buffer("unpool_mat", torch.ones(2, 2))


class HoVerNetRef(nn.Module):
    """NCHW float input in [0, 255] -> {branch: NCHW float32 logits}."""

    def __init__(self, mode: str, nr_types: Optional[int], width: int = 64):
        super().__init__()
        self.mode, self.nr_types, self.width = mode, nr_types, width
        self.ksize = 5 if mode == "original" else 3
        w = width
        self.conv0 = Stem(w, same=mode == "fast")
        self.d0 = ResBlock(w, (w, w, 4 * w), 3, 1)
        self.d1 = ResBlock(4 * w, (2 * w, 2 * w, 8 * w), 4, 2)
        self.d2 = ResBlock(8 * w, (4 * w, 4 * w, 16 * w), 6, 2)
        self.d3 = ResBlock(16 * w, (8 * w, 8 * w, 32 * w), 3, 2)
        self.conv_bot = Conv(32 * w, 16 * w, 1)
        outs = {"np": 2, "hv": 2}
        if nr_types:
            outs = {"tp": nr_types, **outs}
        self.decoder = nn.ModuleDict({name: Branch(w, self.ksize, c)
                                      for name, c in outs.items()})
        self.upsample2x = Unpool()

    @property
    def patch_shapes(self):
        return MODE_SHAPES[self.mode]

    def init_weights(self, generator: torch.Generator):
        """Convolutions ~ N(0, 2 / fan_out), biases 0, BatchNorm (1, 0)."""
        with torch.no_grad():
            for m in self.modules():
                if isinstance(m, nn.Conv2d):
                    fan_out = m.weight.shape[0] * m.weight[0, 0].numel()
                    m.weight.normal_(0.0, math.sqrt(2.0 / fan_out),
                                     generator=generator)
                    if m.bias is not None:
                        m.bias.zero_()

    def forward(self, x, freeze_encoder: bool = False
                ) -> Dict[str, torch.Tensor]:
        x = self.conv0(x.to(self.conv_bot.weight.dtype) / 255.0)
        d0 = self.d0(x, frozen=freeze_encoder)
        with torch.no_grad() if freeze_encoder else contextlib.nullcontext():
            d1 = self.d1(d0)
            d2 = self.d2(d1)
            d3 = self.d3(d2)
        d3 = self.conv_bot(d3)
        k = self.ksize
        t1 = (2 * (d2.shape[2] - 9 * (k - 1)), 2 * (d2.shape[3] - 9 * (k - 1)))
        t0 = (2 * (t1[0] - 5 * (k - 1)), 2 * (t1[1] - 5 * (k - 1)))
        d1 = crop_by(d1, d1.shape[2] - t1[0], d1.shape[3] - t1[1])
        d0 = crop_by(d0, d0.shape[2] - t0[0], d0.shape[3] - t0[1])
        return {name: b(d0, d1, d2, d3) for name, b in self.decoder.items()}


def head_maps(out: Dict[str, torch.Tensor]) -> torch.Tensor:
    """Logits -> NHWC float32 [tp argmax (typed), np foreground prob, hv_x,
    hv_y]: the per-pixel channels HoVer-Net's inference writes."""
    parts = []
    if "tp" in out:
        parts.append(out["tp"].argmax(dim=1, keepdim=True).float())
    parts.append(torch.softmax(out["np"].float(), dim=1)[:, 1:2])
    parts.append(out["hv"].float())
    return torch.cat(parts, dim=1).permute(0, 2, 3, 1)


def set_quant(model: nn.Module, quant: Optional[Callable],
              skip_heads: bool = True):
    """Put `quant` on every convolution (the 1x1 heads excepted when
    `skip_heads`: the measured program keeps its heads in float32)."""
    for name, m in model.named_modules():
        if isinstance(m, Conv):
            m.quant = None if (skip_heads and name.endswith("u0.conv")) \
                else quant


@contextlib.contextmanager
def strict_fp32():
    """float32 matmuls and convolutions with TF32 off (restored after)."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = flags
