"""HoVer-Net as one NCHW PyTorch module.

Counterpart of hover_net_tpu/models/hovernet.py (and the reference
net_desc.py):

- stem `conv0`: 7x7 'SAME' in fast mode, 'VALID' in original mode;
- encoder d0..d3: Preact-ResNet50 groups [3, 4, 6, 3], strides 1, 2, 2, 2;
- `conv_bot`: 1x1, 32w -> 16w;
- one decoder per branch (tp, np, hv): u3/u2 with 'VALID' convs and dense
  blocks (ksize 5 original, 3 fast), u1 'SAME', u0 BN-ReLU + 1x1 head;
- skips `upsample2x(d[i+1]) + crop(d[i])` with the crops computed from the
  geometry;
- input scaled by 1/255;
- `forward` is `decode(encode(imgs))`: the encoder (stem, d0..d3,
  `conv_bot`, the skips' crops) and the three decoders;
- `forward(imgs, freeze_encoder=True)` is the first training phase's
  cut: d0's unit towers and all of d1..d3 get no gradient, while conv0,
  d0's shortcut and closing BN, `conv_bot` and the decoders learn.

`cfg.dtype` is the compute dtype of the body. The heads (`u0.conv`) run
in `cfg.head_dtype`, float32 as in the JAX package unless asked otherwise
(the data-parallel exactness check runs them in float64). Under a body
narrower than float32 (bf16) every BatchNorm keeps its weight, bias and
running statistics in float32, as flax's BatchNorm does (param_dtype):
it normalises a bf16 input in float32 and rounds its output to bf16 once
(blocks.BatchNorm2d), and a float32 checkpoint loads into it unrounded.
A float32 model run under `torch.autocast(dtype=torch.bfloat16)`
computes its body in bf16 on float32 parameters, as the JAX package's
bf16 training does, and its heads still in `cfg.head_dtype`
(`make_train_step(autocast_dtype=)`).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..utils.crops import crop_op
from .blocks import (
    BatchNorm2d,
    ConvBNRelu,
    DenseBlock,
    ResidualBlock,
    UpSample2x,
    _bn,
    _conv,
    same_pad,
    upsample2x,
)

# the encoder's features as the decoders take them: (d0, d1, d2, d3)
Features = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]

# mode -> (input patch, output patch)
MODE_SHAPES = {"original": (270, 80), "fast": (256, 164)}


@dataclasses.dataclass(frozen=True)
class HoVerNetConfig:
    mode: str = "fast"
    nr_types: Optional[int] = None  # None => segmentation only (np + hv)
    input_ch: int = 3
    width: int = 64  # 64 == reference; smaller for tests
    dtype: torch.dtype = torch.float32  # compute dtype of the body
    head_dtype: torch.dtype = torch.float32  # of the heads and the loss

    def __post_init__(self):
        if self.mode not in MODE_SHAPES:
            raise ValueError(f"unknown mode {self.mode}")
        if self.width % 8:
            raise ValueError("width must be a multiple of 8")

    @property
    def ksize(self) -> int:
        return 5 if self.mode == "original" else 3

    @property
    def patch_input_shape(self) -> int:
        return MODE_SHAPES[self.mode][0]

    @property
    def patch_output_shape(self) -> int:
        return MODE_SHAPES[self.mode][1]

    @property
    def branches(self) -> Tuple[str, ...]:
        # the order is the inference concat contract: tp (if any), np, hv
        return ("np", "hv") if self.nr_types is None else ("tp", "np", "hv")

    def branch_channels(self, name: str) -> int:
        return {"np": 2, "hv": 2, "tp": self.nr_types or 0}[name]


class _UpLevel(nn.Module):
    """u3 / u2: 'VALID' conva -> dense block -> 1x1 convf."""

    def __init__(self, cin: int, cmid: int, count: int, cout: int, k: int,
                 w: int):
        super().__init__()
        self.conva = _conv(cin, cmid, k)
        self.dense = DenseBlock(cmid, (2 * w, w // 2), count, k, groups=4)
        self.convf = _conv(cmid + count * (w // 2), cout, 1)

    def forward(self, x):
        return self.convf(self.dense(self.conva(x)))


class _U1(nn.Module):
    def __init__(self, cin: int, cout: int, k: int):
        super().__init__()
        self.k = k
        self.conva = _conv(cin, cout, k)

    def forward(self, x):
        return self.conva(same_pad(x, self.k, 1))


class _U0(nn.Module):
    """BN -> ReLU -> 1x1 head with bias, run in the conv's dtype
    (`cfg.head_dtype`), also inside an autocast body."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.bn = _bn(cin)
        self.conv = _conv(cin, cout, 1, bias=True)

    def forward(self, x):
        x = F.relu(self.bn(x)).to(self.conv.weight.dtype)
        dev = x.device.type
        if torch.amp.is_autocast_available(dev) and \
                torch.is_autocast_enabled(dev):
            with torch.autocast(dev, enabled=False):
                return self.conv(x)
        return self.conv(x)


class DecoderBranch(nn.Module):
    """u3 -> u2 -> u1 -> u0 tower for one output head."""

    def __init__(self, cfg: HoVerNetConfig, out_ch: int):
        super().__init__()
        w, k = cfg.width, cfg.ksize
        self.u3 = _UpLevel(16 * w, 4 * w, 8, 8 * w, k, w)
        self.u2 = _UpLevel(8 * w, 2 * w, 4, 4 * w, k, w)
        self.u1 = _U1(4 * w, w, k)
        self.u0 = _U0(w, out_ch)

    def forward(self, d0, d1, d2, d3):
        x = self.u3(upsample2x(d3) + d2)
        x = self.u2(upsample2x(x) + d1)
        x = self.u1(upsample2x(x) + d0)
        return self.u0(x)


class HoVerNet(nn.Module):
    """Full network. Input: NCHW uint8/float RGB in [0, 255]. Output: dict
    of NCHW logits per branch, in `cfg.head_dtype` (float32).

    Conv weights are drawn as the JAX package draws them (normal, fan-out
    scaled, gain 2) from `generator`; BN starts at (mean 0, var 1, scale
    1, bias 0). Load trained weights with `load_state_dict`."""

    def __init__(self, cfg: HoVerNetConfig,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.cfg = cfg
        w = cfg.width
        self.conv0 = ConvBNRelu(cfg.input_ch, w, 7, same=cfg.mode == "fast")
        self.d0 = ResidualBlock(w, (w, w, 4 * w), 3, stride=1)
        self.d1 = ResidualBlock(4 * w, (2 * w, 2 * w, 8 * w), 4, stride=2)
        self.d2 = ResidualBlock(8 * w, (4 * w, 4 * w, 16 * w), 6, stride=2)
        self.d3 = ResidualBlock(16 * w, (8 * w, 8 * w, 32 * w), 3, stride=2)
        self.conv_bot = _conv(32 * w, 16 * w, 1)
        self.decoder = nn.ModuleDict({
            name: DecoderBranch(cfg, cfg.branch_channels(name))
            for name in cfg.branches
        })
        self.upsample2x = UpSample2x()
        self._init_weights(generator)
        if cfg.dtype != torch.float32 or cfg.head_dtype != torch.float32:
            self.to(cfg.dtype)
            for branch in self.decoder.values():
                branch.u0.conv.to(cfg.head_dtype)
            if torch.finfo(cfg.dtype).bits < 32:
                # flax keeps BN's parameters and statistics in float32
                # (param_dtype) under a narrower body
                for m in self.modules():
                    if isinstance(m, BatchNorm2d):
                        m.float()

    @torch.no_grad()
    def _init_weights(self, generator):
        for m in self.modules():
            if isinstance(m, nn.Conv2d):
                fan_out = m.weight.shape[0] * m.weight[0, 0].numel()
                m.weight.normal_(0.0, math.sqrt(2.0 / fan_out),
                                 generator=generator)
                if m.bias is not None:
                    m.bias.zero_()

    def forward(self, imgs: torch.Tensor, freeze_encoder: bool = False
                ) -> Dict[str, torch.Tensor]:
        return self.decode(self.encode(imgs, freeze_encoder))

    def encode(self, imgs: torch.Tensor, freeze_encoder: bool = False
               ) -> Features:
        """The encoder: stem, d0..d3 and `conv_bot`, with the skips
        cropped to the decoders' geometry: (d0, d1, d2, d3) NCHW."""
        cfg = self.cfg
        x = imgs.to(cfg.dtype) / 255.0
        x = self.conv0(x)
        d0 = self.d0(x, freeze_units=freeze_encoder)
        # the freeze cut of the reference (net_desc.py:108-111): d1..d3
        # run without autograd, so neither their parameters nor d0 (through
        # them) get a gradient; their BN running stats still update
        with torch.no_grad() if freeze_encoder else contextlib.nullcontext():
            d1 = self.d1(d0)
            d2 = self.d2(d1)
            d3 = self.d3(d2)
        d3 = self.conv_bot(d3)

        k = cfg.ksize
        td1 = (2 * (d2.shape[2] - 9 * (k - 1)), 2 * (d2.shape[3] - 9 * (k - 1)))
        td0 = (2 * (td1[0] - 5 * (k - 1)), 2 * (td1[1] - 5 * (k - 1)))
        d1 = crop_op(d1, (d1.shape[2] - td1[0], d1.shape[3] - td1[1]), "NCHW")
        d0 = crop_op(d0, (d0.shape[2] - td0[0], d0.shape[3] - td0[1]), "NCHW")
        return d0, d1, d2, d3

    def decode(self, feats: Features) -> Dict[str, torch.Tensor]:
        """The decoders: {branch: NCHW logits} from `encode`'s features."""
        return {name: branch(*feats)
                for name, branch in self.decoder.items()}
