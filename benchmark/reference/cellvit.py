"""Plain float32 CellViT-SAM-H: the benchmark's reference forward of the
`cellvit_sam_h_pannuke` configuration.

Written from the published description: Hörst et al., "CellViT: Vision
Transformers for Precise Cell Segmentation and Classification", Medical
Image Analysis 94 (2024) 103143, arXiv:2306.15350 (github.com/TIO-IKIM/
CellViT, `CellViTSAM` with `vit_structure="SAM-H"` in
cell_segmentation/models/cellvit.py), and the Segment Anything image
encoder (github.com/facebookresearch/segment-anything,
segment_anything/modeling/image_encoder.py, build_sam.py::build_sam_vit_h).
It imports nothing of the measured package. Its module tree, and so its
`state_dict()` keys, are CellViT's, so one `.tar` ({"desc": state_dict})
or CellViT's `.pth` (`model_state_dict`) loads into it and into the
measured program alike.

- input x = (rgb / 255 - 0.5) / 0.5 (CellViT's default normalisation);
- patch embedding: 16x16 convolution at stride 16, 3 -> E, with bias,
  then `+ pos_embed[:, :h, :w]` (cropped, not interpolated);
- blocks: t <- t + Attn(LN1(t)), then t <- t + lin2(GELU(lin1(LN2(t)))),
  LayerNorm eps 1e-6, exact GELU; the blocks of `global_attn_indexes`
  attend over the whole grid, the others zero-pad the grid bottom and
  right to a multiple of `window_size`, attend within each window (the
  padded tokens are unmasked keys) and crop back;
- attention: qkv with bias, S = (q * d^-1/2) k^T + R_h + R_w, where
  R_h[(y, x), (y', .)] = sum_c q[y, x, c] T_h[y - y' + L - 1, c] with the
  unscaled q (R_w the same over x), softmax, times v, heads merged, proj.
  It is materialised as SAM writes it: S, `add_decomposed_rel_pos`,
  softmax. A table of 2L - 1 rows used on a grid of L' != L is resized
  linearly to 2L' - 1 rows (SAM's `get_rel_pos`, `F.interpolate(mode=
  "linear")`), here as the product with that interpolation's matrix,
  whose backward is deterministic;
- skips z1..z4: the outputs of the `extract_layers` blocks (1-based);
  z0 = x; neck 1x1 conv, LayerNorm2d, 3x3 conv, LayerNorm2d (no bias);
  tissue logits: a linear layer over the neck's spatial mean;
- decoders: `Conv2DBlock` = conv 3x3 (pad 1) -> BN -> ReLU,
  `Deconv2DBlock` = ConvT 2x2 stride 2 -> conv 3x3 -> BN -> ReLU; the
  skip decoders decoder0..3, then per branch (np 2, hv 2, tp n) the
  bottleneck upsampler, the decoder3/2/1 upsamplers and the decoder0
  header, each level concatenating [skip, upsampled]; BatchNorm eps 1e-5.

Departure from the published code: the skip decoders decoder0..3 run once
a forward, where CellViT's `_forward_upsample` runs them once a branch;
in eval mode that is the same result, and the FLOPs the benchmark counts
on this model are the program's.

Every convolution, transposed convolution, linear layer and attention
matmul applies the module's `quant` to both operands when one is set
(`set_quant`): the low-precision control and witness of `lowp.py`.
`forward` runs with TF32 off (`model.strict_fp32`) unless `strict` is
False, which only the weights recipe sets.
"""

from __future__ import annotations

import contextlib
import functools
from collections import OrderedDict
from typing import Callable, Dict, Optional, Sequence

import torch
import torch.nn.functional as F
from torch import nn

from .model import strict_fp32

# the architecture keys a configuration file gives, with CellViT-SAM-H's
# published values (build_sam_vit_h; CellViTSAM.init_vit_h)
SAM_H = {"img_size": 1024, "patch_size": 16, "embed_dim": 1280,
         "depth": 32, "num_heads": 16, "mlp_ratio": 4.0, "window_size": 14,
         "global_attn_indexes": [7, 15, 23, 31],
         "extract_layers": [8, 16, 24, 32], "out_chans": 256,
         "num_tissue_classes": 19}
HEADS = ("decoder0_header.2", "classifier_head")


def _q(module, t, kind):
    return t if module.quant is None else module.quant(t, kind)


class Conv(nn.Conv2d):
    quant: Optional[Callable] = None

    def forward(self, x):
        return self._conv_forward(_q(self, x, "act"),
                                  _q(self, self.weight, "weight"), self.bias)


class ConvT(nn.ConvTranspose2d):
    quant: Optional[Callable] = None

    def forward(self, x):
        # the weight is [in, out, kh, kw]: per output channel is dim 1
        w = self.weight
        if self.quant is not None:
            w = self.quant(w.transpose(0, 1), "weight").transpose(0, 1)
        return F.conv_transpose2d(_q(self, x, "act"), w, self.bias,
                                  self.stride)


class Linear(nn.Linear):
    quant: Optional[Callable] = None

    def forward(self, x):
        return F.linear(_q(self, x, "act"), _q(self, self.weight, "weight"),
                        self.bias)


class LayerNorm2d(nn.Module):
    """SAM's LayerNorm2d: over the channels of NCHW, eps 1e-6."""

    def __init__(self, ch: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.eps = eps

    def forward(self, x):
        u = x.mean(1, keepdim=True)
        s = (x - u).pow(2).mean(1, keepdim=True)
        x = (x - u) / torch.sqrt(s + self.eps)
        return self.weight[:, None, None] * x + self.bias[:, None, None]


@functools.lru_cache(maxsize=None)
def interp_matrix(n_in: int, n_out: int, device=None) -> torch.Tensor:
    """[n_out, n_in] on `device`: the rows of `F.interpolate(mode="linear",
    align_corners=False)` from n_in to n_out samples, its weights computed
    on the host in float32 as PyTorch computes them (kept, so that a card
    gets them once)."""
    scale = torch.tensor(n_in, dtype=torch.float32) / n_out
    src = (scale * (torch.arange(n_out, dtype=torch.float32) + 0.5)
           - 0.5).clamp(min=0)
    i0 = src.long().clamp(max=n_in - 1)
    i1 = (i0 + 1).clamp(max=n_in - 1)
    w1 = src - i0
    m = torch.zeros(n_out, n_in)
    rows = torch.arange(n_out)
    m.index_put_((rows, i0), 1 - w1, accumulate=True)
    m.index_put_((rows, i1), w1, accumulate=True)
    return m.to(device)


@functools.lru_cache(maxsize=None)
def rel_index(q_size: int, k_size: int, device=None) -> torch.Tensor:
    """[q, k] table rows of SAM's `get_rel_pos` on `device` (kept)."""
    q = torch.arange(q_size)[:, None] * max(k_size / q_size, 1.0)
    k = torch.arange(k_size)[None, :] * max(q_size / k_size, 1.0)
    rel = (q - k) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel.long().to(device)


def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor):
    """SAM's `get_rel_pos` for q_size == k_size: [q, k, C] rows of the
    table (resized linearly to 2 q - 1 rows where it has another length)
    at q - k + size - 1."""
    n = 2 * max(q_size, k_size) - 1
    if rel_pos.shape[0] != n:
        rel_pos = interp_matrix(rel_pos.shape[0], n,
                                rel_pos.device).to(rel_pos.dtype) @ rel_pos
    return rel_pos[rel_index(q_size, k_size, rel_pos.device)]


class Attention(nn.Module):
    quant: Optional[Callable] = None

    def __init__(self, dim: int, heads: int, size: int):
        super().__init__()
        self.heads = heads
        hd = dim // heads
        self.scale = hd ** -0.5
        self.qkv = Linear(dim, 3 * dim)
        self.proj = Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * size - 1, hd))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * size - 1, hd))

    def mm(self, a, b):
        return _q(self, a, "act") @ _q(self, b, "act")

    def forward(self, x):
        b, h, w, _ = x.shape
        qkv = self.qkv(x).reshape(b, h * w, 3, self.heads, -1).permute(
            2, 0, 3, 1, 4)
        q, k, v = qkv.reshape(3, b * self.heads, h * w, -1).unbind(0)
        attn = self.mm(q * self.scale, k.transpose(-2, -1))
        attn = self.add_decomposed_rel_pos(attn, q, (h, w))
        attn = attn.softmax(dim=-1)
        x = self.mm(attn, v).view(b, self.heads, h, w, -1).permute(
            0, 2, 3, 1, 4).reshape(b, h, w, -1)
        return self.proj(x)

    def add_decomposed_rel_pos(self, attn, q, size):
        h, w = size
        rh = get_rel_pos(h, h, self.rel_pos_h)
        rw = get_rel_pos(w, w, self.rel_pos_w)
        bh, _, dim = q.shape
        r_q = _q(self, q.reshape(bh, h, w, dim), "act")
        rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, _q(self, rh, "act"))
        rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, _q(self, rw, "act"))
        return (attn.view(bh, h, w, h, w) + rel_h[:, :, :, :, None]
                + rel_w[:, :, :, None, :]).view(bh, h * w, h * w)


class MLPBlock(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.lin1 = Linear(dim, hidden)
        self.lin2 = Linear(hidden, dim)

    def forward(self, x):
        return self.lin2(F.gelu(self.lin1(x)))


def window_partition(x, ws: int):
    b, h, w, c = x.shape
    ph, pw = (ws - h % ws) % ws, (ws - w % ws) % ws
    if ph or pw:
        x = F.pad(x, (0, 0, 0, pw, 0, ph))
    hp, wp = h + ph, w + pw
    x = x.view(b, hp // ws, ws, wp // ws, ws, c)
    return x.permute(0, 1, 3, 2, 4, 5).reshape(-1, ws, ws, c), (hp, wp)


def window_unpartition(win, ws: int, pad_hw, hw):
    hp, wp = pad_hw
    h, w = hw
    b = win.shape[0] // (hp * wp // ws // ws)
    x = win.view(b, hp // ws, wp // ws, ws, ws, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(b, hp, wp, -1)
    return x[:, :h, :w, :]


class Block(nn.Module):
    def __init__(self, dim, heads, mlp_ratio, window, grid):
        super().__init__()
        self.window = window
        self.norm1 = nn.LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, heads, window if window else grid)
        self.norm2 = nn.LayerNorm(dim, eps=1e-6)
        self.mlp = MLPBlock(dim, int(dim * mlp_ratio))

    def forward(self, x):
        shortcut = x
        x = self.norm1(x)
        if self.window:
            h, w = x.shape[1], x.shape[2]
            x, pad_hw = window_partition(x, self.window)
        x = self.attn(x)
        if self.window:
            x = window_unpartition(x, self.window, pad_hw, (h, w))
        x = shortcut + x
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = Conv(3, dim, patch, stride=patch)

    def forward(self, x):
        return self.proj(x).permute(0, 2, 3, 1)


class Encoder(nn.Module):
    def __init__(self, a: dict):
        super().__init__()
        grid = a["img_size"] // a["patch_size"]
        dim = a["embed_dim"]
        self.extract = set(a["extract_layers"])
        self.patch_embed = PatchEmbed(a["patch_size"], dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, grid, grid, dim))
        glob = set(a["global_attn_indexes"])
        self.blocks = nn.ModuleList(
            Block(dim, a["num_heads"], a["mlp_ratio"],
                  0 if i in glob else a["window_size"], grid)
            for i in range(a["depth"]))
        out = a["out_chans"]
        self.neck = nn.Sequential(Conv(dim, out, 1, bias=False),
                                  LayerNorm2d(out),
                                  Conv(out, out, 3, padding=1, bias=False),
                                  LayerNorm2d(out))

    def forward(self, x):
        """(tissue features [B, out], [z1..z4] as [B, h, w, E])."""
        x = self.patch_embed(x)
        x = x + self.pos_embed[:, :x.shape[1], :x.shape[2], :]
        zs = []
        for depth, blk in enumerate(self.blocks, 1):
            x = blk(x)
            if depth in self.extract:
                zs.append(x)
        out = self.neck(x.permute(0, 3, 1, 2))
        return out.flatten(2).mean(dim=2), zs


class ConvBlock(nn.Module):
    """CellViT's Conv2DBlock: conv 3x3 (pad 1) -> BN -> ReLU (its Dropout,
    at rate 0, holds no parameters)."""

    def __init__(self, cin, cout):
        super().__init__()
        self.block = nn.Sequential(Conv(cin, cout, 3, padding=1),
                                   nn.BatchNorm2d(cout), nn.ReLU())

    def forward(self, x):
        return self.block(x)


class DeconvBlock(nn.Module):
    """CellViT's Deconv2DBlock: ConvT 2x2 stride 2 -> conv 3x3 -> BN ->
    ReLU."""

    def __init__(self, cin, cout):
        super().__init__()
        self.block = nn.Sequential(ConvT(cin, cout, 2, stride=2),
                                   Conv(cout, cout, 3, padding=1),
                                   nn.BatchNorm2d(cout), nn.ReLU())

    def forward(self, x):
        return self.block(x)


def skip_dims(embed_dim: int):
    """(skip_dim_11, skip_dim_12, bottleneck_dim) as CellViT sets them."""
    return (512, 256, 512) if embed_dim >= 512 else (256, 128, 312)


def branch(embed_dim: int, n: int) -> nn.Sequential:
    s11, s12, bot = skip_dims(embed_dim)
    return nn.Sequential(OrderedDict([
        ("bottleneck_upsampler", ConvT(embed_dim, bot, 2, stride=2)),
        ("decoder3_upsampler", nn.Sequential(
            ConvBlock(2 * bot, bot), ConvBlock(bot, bot), ConvBlock(bot, bot),
            ConvT(bot, 256, 2, stride=2))),
        ("decoder2_upsampler", nn.Sequential(
            ConvBlock(512, 256), ConvBlock(256, 256),
            ConvT(256, 128, 2, stride=2))),
        ("decoder1_upsampler", nn.Sequential(
            ConvBlock(256, 128), ConvBlock(128, 128),
            ConvT(128, 64, 2, stride=2))),
        ("decoder0_header", nn.Sequential(
            ConvBlock(128, 64), ConvBlock(64, 64), Conv(64, n, 1))),
    ]))


class CellViTRef(nn.Module):
    """NCHW float input in [0, 255] -> {"tissue_types", "nuclei_binary_map",
    "hv_map", "nuclei_type_map"}, float32 logits at the input's size (hv
    raw)."""

    strict = True

    def __init__(self, arch: dict, nr_types: int):
        super().__init__()
        a = {**SAM_H, **{k: arch[k] for k in SAM_H if k in arch}}
        self.arch, self.nr_types = a, nr_types
        e = a["embed_dim"]
        s11, s12, bot = skip_dims(e)
        self.encoder = Encoder(a)
        self.classifier_head = Linear(a["out_chans"],
                                      a["num_tissue_classes"])
        self.decoder0 = nn.Sequential(ConvBlock(3, 32), ConvBlock(32, 64))
        self.decoder1 = nn.Sequential(DeconvBlock(e, s11),
                                      DeconvBlock(s11, s12),
                                      DeconvBlock(s12, 128))
        self.decoder2 = nn.Sequential(DeconvBlock(e, s11),
                                      DeconvBlock(s11, 256))
        self.decoder3 = nn.Sequential(DeconvBlock(e, bot))
        self.nuclei_binary_map_decoder = branch(e, 2)
        self.hv_map_decoder = branch(e, 2)
        self.nuclei_type_maps_decoder = branch(e, nr_types)

    def forward(self, imgs) -> Dict[str, torch.Tensor]:
        with strict_fp32() if self.strict else contextlib.nullcontext():
            return self._forward(imgs)

    def _forward(self, imgs):
        x = (imgs.float() / 255.0 - 0.5) / 0.5
        tissue, zs = self.encoder(x)
        z1, z2, z3, z4 = (z.permute(0, 3, 1, 2) for z in zs)
        b0, b1 = self.decoder0(x), self.decoder1(z1)
        b2, b3 = self.decoder2(z2), self.decoder3(z3)
        out = {"tissue_types": self.classifier_head(tissue)}
        for key, dec in (("nuclei_binary_map", self.nuclei_binary_map_decoder),
                         ("hv_map", self.hv_map_decoder),
                         ("nuclei_type_map", self.nuclei_type_maps_decoder)):
            u = dec.bottleneck_upsampler(z4)
            u = dec.decoder3_upsampler(torch.cat([b3, u], dim=1))
            u = dec.decoder2_upsampler(torch.cat([b2, u], dim=1))
            u = dec.decoder1_upsampler(torch.cat([b1, u], dim=1))
            out[key] = dec.decoder0_header(torch.cat([b0, u], dim=1))
        return out


def branch_logits(out: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """CellViT's outputs under the HoVer-Net branch names (tp, np, hv)."""
    return {"tp": out["nuclei_type_map"], "np": out["nuclei_binary_map"],
            "hv": out["hv_map"]}


def set_quant(model: nn.Module, quant: Optional[Callable],
              skip: Sequence[str] = HEADS):
    """Put `quant` on every convolution, transposed convolution, linear
    layer and attention matmul, the float32 heads (`skip`) excepted: the
    measured program keeps its 1x1 heads and tissue head in float32."""
    for name, m in model.named_modules():
        if isinstance(m, (Conv, ConvT, Linear, Attention)):
            m.quant = None if any(name.endswith(s) for s in skip) else quant
