"""CellViT-SAM-H as one PyTorch module: the Segment Anything ViT-H image
encoder and CellViT's three upsampling decoders.

Written from Hörst et al., "CellViT: Vision Transformers for Precise Cell
Segmentation and Classification", Medical Image Analysis 94 (2024) 103143,
arXiv:2306.15350 (github.com/TIO-IKIM/CellViT, `CellViTSAM` with
`vit_structure="SAM-H"` in cell_segmentation/models/cellvit.py) and the
SAM image encoder (github.com/facebookresearch/segment-anything,
segment_anything/modeling/image_encoder.py, build_sam.py::build_sam_vit_h).
The JAX package has no counterpart. The module names are CellViT's and
SAM's, so the `model_state_dict` of CellViT's `.pth` (and a reference
`.tar`, {"desc": state_dict}) loads with strict=True.

- input x = (rgb / 255 - 0.5) / 0.5;
- `encoder.patch_embed.proj`: 16x16 conv at stride 16, 3 -> 1280, then
  `+ encoder.pos_embed[:, :h, :w]` (cropped, as SAM does);
- 32 blocks `encoder.blocks.{i}`: t <- t + Attn(LN1(t)), t <- t +
  lin2(GELU(lin1(LN2(t)))), LayerNorm eps 1e-6, exact GELU; blocks 7, 15,
  23 and 31 attend globally over the 64^2 grid, the others zero-pad it to
  70^2, attend within 25 windows of 14^2 (padded tokens are unmasked
  keys) and crop back;
- attention: qkv 1280 -> 3840 with bias, 16 heads of 80, scores
  (q / sqrt(80)) k^T plus the decomposed relative-position bias R_h + R_w
  of the unscaled q against `rel_pos_h` / `rel_pos_w` (2L - 1 rows, L = 14
  windowed and 64 global, resized linearly to the grid's 2L' - 1 where it
  differs, as SAM's `get_rel_pos`), softmax, times v, proj 1280 -> 1280;
- skips z1..z4 = the outputs of blocks 8, 16, 24, 32 (1-based), z0 = x;
  `encoder.neck` (1x1 conv, LayerNorm2d, 3x3 conv, LayerNorm2d, no bias)
  and `classifier_head` (tissue logits over the neck's spatial mean);
- the skip decoders `decoder0..3` and, per branch
  (`nuclei_binary_map_decoder` 2, `hv_map_decoder` 2,
  `nuclei_type_maps_decoder` nr_types), the bottleneck upsampler, the
  decoder3/2/1 upsamplers and the decoder0 header (`Conv2DBlock` =
  conv 3x3 -> BN -> ReLU, `Deconv2DBlock` = ConvT 2x2 stride 2 -> conv
  3x3 -> BN -> ReLU; each level concatenates [skip, upsampled]).

`forward` gives CellViT's outputs at the input's size; `encode` and
`decode` are the inference split (infer/steps.infer_output): `decode`
gives the branches under HoVer-Net's names (tp, np, hv), cut to the
centre `patch_output` of a `patch_input` patch, so that HoVer-Net's
stitching tiles a slide with CellViT's own 64-pixel overlap.

Departures from the published code:
- the skip decoders decoder0..3 run once a forward; CellViT's
  `_forward_upsample` runs them once a branch, which in eval mode gives
  the same result;
- the attention runs `F.scaled_dot_product_attention` with the
  decomposed bias as its additive mask, where SAM materialises the
  scores, adds the bias and takes the softmax: the same equations,
  rounded otherwise; the bias is never dropped;
- precision: the body (weights, matmuls, convolutions, the residual
  stream) runs in `cfg.dtype`; every LayerNorm, LayerNorm2d and BatchNorm
  keeps its parameters (and running statistics) in float32, normalises in
  float32 and rounds its output once; the attention's softmax accumulates
  in float32 inside the fused kernel; the 1x1 heads and the tissue head
  run in float32;
- Dropout (rate 0 at inference) is left out; it holds no parameters.

In a forward run inside `runtime.forward_events` (the WSI manager sets it
for each forward batch), the attention of every block adds its device
time to the events' part `global_attn` or `window_attn` (qkv through
proj; the windowed blocks with their pad, partition and merge), and
`infer_output` adds `vit_encoder` and `vit_decoder`; in a profiler trace
the same regions are the spans `hnt.cellvit.encoder`,
`hnt.cellvit.global_attn`, `hnt.cellvit.window_attn` and
`hnt.cellvit.decoder`. They open once a block of a forward batch, never
per patch.
"""

from __future__ import annotations

import dataclasses
from collections import OrderedDict
from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..runtime import forward_events, span
from .blocks import BatchNorm2d

# the published architectures by `--model_mode` (build_sam_vit_h;
# CellViTSAM.init_vit_h), with the slide patching of CellViT's
# `cell_detection` (1024^2 patches, 64 pixels of overlap)
CELLVIT_MODES = {
    "cellvit_sam_h": dict(
        patch_size=16, embed_dim=1280, depth=32,
        num_heads=16, mlp_ratio=4.0, window_size=14,
        global_attn_indexes=(7, 15, 23, 31), extract_layers=(8, 16, 24, 32),
        out_chans=256, num_tissue_classes=19, patch_input=1024,
        patch_output=960),
}


@dataclasses.dataclass(frozen=True)
class CellViTConfig:
    mode: str = "cellvit_sam_h"
    nr_types: int = 6
    dtype: torch.dtype = torch.float32  # compute dtype of the body
    patch_size: int = 16
    embed_dim: int = 1280
    depth: int = 32
    num_heads: int = 16
    mlp_ratio: float = 4.0
    window_size: int = 14
    global_attn_indexes: Tuple[int, ...] = (7, 15, 23, 31)
    extract_layers: Tuple[int, ...] = (8, 16, 24, 32)
    out_chans: int = 256
    num_tissue_classes: int = 19
    patch_input: int = 1024  # SAM's img_size: pos_embed's grid is
    # patch_input / patch_size
    patch_output: int = 960

    def __post_init__(self):
        if not self.nr_types:
            raise ValueError("CellViT always types its nuclei: give "
                             "nr_types (6 for PanNuke)")

    @classmethod
    def for_mode(cls, mode: str, **kwargs) -> "CellViTConfig":
        """The configuration of `--model_mode mode` (`CELLVIT_MODES`)."""
        return cls(mode=mode, **CELLVIT_MODES[mode], **kwargs)

    @property
    def patch_input_shape(self) -> int:
        return self.patch_input

    @property
    def patch_output_shape(self) -> int:
        return self.patch_output

    @property
    def skip_dims(self) -> Tuple[int, int, int]:
        """(skip_dim_11, skip_dim_12, bottleneck_dim) as CellViT sets them
        from the embedding width."""
        return (512, 256, 512) if self.embed_dim >= 512 else (256, 128, 312)


class LayerNorm(nn.LayerNorm):
    """LayerNorm in float32 whatever the input's dtype, rounded once."""

    def forward(self, x):
        return F.layer_norm(x.float(), self.normalized_shape, self.weight,
                            self.bias, self.eps).to(x.dtype)


class LayerNorm2d(nn.Module):
    """SAM's LayerNorm2d (over the channels of NCHW, eps 1e-6), in float32
    and rounded once."""

    def __init__(self, ch: int, eps: float = 1e-6):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.eps = eps

    def forward(self, x):
        y = x.float()
        u = y.mean(1, keepdim=True)
        s = (y - u).pow(2).mean(1, keepdim=True)
        y = (y - u) / torch.sqrt(s + self.eps)
        y = self.weight[:, None, None] * y + self.bias[:, None, None]
        return y.to(x.dtype)


class HeadConv(nn.Conv2d):
    """A head convolution in its own dtype (float32)."""

    def forward(self, x):
        return super().forward(x.to(self.weight.dtype))


class HeadLinear(nn.Linear):
    """The tissue head in its own dtype (float32)."""

    def forward(self, x):
        return super().forward(x.to(self.weight.dtype))


def get_rel_pos(size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """SAM's `get_rel_pos` for a query and key grid of `size`: [size, size,
    C] rows of the table at q - k + size - 1, the table first resized
    linearly to 2 size - 1 rows where it has another length."""
    n = 2 * size - 1
    if rel_pos.shape[0] != n:
        rel_pos = F.interpolate(rel_pos.t()[None], size=n, mode="linear")[0].t()
    idx = torch.arange(size, device=rel_pos.device)
    return rel_pos[idx[:, None] - idx[None, :] + size - 1]


def rel_pos_bias(q: torch.Tensor, table_h: torch.Tensor,
                 table_w: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The decomposed relative-position bias [B, heads, hw, hw] of the
    unscaled queries q [B, heads, hw, C] (SAM's `add_decomposed_rel_pos`
    without the scores)."""
    b, nh, n, c = q.shape
    r_q = q.reshape(b, nh, h, w, c)
    rel_h = torch.einsum("bnhwc,hkc->bnhwk", r_q, get_rel_pos(h, table_h))
    rel_w = torch.einsum("bnhwc,wkc->bnhwk", r_q, get_rel_pos(w, table_w))
    return (rel_h[..., :, None] + rel_w[..., None, :]).reshape(b, nh, n, n)


class Attention(nn.Module):
    def __init__(self, dim: int, heads: int, size: int):
        super().__init__()
        self.heads = heads
        hd = dim // heads
        self.qkv = nn.Linear(dim, 3 * dim)
        self.proj = nn.Linear(dim, dim)
        self.rel_pos_h = nn.Parameter(torch.zeros(2 * size - 1, hd))
        self.rel_pos_w = nn.Parameter(torch.zeros(2 * size - 1, hd))

    def forward(self, x):
        b, h, w, c = x.shape
        q, k, v = self.qkv(x).reshape(b, h * w, 3, self.heads, -1).permute(
            2, 0, 3, 1, 4).unbind(0)
        bias = rel_pos_bias(q, self.rel_pos_h, self.rel_pos_w, h, w)
        o = F.scaled_dot_product_attention(q, k, v, attn_mask=bias)
        return self.proj(o.transpose(1, 2).reshape(b, h, w, c))


def window_partition(x, ws: int):
    """[B, H, W, C] -> windows [B * nW, ws, ws, C] of the grid zero-padded
    bottom and right to multiples of ws, and the padded (Hp, Wp)."""
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


class MLPBlock(nn.Module):
    def __init__(self, dim: int, hidden: int):
        super().__init__()
        self.lin1 = nn.Linear(dim, hidden)
        self.lin2 = nn.Linear(hidden, dim)

    def forward(self, x):
        return self.lin2(F.gelu(self.lin1(x)))


class Block(nn.Module):
    def __init__(self, dim: int, heads: int, mlp_ratio: float, window: int,
                 grid: int):
        super().__init__()
        self.window = window
        self.part = "window_attn" if window else "global_attn"
        self.norm1 = LayerNorm(dim, eps=1e-6)
        self.attn = Attention(dim, heads, window if window else grid)
        self.norm2 = LayerNorm(dim, eps=1e-6)
        self.mlp = MLPBlock(dim, int(dim * mlp_ratio))

    def attend(self, x):
        if not self.window:
            return self.attn(x)
        hw = x.shape[1:3]
        win, pad_hw = window_partition(x, self.window)
        return window_unpartition(self.attn(win), self.window, pad_hw, hw)

    def forward(self, x):
        y = self.norm1(x)
        events = forward_events.get()
        with span(f"hnt.cellvit.{self.part}"):
            if events is None:
                y = self.attend(y)
            else:
                start = events.record()
                y = self.attend(y)
                events.part(self.part, start, events.record())
        x = x + y
        return x + self.mlp(self.norm2(x))


class PatchEmbed(nn.Module):
    def __init__(self, patch: int, dim: int):
        super().__init__()
        self.proj = nn.Conv2d(3, dim, patch, stride=patch)

    def forward(self, x):
        return self.proj(x).permute(0, 2, 3, 1)


class ImageEncoderViT(nn.Module):
    """SAM's image encoder with CellViT's skips: (neck's spatial mean,
    [z1..z4] as [B, h, w, E])."""

    def __init__(self, cfg: CellViTConfig):
        super().__init__()
        grid = cfg.patch_input // cfg.patch_size
        dim = cfg.embed_dim
        self.extract = frozenset(cfg.extract_layers)
        self.patch_embed = PatchEmbed(cfg.patch_size, dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, grid, grid, dim))
        self.blocks = nn.ModuleList(
            Block(dim, cfg.num_heads, cfg.mlp_ratio,
                  0 if i in cfg.global_attn_indexes else cfg.window_size,
                  grid)
            for i in range(cfg.depth))
        out = cfg.out_chans
        self.neck = nn.Sequential(
            nn.Conv2d(dim, out, 1, bias=False), LayerNorm2d(out),
            nn.Conv2d(out, out, 3, padding=1, bias=False), LayerNorm2d(out))

    def forward(self, x):
        x = self.patch_embed(x)
        x = x + self.pos_embed[:, :x.shape[1], :x.shape[2], :]
        zs = []
        for depth, blk in enumerate(self.blocks, 1):
            x = blk(x)
            if depth in self.extract:
                zs.append(x)
        out = self.neck(x.permute(0, 3, 1, 2))
        return out.float().flatten(2).mean(dim=2), zs


class Conv2DBlock(nn.Module):
    """Conv 3x3 (pad 1) -> BN -> ReLU (CellViT's Dropout at rate 0, which
    holds no parameters, left out)."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.block = nn.Sequential(nn.Conv2d(cin, cout, 3, padding=1),
                                   BatchNorm2d(cout), nn.ReLU())

    def forward(self, x):
        return self.block(x)


class Deconv2DBlock(nn.Module):
    """ConvT 2x2 stride 2 -> conv 3x3 (pad 1) -> BN -> ReLU."""

    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.block = nn.Sequential(nn.ConvTranspose2d(cin, cout, 2, stride=2),
                                   nn.Conv2d(cout, cout, 3, padding=1),
                                   BatchNorm2d(cout), nn.ReLU())

    def forward(self, x):
        return self.block(x)


def upsampling_branch(cfg: CellViTConfig, n: int) -> nn.Sequential:
    """CellViT's `create_upsampling_branch` for n output channels."""
    e = cfg.embed_dim
    _, _, bot = cfg.skip_dims
    return nn.Sequential(OrderedDict([
        ("bottleneck_upsampler", nn.ConvTranspose2d(e, bot, 2, stride=2)),
        ("decoder3_upsampler", nn.Sequential(
            Conv2DBlock(2 * bot, bot), Conv2DBlock(bot, bot),
            Conv2DBlock(bot, bot), nn.ConvTranspose2d(bot, 256, 2, stride=2))),
        ("decoder2_upsampler", nn.Sequential(
            Conv2DBlock(512, 256), Conv2DBlock(256, 256),
            nn.ConvTranspose2d(256, 128, 2, stride=2))),
        ("decoder1_upsampler", nn.Sequential(
            Conv2DBlock(256, 128), Conv2DBlock(128, 128),
            nn.ConvTranspose2d(128, 64, 2, stride=2))),
        ("decoder0_header", nn.Sequential(
            Conv2DBlock(128, 64), Conv2DBlock(64, 64), HeadConv(64, n, 1))),
    ]))


# the branches: (HoVer-Net's name, CellViT's output key, decoder attribute)
BRANCHES = (("tp", "nuclei_type_map", "nuclei_type_maps_decoder"),
            ("np", "nuclei_binary_map", "nuclei_binary_map_decoder"),
            ("hv", "hv_map", "hv_map_decoder"))

# the encoder's outputs as the decoders take them: (z0, z1, z2, z3, z4,
# tissue logits); z1..z4 NCHW views of the blocks' channels-last outputs
Features = Tuple[torch.Tensor, ...]


class CellViT(nn.Module):
    """NCHW uint8/float RGB in [0, 255] -> CellViT's logits (`forward`),
    or the inference split `decode(encode(imgs))`."""

    # the parts `infer_output` times around `encode` and `decode`
    forward_parts = ("vit_encoder", "vit_decoder")

    def __init__(self, cfg: CellViTConfig):
        super().__init__()
        self.cfg = cfg
        e = cfg.embed_dim
        s11, s12, bot = cfg.skip_dims
        self.encoder = ImageEncoderViT(cfg)
        self.classifier_head = HeadLinear(cfg.out_chans,
                                          cfg.num_tissue_classes)
        self.decoder0 = nn.Sequential(Conv2DBlock(3, 32), Conv2DBlock(32, 64))
        self.decoder1 = nn.Sequential(Deconv2DBlock(e, s11),
                                      Deconv2DBlock(s11, s12),
                                      Deconv2DBlock(s12, 128))
        self.decoder2 = nn.Sequential(Deconv2DBlock(e, s11),
                                      Deconv2DBlock(s11, 256))
        self.decoder3 = nn.Sequential(Deconv2DBlock(e, bot))
        # in CellViT's order, which is its state_dict's
        self.nuclei_binary_map_decoder = upsampling_branch(cfg, 2)
        self.hv_map_decoder = upsampling_branch(cfg, 2)
        self.nuclei_type_maps_decoder = upsampling_branch(cfg, cfg.nr_types)
        self.set_dtypes()

    @classmethod
    def from_state_dict(cls, cfg: CellViTConfig,
                        state: Dict[str, torch.Tensor]) -> "CellViT":
        """The model holding `state` (strict), built without a random
        initialisation (on the meta device, the tensors then assigned)."""
        with torch.device("meta"):
            model = cls(cfg)
        model.load_state_dict(state, strict=True, assign=True)
        model.set_dtypes()
        return model

    def set_dtypes(self):
        """Each module's floating tensors to its dtype, cast once: the
        norms' and the heads' float32, the body's `dtype`."""
        for m in self.modules():
            if isinstance(m, (nn.LayerNorm, LayerNorm2d, nn.BatchNorm2d,
                              HeadConv, HeadLinear)):
                dt = torch.float32
            else:
                dt = self.cfg.dtype
            m._apply(lambda t: t.to(dt) if t.is_floating_point() else t,
                     recurse=False)

    def encode(self, imgs: torch.Tensor) -> Features:
        with span("hnt.cellvit.encoder"):
            x = ((imgs.float() / 255.0 - 0.5) / 0.5).to(self.cfg.dtype)
            tissue, zs = self.encoder(x)
            return (x, *(z.permute(0, 3, 1, 2) for z in zs),
                    self.classifier_head(tissue))

    def heads(self, feats: Features) -> Dict[str, torch.Tensor]:
        """{HoVer-Net branch name: NCHW logits at the input's size}."""
        z0, z1, z2, z3, z4, _ = feats
        b0, b1 = self.decoder0(z0), self.decoder1(z1)
        b2, b3 = self.decoder2(z2), self.decoder3(z3)
        out = {}
        for name, _, attr in BRANCHES:
            dec = getattr(self, attr)
            u = dec.bottleneck_upsampler(z4)
            u = dec.decoder3_upsampler(torch.cat([b3, u], dim=1))
            u = dec.decoder2_upsampler(torch.cat([b2, u], dim=1))
            u = dec.decoder1_upsampler(torch.cat([b1, u], dim=1))
            out[name] = dec.decoder0_header(torch.cat([b0, u], dim=1))
        return out

    def decode(self, feats: Features) -> Dict[str, torch.Tensor]:
        """{tp, np, hv}: NCHW logits of the centre `patch_output` of a
        `patch_input` patch (the same margin off a smaller input)."""
        with span("hnt.cellvit.decoder"):
            m = (self.cfg.patch_input - self.cfg.patch_output) // 2
            return {k: v[:, :, m:v.shape[2] - m, m:v.shape[3] - m]
                    for k, v in self.heads(feats).items()}

    def forward(self, imgs: torch.Tensor) -> Dict[str, torch.Tensor]:
        feats = self.encode(imgs)
        out = {"tissue_types": feats[-1]}
        heads = self.heads(feats)
        out.update((key, heads[name]) for name, key, _ in BRANCHES)
        return out
