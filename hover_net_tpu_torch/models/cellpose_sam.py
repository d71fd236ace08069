"""Cellpose-SAM as one PyTorch module: the Segment Anything ViT-L image
encoder re-cut to 8x8 patches, every block global, and Cellpose's
unpatchifying readout of [dY, dX, cellprob].

Written from Pachitariu, Rariden & Stringer, "Cellpose-SAM: superhuman
generalization for cellular segmentation" (bioRxiv, 2025) and Cellpose 4
(github.com/MouseLand/cellpose, cellpose/vit_sam.py::Transformer with
backbone "vit_l", ps 8, nout 3, bsize 256: the default model `cpsam`),
on SAM's encoder (segment_anything/modeling/image_encoder.py,
build_sam.py::build_sam_vit_l). The JAX package has no counterpart. The
module names are Cellpose's, so its state dict (`encoder.*`, `out.*`,
`W2`, `diam_labels`, `diam_mean`) loads with strict=True.

- input: each channel of the whole image normalised by Cellpose's
  `normalize99`, (x - p1) / (p99 - p1) with the 1st and 99th percentiles
  of the channel (`normalize99`, run on the card by the tile pipeline
  before it gathers the 256^2 blocks);
- `encoder.patch_embed.proj`: 8x8 conv at stride 8, 3 -> 1024 (SAM's
  16x16 kernel re-cut as `w[:, :, ::2, ::2]`), then `+ encoder.pos_embed`
  (SAM's 64^2 grid at stride 2: 32^2);
- 24 SAM blocks (models/cellvit.py's `Block`, `Attention`, `get_rel_pos`
  and `rel_pos_bias`): width 1024, 16 heads of 64, MLP 4096, exact GELU,
  LayerNorm eps 1e-6, qkv with bias; Cellpose sets every block's
  `window_size` to 0, so all 24 attend globally over the 32^2 tokens with
  the decomposed rel-pos bias, each block's tables (27 rows in the 20
  blocks SAM builds windowed, 127 in blocks 5, 11, 17 and 23) resized
  linearly to 63 rows;
- `encoder.neck`: 1x1 conv, LayerNorm2d, 3x3 conv, LayerNorm2d, 256
  channels, no bias;
- `out`: 1x1 conv 256 -> 3 * 8^2, then Cellpose's `conv_transpose2d` with
  the fixed identity `W2` at stride 8, which puts channel c * 64 + u * 8
  + v of token (i, j) at pixel (8 i + u, 8 j + v) of map c: here
  `F.pixel_shuffle(., 8)`, the same values with no arithmetic.

`forward` gives the [B, 3, H, W] map [dY, dX, cellprob] of a block;
`encode` and `decode` are the inference split (infer/steps.infer_output):
`decode` gives {"flows": ...} cut to the centre `patch_output` of a
`patch_input` block, so that HoVer-Net's stitching tiles an image (224^2
of each 256^2 block; Cellpose blends overlapping blocks with a taper
mask instead). What the model outputs picks the post-processing
(infer/steps.make_tile_pipeline): Cellpose's flow dynamics
(ops/flow_dynamics.py), not HoVer-Net's energy and K1.

Precision: the body (weights, matmuls, the residual stream) runs in
`cfg.dtype`; every LayerNorm and LayerNorm2d normalises in float32 and
rounds once; the attention's softmax accumulates in float32 inside the
fused kernel; the readout (`out`) and the fixed parameters run in
float32.

In a forward run inside `runtime.forward_events` every block's attention
adds its device time to the part `global_attn` (span
`hnt.cellvit.global_attn`, the blocks are CellViT's), and `infer_output`
adds `vit_encoder` (embedding, blocks and neck; span
`hnt.cellpose.encoder`) and `readout` (span `hnt.cellpose.readout`), once
a block of a forward batch, never per patch.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from ..runtime import span
from .cellvit import Block, HeadConv, LayerNorm, LayerNorm2d, PatchEmbed

# the architectures by `--model_mode`, each what it changes of
# `CellposeSAMConfig`'s defaults, which are the published Cellpose-SAM
# (Transformer("vit_l", ps=8, nout=3, bsize=256) on build_sam_vit_l, its
# 256^2 blocks stitched at 224^2)
CELLPOSE_MODES = {"cellpose_sam": {}}

# what a flow model outputs in place of HoVer-Net's np / hv (/ tp): the
# key of `decode`'s dict and its channels
FLOW_KEY = "flows"
FLOW_CHANNELS = ("dy", "dx", "cellprob")


@dataclasses.dataclass(frozen=True)
class CellposeSAMConfig:
    mode: str = "cellpose_sam"
    dtype: torch.dtype = torch.float32  # compute dtype of the body
    patch_size: int = 8
    embed_dim: int = 1024
    depth: int = 24
    num_heads: int = 16
    mlp_ratio: float = 4.0
    # the blocks' rel-pos tables as SAM builds them (2 L - 1 rows: L the
    # window in windowed blocks, SAM's grid in global ones)
    sam_window_size: int = 14
    sam_global_attn_indexes: Tuple[int, ...] = (5, 11, 17, 23)
    sam_grid: int = 64
    out_chans: int = 256
    nout: int = 3
    patch_input: int = 256  # Cellpose's bsize: pos_embed's grid is
    # patch_input / patch_size
    patch_output: int = 224
    nr_types: Optional[int] = None  # Cellpose-SAM does not type its masks

    def __post_init__(self):
        if self.nr_types:
            raise ValueError("Cellpose-SAM does not type its masks: give "
                             "no nr_types")

    @classmethod
    def for_mode(cls, mode: str, **kwargs) -> "CellposeSAMConfig":
        """The configuration of `--model_mode mode` (`CELLPOSE_MODES`)."""
        return cls(mode=mode, **CELLPOSE_MODES[mode], **kwargs)

    @property
    def patch_input_shape(self) -> int:
        return self.patch_input

    @property
    def patch_output_shape(self) -> int:
        return self.patch_output


def normalize99(img: torch.Tensor, src_hw: Tuple[int, int],
                offset: Tuple[int, int] = (0, 0)) -> torch.Tensor:
    """Cellpose's per-channel `normalize99` of the image at `offset` of
    size `src_hw` inside [H, W, C] `img` (a padded canvas), applied to the
    whole canvas in float32: (x - p1) / (p99 - p1) with the percentiles
    (linear interpolation, as `np.percentile`) of the image's own pixels;
    a channel whose percentiles are within 1e-3 is zero, and a constant
    channel is left as it is (Cellpose's `normalize_img`)."""
    oy, ox = offset
    h, w = src_hw
    x = img.float()
    src = x[oy:oy + h, ox:ox + w].reshape(h * w, -1).t()
    # sorted whole: torch.quantile takes no row over 2^24 pixels
    srt = torch.sort(src, dim=1).values
    n = srt.shape[1]
    pos = [q / 100.0 * (n - 1) for q in (1.0, 99.0)]
    i0 = torch.tensor([int(p) for p in pos], device=x.device)
    i1 = (i0 + 1).clamp(max=n - 1)
    frac = torch.tensor([p - int(p) for p in pos], device=x.device)
    lo, hi = (srt[:, i0] + (srt[:, i1] - srt[:, i0]) * frac).unbind(1)
    norm = torch.where(hi - lo > 1e-3, (x - lo) / (hi - lo),
                       torch.zeros_like(x))
    return torch.where(srt[:, -1] > srt[:, 0], norm, x)


class Encoder(nn.Module):
    """SAM's image encoder as Cellpose runs it: embedding, the blocks
    (each global), the neck; [B, out_chans, h, w]."""

    def __init__(self, cfg: CellposeSAMConfig):
        super().__init__()
        grid = cfg.patch_input // cfg.patch_size
        dim = cfg.embed_dim
        self.patch_embed = PatchEmbed(cfg.patch_size, dim)
        self.pos_embed = nn.Parameter(torch.zeros(1, grid, grid, dim))
        glob = frozenset(cfg.sam_global_attn_indexes)
        self.blocks = nn.ModuleList(
            Block(dim, cfg.num_heads, cfg.mlp_ratio,
                  0 if i in glob else cfg.sam_window_size, cfg.sam_grid)
            for i in range(cfg.depth))
        for blk in self.blocks:  # Cellpose: blk.window_size = 0
            blk.window = 0
            blk.part = "global_attn"
        out = cfg.out_chans
        self.neck = nn.Sequential(
            nn.Conv2d(dim, out, 1, bias=False), LayerNorm2d(out),
            nn.Conv2d(out, out, 3, padding=1, bias=False), LayerNorm2d(out))

    def forward(self, x):
        x = self.patch_embed(x) + self.pos_embed
        for blk in self.blocks:
            x = blk(x)
        return self.neck(x.permute(0, 3, 1, 2))


class CellposeSAM(nn.Module):
    """NCHW normalised float images -> [B, 3, H, W] float32 [dY, dX,
    cellprob] (`forward`), or the inference split `decode(encode(imgs))`."""

    # the parts `infer_output` times around `encode` and `decode`
    forward_parts = ("vit_encoder", "readout")
    # what `decode` gives (see infer/steps.make_tile_pipeline)
    outputs = FLOW_CHANNELS

    def __init__(self, cfg: CellposeSAMConfig):
        super().__init__()
        self.cfg = cfg
        ps, nout = cfg.patch_size, cfg.nout
        self.encoder = Encoder(cfg)
        self.out = HeadConv(cfg.out_chans, nout * ps * ps, 1)
        self.W2 = nn.Parameter(torch.eye(nout * ps * ps).reshape(
            nout * ps * ps, nout, ps, ps), requires_grad=False)
        self.diam_labels = nn.Parameter(torch.tensor([30.0]),
                                        requires_grad=False)
        self.diam_mean = nn.Parameter(torch.tensor([30.0]),
                                      requires_grad=False)
        self.set_dtypes()

    @classmethod
    def from_state_dict(cls, cfg: CellposeSAMConfig,
                        state: Dict[str, torch.Tensor]) -> "CellposeSAM":
        """The model holding `state` (strict), built without a random
        initialisation (on the meta device, the tensors then assigned)."""
        with torch.device("meta"):
            model = cls(cfg)
        model.load_state_dict(state, strict=True, assign=True)
        for p in (model.W2, model.diam_labels, model.diam_mean):
            p.requires_grad_(False)
        model.set_dtypes()
        return model

    def set_dtypes(self):
        """Each module's floating tensors to its dtype, cast once: the
        norms', the readout's and the fixed parameters' float32, the
        body's `dtype`."""
        for m in self.modules():
            if m is self or isinstance(m, (nn.LayerNorm, LayerNorm,
                                           LayerNorm2d, HeadConv)):
                dt = torch.float32
            else:
                dt = self.cfg.dtype
            m._apply(lambda t: t.to(dt) if t.is_floating_point() else t,
                     recurse=False)

    def encode(self, imgs: torch.Tensor) -> torch.Tensor:
        with span("hnt.cellpose.encoder"):
            return self.encoder(imgs.to(self.cfg.dtype))

    def readout(self, feats: torch.Tensor) -> torch.Tensor:
        """[B, 3, H, W] float32 at the input's size."""
        return F.pixel_shuffle(self.out(feats), self.cfg.patch_size)

    def decode(self, feats: torch.Tensor) -> Dict[str, torch.Tensor]:
        """{"flows": [B, 3, h, w]} of the centre `patch_output` of a
        `patch_input` block (the same margin off a smaller input)."""
        with span("hnt.cellpose.readout"):
            y = self.readout(feats)
            m = (self.cfg.patch_input - self.cfg.patch_output) // 2
            return {FLOW_KEY: y[:, :, m:y.shape[2] - m, m:y.shape[3] - m]}

    def forward(self, imgs: torch.Tensor) -> torch.Tensor:
        return self.readout(self.encode(imgs))
