"""The fused-block encoder: HoVerNet's d0..d2 as kernel K3.

Counterpart of hover_net_tpu/models/encoder_pallas.py. `pack_block`
folds a `ResidualBlock` module's inference BatchNorms and lays out its
weights as the JAX `pack_block` does; `fused_encoder_feats` and
`fused_forward` mirror the JAX functions of the same names:

- the stem `conv0` runs as the standard module; its output turns
  channels-last once, and d0, d1 and d2 (split 3 + 3, the rolling
  shortcut crossing the cut) run as `ops.fused_block_cuda.fused_block_apply`
  (the CUDA kernel for CUDA tensors, its plain version for CPU tensors);
- d3 stays the standard module; `conv_bot` is a 1x1 product accumulated
  in f32 and rounded to bf16;
- the decoders are the model's own `DecoderBranch`es (`HoVerNet.decode`),
  fed NCHW views of the channels-last features (`fused_encode`).

Fast mode only (the 'SAME' stem). The model's body must be bf16. The
inference forward (`infer/steps.infer_output`) runs `fused_encode` by
default wherever `steps._use_fused_enc` allows it: a CUDA device, fast
mode, a bf16 body, 4 * width a multiple of 128, the model in eval mode and
autograd off.
"""

from __future__ import annotations

from typing import Dict, List, Tuple

import torch

from ..ops.fused_block_cuda import (
    BF16,
    _dot,
    _full_f32_matmul,
    fused_block_apply,
    kernel_units,
)
from ..utils.crops import crop_op
from .blocks import BN_EPS, ResidualBlock
from .hovernet import Features, HoVerNet


# the fused encoder's four block calls: d0, d1, and d2 cut 3 + 3 (the
# rolling shortcut crosses the cut): (name, block, first unit, the
# arguments of fused_block_apply)
CALLS = (("d0", "d0", 0, dict(count=3, stride=1)),
         ("d1", "d1", 0, dict(count=4, stride=2)),
         ("d2a", "d2", 0, dict(count=3, stride=2, final_bn=False)),
         ("d2b", "d2", 3, dict(count=3, stride=1, has_u0=False)))

Packed = Dict[str, torch.Tensor]
Packs = Dict[str, Tuple[Packed, List[Packed]]]


def _bn_affine(bn) -> Tuple[torch.Tensor, torch.Tensor]:
    """Inference BatchNorm as per-channel (scale, offset), folded in f32
    from the BN's float32 tensors (a bf16-body model keeps them in
    float32), as the JAX `_bn_affine` folds them."""
    inv = 1.0 / torch.sqrt(bn.running_var.float() + BN_EPS)
    scale = bn.weight.float() * inv
    offset = bn.bias.float() - bn.running_mean.float() * scale
    return scale, offset


def _w1x1(conv) -> torch.Tensor:
    """OIHW 1x1 weight -> [in, out] bf16."""
    return conv.weight[:, :, 0, 0].t().to(BF16)


def _w3x3(conv) -> torch.Tensor:
    """OIHW 3x3 weight -> [9, in, out] bf16, tap = dy * 3 + dx."""
    w = conv.weight
    return w.permute(2, 3, 1, 0).reshape(9, w.shape[1], w.shape[0]).to(BF16)


@torch.no_grad()
def pack_block(block: ResidualBlock, count: int, *, has_u0: bool = True,
               final_bn: bool = True, unit_base: int = 0
               ) -> Dict[str, torch.Tensor]:
    """Kernel-ready parameters of `count` units of `block` (or of the
    continuation chain from unit `unit_base` when has_u0 is False), with
    the JAX `pack_block`'s keys and layouts."""
    out: Dict[str, torch.Tensor] = {}
    rest_start = unit_base
    if has_u0:
        u0 = block.units[0]._modules
        out["wsc"] = _w1x1(block.shortcut)
        out["w1_0"] = _w1x1(u0["conv1"])
        out["s1_0"], out["o1_0"] = _bn_affine(u0["conv1/bn"])
        out["w2_0"] = _w3x3(u0["conv2"])
        out["s2_0"], out["o2_0"] = _bn_affine(u0["conv2/bn"])
        out["w3_0"] = _w1x1(u0["conv3"])
        rest_start = 1
    idxs = range(rest_start, unit_base + count)
    if len(idxs):
        cols = {k: [] for k in ("ps", "po", "w1r", "s1r", "o1r", "w2r",
                                "s2r", "o2r", "w3r")}
        for i in idxs:
            m = block.units[i]._modules
            for (ks, ko), bn in ((("ps", "po"), m["preact/bn"]),
                                 (("s1r", "o1r"), m["conv1/bn"]),
                                 (("s2r", "o2r"), m["conv2/bn"])):
                s, o = _bn_affine(bn)
                cols[ks].append(s)
                cols[ko].append(o)
            cols["w1r"].append(_w1x1(m["conv1"]))
            cols["w2r"].append(_w3x3(m["conv2"]))
            cols["w3r"].append(_w1x1(m["conv3"]))
        for k, v in cols.items():
            out[k] = torch.cat(v) if k == "w2r" else torch.stack(v)
    if final_bn:
        out["sb"], out["ob"] = _bn_affine(block.blk_bna.bn)
    return out


def _folded(model: HoVerNet) -> List[Tuple[dict, str]]:
    """(owner, key) of each parameter and buffer of d0..d2, the tensors the
    packs fold: the module's `_parameters` or `_buffers` dict and the
    tensor's key in it."""
    return [(own, k) for block in (model.d0, model.d1, model.d2)
            for mod in block.modules()
            for own in (mod._parameters, mod._buffers)
            for k, t in own.items() if t is not None]


@torch.no_grad()
def pack_encoder(model: HoVerNet) -> Packs:
    """{call: (packed, the kernel's layout of it)} for the four block
    calls of `CALLS`, built once per set of weights (cached on the model;
    rebuilt when a tensor of d0..d2 is replaced or changes in place, as
    `load_state_dict` changes it, or the model moves to another device,
    as a copy of it does). The check of a cached set looks up each folded
    tensor where its module keeps it and reads its version, so it walks
    no module tree on a forward. Built with autograd off, the packs hold
    no graph, so the model stays `copy.deepcopy`-able after its first
    fused forward (`InferManagerBase.model_on` copies it then)."""
    dev = next(model.parameters()).device
    cached = getattr(model, "_fused_packs", None)
    if cached is not None and cached[0] == dev and all(
            own[k] is t and t._version == v for own, k, t, v in cached[1]):
        return cached[2]
    folded = [(own, k, own[k], own[k]._version) for own, k in _folded(model)]
    packs = {}
    for name, block, base, kw in CALLS:
        flags = {k: v for k, v in kw.items() if k != "stride"}
        packed = pack_block(getattr(model, block), unit_base=base, **flags)
        packs[name] = (packed, kernel_units(packed, dev, **flags))
    model._fused_packs = (dev, folded, packs)
    return packs


def fused_encoder_feats(model: HoVerNet, imgs: torch.Tensor):
    """NHWC patches [N, S, S, 3] (uint8/float, 0..255) -> (d0, d1, d2, d3)
    NHWC bf16 feature maps before `conv_bot`, as the model computes them
    (`HoVerNet.forward`)."""
    cfg = model.cfg
    if cfg.mode != "fast":
        raise ValueError("the fused encoder runs in fast mode only")
    pk = pack_encoder(model)
    x = model.conv0(imgs.permute(0, 3, 1, 2).to(cfg.dtype) / 255.0)
    x = x.permute(0, 2, 3, 1).to(BF16).contiguous()  # channels-last, once
    feats = []
    for name, _, _, kw in CALLS:
        packed, units = pk[name]
        x = fused_block_apply(x, packed, units=units, **kw)
        feats.append(x)
    d0, d1, _, d2 = feats
    d3 = model.d3(d2.permute(0, 3, 1, 2)).permute(0, 2, 3, 1)
    return d0, d1, d2, d3


def fused_forward(model: HoVerNet, imgs: torch.Tensor
                  ) -> Dict[str, torch.Tensor]:
    """The inference forward with the fused encoder: NHWC patches ->
    {branch: NCHW float32 logits}, as `model(imgs.permute(0, 3, 1, 2))`
    returns them."""
    return model.decode(fused_encode(model, imgs))


def fused_encode(model: HoVerNet, imgs: torch.Tensor) -> Features:
    """The fused encoder's features as `HoVerNet.encode` returns them:
    NHWC patches -> (d0, d1, d2, d3) NCHW, `conv_bot` applied and the
    skips cropped."""
    d0, d1, d2, d3 = fused_encoder_feats(model, imgs)
    with _full_f32_matmul():
        d3 = _dot(d3, model.conv_bot.weight[:, :, 0, 0].t())
    d3 = d3.permute(0, 3, 1, 2)
    d0, d1, d2 = (t.permute(0, 3, 1, 2) for t in (d0, d1, d2))

    k = model.cfg.ksize
    td1 = (2 * (d2.shape[2] - 9 * (k - 1)), 2 * (d2.shape[3] - 9 * (k - 1)))
    td0 = (2 * (td1[0] - 5 * (k - 1)), 2 * (td1[1] - 5 * (k - 1)))
    d1 = crop_op(d1, (d1.shape[2] - td1[0], d1.shape[3] - td1[1]), "NCHW")
    d0 = crop_op(d0, (d0.shape[2] - td0[0], d0.shape[3] - td0[1]), "NCHW")
    return d0, d1, d2, d3
