"""Inference building blocks on tensors (tile and WSI paths).

Counterpart of hover_net_tpu/infer/steps.py. The output contract is the
JAX package's: a per-pixel channel concat of [tp argmax (typed only), np
foreground prob, hv_x, hv_y] in NHWC, float32. `infer_output` runs the
encoder's d0..d2 as the fused-block CUDA kernel K3 wherever the model and
the device allow it (`_use_fused_enc`), and `HoVerNet.encode` elsewhere.

`make_tile_pipeline` is the counterpart of the JAX `run_dynamic` program:
padded image -> patch gather -> forward -> stitch -> reflect-101 mirror
about the source with its valid mask -> post-processing (the CUDA tail
kernel on a GPU) -> uint16 label compaction -> per-instance tables.

`StageEvents` holds one pipeline call's CUDA events: the caller makes
one a call and reads it (`ms()`) after the call's outputs have reached
the host, so that timing a call never waits on the device.
"""

from __future__ import annotations

import contextlib
from typing import Dict, Optional, Tuple

import torch

from ..models.encoder_fused import fused_encode
from ..models.hovernet import HoVerNet, HoVerNetConfig
from ..ops.post_proc_cuda import proc_tail
from ..ops.post_proc_device import (
    compact_labels_u16,
    energy_inputs,
    instance_tables,
)
from ..runtime import forward_events


def _use_fused_enc(model: HoVerNet, device) -> bool:
    """Gate of the fused-block encoder (kernel K3, models/encoder_fused.py),
    decided from the model and the device alone: a HoVer-Net (K3 is its
    encoder's block; CellViT says no), fast mode (the 'SAME' stem),
    4 * width a multiple of 128, a bf16 body, a CUDA device, the model in
    eval mode (K3 folds the BatchNorms' running statistics) and autograd
    off (K3 has no backward). Elsewhere, and on the CPU, the forward runs
    the model's `encode`; `fused_encode` runs the fused path (the plain
    version on the CPU) when called directly."""
    cfg = model.cfg
    return (isinstance(cfg, HoVerNetConfig) and cfg.mode == "fast"
            and (4 * cfg.width) % 128 == 0
            and cfg.dtype == torch.bfloat16 and not model.training
            and not torch.is_grad_enabled()
            and torch.device(device).type == "cuda")


# set inside `standard_encoder()`: read by `infer_output` in every thread
_standard_only = False


@contextlib.contextmanager
def standard_encoder(on: bool = True):
    """Inside the block (`on`), `infer_output` runs `HoVerNet.encode` in
    every thread, also where `_use_fused_enc` would take K3; with `on`
    False it keeps the default. The measurement tools compare the two
    encoders on one card with it (chip_smoke.py, cli/probe_device_time,
    cli/fused_encoder_drift). Restored after."""
    global _standard_only
    prev, _standard_only = _standard_only, on
    try:
        yield
    finally:
        _standard_only = prev


# the tile pipeline's stages, in order: each one's device ms runs from
# the end of the one before (the first from the call's start)
STAGES = ("forward", "energy", "post_proc_tail", "tables")


class StageEvents:
    """The CUDA events of one tile pipeline call (none on another device).

    `stage(name)` closes a stage of `STAGES`; `part(name, start, end)`
    adds an interval inside one (the forward's `encoder` and `decoders`,
    summed over its sub-batches). `ms()` waits for the last event and
    gives each stage's and each part's device ms."""

    def __init__(self, device: torch.device):
        self.device = torch.device(device)
        self.on = self.device.type == "cuda"
        self.stages = []  # (name, event), the call's start first
        self.parts = []  # (name, start event, end event)

    def record(self):
        """A timing event recorded now on the device's current stream, or
        None off CUDA."""
        if not self.on:
            return None
        ev = torch.cuda.Event(enable_timing=True)
        ev.record(torch.cuda.current_stream(self.device))
        return ev

    def stage(self, name: str) -> None:
        if self.on:
            self.stages.append((name, self.record()))

    def part(self, name: str, start, end) -> None:
        if self.on:
            self.parts.append((name, start, end))

    def ms(self) -> Dict[str, float]:
        if self.stages:
            self.stages[-1][1].synchronize()
        elif self.parts:
            self.parts[-1][2].synchronize()
        else:
            return {}
        out = {name: prev.elapsed_time(ev) for (_, prev), (name, ev)
               in zip(self.stages, self.stages[1:])}
        for name, start, end in self.parts:
            out[name] = out.get(name, 0.0) + start.elapsed_time(end)
        return out


def infer_output(model: HoVerNet, imgs: torch.Tensor) -> torch.Tensor:
    """NHWC images [N, H, W, 3] (uint8 or float, 0..255) -> NHWC float32
    [N, h, w, C] head activations. Where `_use_fused_enc` allows it, and
    outside `standard_encoder()`, the encoder's d0..d2 run as kernel K3.
    Inside `forward_batches(...,
    events=)` (or wherever `runtime.forward_events` is set) the encoder's
    and the decoders' device time are added to the events' parts named by
    the model's `forward_parts`, `encoder` and `decoders` by default; a
    model may add parts of its own layers (models/cellvit.py)."""
    events = forward_events.get()
    start = events.record() if events is not None else None
    if not _standard_only and _use_fused_enc(model, imgs.device):
        feats = fused_encode(model, imgs)
    else:
        feats = model.encode(imgs.permute(0, 3, 1, 2))
    mid = events.record() if events is not None else None
    out = model.decode(feats)
    if events is not None:
        end = events.record()
        enc, dec = getattr(model, "forward_parts", ("encoder", "decoders"))
        events.part(enc, start, mid)
        events.part(dec, mid, end)
    parts = []
    if "tp" in out:
        tp = torch.argmax(torch.softmax(out["tp"], dim=1), dim=1)
        parts.append(tp[:, None].float())
    parts.append(torch.softmax(out["np"], dim=1)[:, 1:2])
    parts.append(out["hv"].float())
    return torch.cat(parts, dim=1).permute(0, 2, 3, 1)


def extract_patches(padded_img: torch.Tensor, coords: torch.Tensor,
                    size: int) -> torch.Tensor:
    """Gather [K, size, size, C] windows with top-left `coords` [K, 2]
    from an [H, W, C] image."""
    r = torch.arange(size, device=padded_img.device)
    rows = (coords[:, 0, None] + r)[:, :, None]
    cols = (coords[:, 1, None] + r)[:, None, :]
    return padded_img[rows, cols]


def reflect_canvas(full: torch.Tensor, src_hw: Tuple[int, int]):
    """Mirror [H, W, C] `full` reflect-101 about the source region
    [0, sh) x [0, sw) and build its valid mask. The mirror reads source
    rows and columns only, so it is idempotent."""
    sh, sw = src_hw
    rr = torch.arange(full.shape[0], device=full.device)
    cc = torch.arange(full.shape[1], device=full.device)
    ridx = torch.where(rr < sh, rr, (2 * sh - 2 - rr).clamp_min(0))
    cidx = torch.where(cc < sw, cc, (2 * sw - 2 - cc).clamp_min(0))
    valid = (rr < sh)[:, None] & (cc < sw)[None, :]
    return full[ridx][:, cidx], valid


def tables_tail(full: torch.Tensor, inst_batch: torch.Tensor,
                nr_types: Optional[int]):
    """uint16 label compaction and the packed per-instance tables (stats
    + boundary COO): what the host needs to build the json, in place of
    the label map."""
    typed = nr_types is not None
    inst, n_labels = compact_labels_u16(inst_batch)
    h, w = inst.shape[1], inst.shape[2]
    tp_map = (full[..., 0].to(torch.uint8) if typed
              else torch.zeros((h, w), dtype=torch.uint8, device=full.device))
    t = instance_tables(inst[0].to(torch.int32), tp_map,
                        coo_cap=min(1 << 16, h * w), nr_types=nr_types,
                        with_sums=typed)
    parts = [t["bbox"]]
    if "sum_yx" in t:
        parts += [t["sum_yx"], t["size"][:, None]]
    if "type_hist" in t:
        parts.append(t["type_hist"])
    tables = {"stats": torch.cat(parts, dim=-1), "coo": t["coo"],
              "coo_n": t["coo_n"]}
    return inst, n_labels, tp_map, tables


def forward_batches(model: HoVerNet, patches: torch.Tensor,
                    batch: int = 0,
                    events: Optional[StageEvents] = None) -> torch.Tensor:
    """`infer_output` over [K, H, W, 3] patches. batch > 0 splits the
    forward into balanced sub-batches of at most `batch` patches when K
    is more than twice that (80 patches at batch 32: 27 + 27 + 26, not
    32 + 32 + 16); otherwise one call takes all K. `events` receives the
    sub-batches' `encoder` and `decoders` parts."""
    token = forward_events.set(events)
    try:
        k = patches.shape[0]
        if batch and 2 * batch < k:
            nb = -(-k // batch)
            eff = -(-k // nb)
            return torch.cat([infer_output(model, patches[i:i + eff])
                              for i in range(0, k, eff)])
        return infer_output(model, patches)
    finally:
        forward_events.reset(token)


def assemble_grid(patch_out: torch.Tensor,
                  grid: Tuple[int, int]) -> torch.Tensor:
    """[R*C, h, w, ch] patch outputs of a row-major grid -> the
    [R*h, C*w, ch] map (the reshape-stitch of infer/tile.py:111-131 in
    the reference)."""
    r, c = grid
    k, h, w, ch = patch_out.shape
    if k != r * c:
        raise ValueError(f"{k} patch outputs for a {r}x{c} grid")
    full = patch_out.reshape(r, c, h, w, ch).permute(0, 2, 1, 3, 4)
    return full.reshape(r * h, c * w, ch)


def make_tile_pipeline(model: HoVerNet, grid: Tuple[int, int],
                       batch: int = 0):
    """(padded_img [H, W, 3], coords [K, 2], src_hw, events=None) ->
    (full, inst [H, W] uint16, n_labels [1], tp_map, tables) at canonical
    size.

    batch > 0 runs the forward in balanced sub-batches of at most `batch`
    patches when the grid holds more than twice that many.

    `events`, a `StageEvents` of the call's device, receives CUDA events
    at the ends of its `STAGES` (forward: gather to stitch; energy;
    post_proc_tail; tables) and the forward's `encoder` and `decoders`
    parts; the call itself never waits for them."""
    win = model.cfg.patch_input_shape
    nr_types = model.cfg.nr_types

    def forward_stitch(padded_img, coords, events=None):
        patches = extract_patches(padded_img, coords, win)
        return assemble_grid(forward_batches(model, patches, batch, events),
                             grid)

    @torch.no_grad()
    def run(padded_img: torch.Tensor, coords: torch.Tensor,
            src_hw: Tuple[int, int], events: Optional[StageEvents] = None):
        mark = events.stage if events is not None else lambda name: None
        mark("start")
        full = forward_stitch(padded_img, coords, events)
        mark("forward")
        full, valid = reflect_canvas(full, src_hw)
        seg = full[..., 1:4] if nr_types is not None else full[..., 0:3]
        blb, sob = energy_inputs(seg[None], valid[None])
        mark("energy")
        inst_b = proc_tail(blb, sob)
        mark("post_proc_tail")
        inst, n_labels, tp_map, tables = tables_tail(full, inst_b, nr_types)
        mark("tables")
        return full, inst[0], n_labels, tp_map, tables

    run.forward_stitch = forward_stitch
    return run
