"""Device time of the tile pipeline's stages, of the forward's prefix cuts,
and of the forward's layer groups, on one CUDA card.

Counterpart of scripts/probe_device_time.py and
scripts/probe_forward_split.py:

    python -m hover_net_tpu_torch.cli.probe_device_time [--size 1000]
    python -m hover_net_tpu_torch.cli.probe_device_time --split forward
    python -m hover_net_tpu_torch.cli.probe_device_time --device cpu \
        --width 8 --size 300 --split forward

The model is the JAX probes' timing model: fast mode, untyped, a bf16
body, every BN scale and running variance 1 and every other weight 0.01.
The tile is the canonical canvas of a `--size`^2 source (a 7x7 grid of
256^2 patches, 1148^2, for 1000^2) of random pixels. Each stage runs
alone on the same inputs and is timed with CUDA events, the median of
`--reps` calls after a warm-up call, in place of the JAX scripts'
lax.scan K-deltas:

- forward: patch gather, forward (`forward_batches` at `--batch`, as the
  tile pipeline runs it) and stitch; its FLOPs (FlopCounterMode) and MFU
  against the H100's 989 TFLOP/s dense bf16 peak;
- post_proc: the masked Sobel energy and K1 on bench.py's synthetic
  prediction map over the canvas (the source's valid mask); prep: the
  energy alone (K1 is about post_proc - prep);
- compact: the uint16 compaction of K1's labels; tables: the compaction
  and the untyped instance tables (`steps.tables_tail`);
- the total, forward + post_proc + tables, and its tiles/s ceiling.

`--split forward` adds probe_forward_split.py's four prefix cuts, each
timed as the forward (gather included): `d0` (stem and d0), `enc` (and
d1..d3 and conv_bot), `dec1` (and the first decoder) and `full`, with the
stage deltas; and one torch.profiler window of the forward of `--batch`
patches (a WSI forward batch) whose kernel time is summed by layer group:
stem, d0..d3, conv_bot, each decoder's u3..u1, the heads (every u0), K3's
launches (`conv_gemm`), and "other" (what no group holds: the decoders'
upsample-and-add skips, the crops, the output concat). The window runs
twice: the standard cuDNN encoder (`steps.standard_encoder()`), then the
default forward (K3 for d0..d2 on the card). The forward stage runs the
default forward too, the prefix cuts the standard modules. On `--device
cpu` the host clock times the plain versions and the windows read null
(the profiler sees no device kernels).
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import json
import statistics
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..data.tiling import bucket_grid_dim, prepare_tile_patching
from ..infer.base import resolve_device
from ..infer.steps import (
    assemble_grid,
    extract_patches,
    forward_batches,
    infer_output,
    standard_encoder,
    tables_tail,
)
from ..models.hovernet import HoVerNet, HoVerNetConfig
from ..ops.post_proc_device import (
    compact_labels_u16,
    energy_inputs,
    proc_np_hv_batch,
)
from ..utils.crops import crop_op
from .recipe import card_line, synth_pred_map

# dense bf16 tensor-core peak of one H100 SXM (NVIDIA data sheet): the
# peak of PERF.md's kernel bounds
BF16_PEAK_FLOPS = 989e12
CUTS = ("d0", "enc", "dec1", "full")
K3_KERNEL = "conv_gemm"


def fill_synthetic(model: HoVerNet) -> HoVerNet:
    """bench.py's timing weights: BN scales and running variances 1, every
    other parameter and buffer 0.01 (the values do not change the work)."""
    with torch.no_grad():
        for name, t in model.state_dict().items():
            if name.endswith("num_batches_tracked"):
                continue
            bn_one = name.endswith("running_var") or (
                name.endswith(".weight") and t.dim() == 1)
            t.fill_(1.0 if bn_one else 0.01)
    return model


def forward_flops(model: HoVerNet, n_patches: int):
    """(total FLOPs, {module: FLOPs}) of the model's forward on
    `n_patches` patches, counted by FlopCounterMode on a meta copy (no
    compute)."""
    from torch.utils.flop_counter import FlopCounterMode

    meta = copy.deepcopy(model).to("meta")
    size = model.cfg.patch_input_shape
    x = torch.zeros((n_patches, 3, size, size), device="meta")
    with FlopCounterMode(display=False) as fc, torch.no_grad():
        meta(x)
    per_module = {name: sum(ops.values())
                  for name, ops in fc.get_flop_counts().items()}
    return fc.get_total_flops(), per_module


def canonical_grid(size: int, win: int, step: int):
    """(patch top-left coords [K, 2] int64, canonical grid, canvas side) of
    a size^2 tile's canonical patch grid (`bucket_grid_dim`)."""
    _, _, grid = prepare_tile_patching((size, size), win, step)
    rows, cols = bucket_grid_dim(grid[0]), bucket_grid_dim(grid[1])
    ys = np.arange(0, rows * step, step, dtype=np.int64)
    xs = np.arange(0, cols * step, step, dtype=np.int64)
    yy, xx = np.meshgrid(ys, xs, indexing="ij")
    coords = np.stack([yy.ravel(), xx.ravel()], axis=-1)
    return coords, (rows, cols), rows * step + (win - step)


def time_ms(fn, device, reps: int) -> float:
    """Median ms of `fn()` over `reps` calls after a warm-up call: CUDA
    events on the card, the host clock on the CPU."""
    fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def prefix_forward(model: HoVerNet, imgs: torch.Tensor, cut: str):
    """`HoVerNet.forward` on NCHW `imgs` up to `cut`: "d0" gives d0's
    output, "enc" conv_bot's, "dec1" the first decoder's head, "full"
    every head concatenated in branch order (the JAX probe's Prefix)."""
    cfg = model.cfg
    d0 = model.d0(model.conv0(imgs.to(cfg.dtype) / 255.0))
    if cut == "d0":
        return d0
    d1 = model.d1(d0)
    d2 = model.d2(d1)
    d3 = model.conv_bot(model.d3(d2))
    if cut == "enc":
        return d3
    k = cfg.ksize
    td1 = (2 * (d2.shape[2] - 9 * (k - 1)), 2 * (d2.shape[3] - 9 * (k - 1)))
    td0 = (2 * (td1[0] - 5 * (k - 1)), 2 * (td1[1] - 5 * (k - 1)))
    d1 = crop_op(d1, (d1.shape[2] - td1[0], d1.shape[3] - td1[1]), "NCHW")
    d0 = crop_op(d0, (d0.shape[2] - td0[0], d0.shape[3] - td0[1]), "NCHW")
    names = list(model.decoder)[:1 if cut == "dec1" else None]
    return torch.cat([model.decoder[n](d0, d1, d2, d3) for n in names], dim=1)


def layer_modules(model: HoVerNet):
    """[(group, module)] of the layer groups; a decoder's u3..u1 share its
    group, every branch's u0 is "heads"."""
    groups = [("stem", model.conv0)] + [
        (d, getattr(model, d)) for d in ("d0", "d1", "d2", "d3")]
    groups.append(("conv_bot", model.conv_bot))
    for name, branch in model.decoder.items():
        groups += [(f"decoder_{name}", getattr(branch, u))
                   for u in ("u3", "u2", "u1")]
        groups.append(("heads", branch.u0))
    return groups


@contextlib.contextmanager
def annotated(model: HoVerNet):
    """Each layer group's forward runs inside a profiler range named
    `hnt::<group>` (module hooks, removed on exit)."""
    handles = []
    for group, mod in layer_modules(model):
        stack = []

        def pre(_m, _inp, group=group, stack=stack):
            rf = torch.profiler.record_function(f"hnt::{group}")
            rf.__enter__()
            stack.append(rf)

        def post(_m, _inp, _out, stack=stack):
            stack.pop().__exit__(None, None, None)

        handles += [mod.register_forward_pre_hook(pre),
                    mod.register_forward_hook(post)]
    try:
        yield
    finally:
        for h in handles:
            h.remove()


def _group_of(event) -> str:
    """The layer group of the `hnt::` range around a host op, or "other"."""
    while event is not None:
        if event.name.startswith("hnt::"):
            return event.name[len("hnt::"):]
        event = event.cpu_parent
    return "other"


def layer_group_ms(model: HoVerNet, imgs: torch.Tensor, fused: bool):
    """One profiled forward (`infer_output`) of NHWC `imgs` with the
    standard encoder (`steps.standard_encoder()`) or (`fused`) the default
    one (K3 on a GPU): ({group: kernel ms}, total
    kernel ms, window ms on the host clock, the same forward's ms by CUDA
    events outside the profiler, how kernels were grouped), or None when
    the profiler saw no device event. A kernel is K3's by its name, else the
    group whose `hnt::` range spans its start on the device timeline (or,
    when the trace has no device spans, whose range held the host op that
    launched it), else "other"; "unattributed" is what neither way
    placed."""
    from torch.profiler import ProfilerActivity, profile, schedule

    cuda = imgs.device.type == "cuda"
    with torch.no_grad(), standard_encoder(not fused):
        infer_output(model, imgs)  # warm-up (and K3's packing)
        # one traced forward after one untraced warm-up step of the
        # profiler: a trace's first milliseconds can lose kernels (a first
        # window on the card once lost most of K3's and the stem's)
        traced = []
        with annotated(model), profile(
                activities=[ProfilerActivity.CPU]
                + [ProfilerActivity.CUDA] * cuda,
                schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                on_trace_ready=lambda p: traced.append(p.events())) as prof:
            for _ in range(2):
                if cuda:
                    torch.cuda.synchronize()
                t0 = time.perf_counter()
                infer_output(model, imgs)
                if cuda:
                    torch.cuda.synchronize()
                window = (time.perf_counter() - t0) * 1e3
                prof.step()
    events = traced[0]
    cuda_events = [e for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA]
    if not cuda_events:
        return None
    host_names = {e.name for e in events
                  if e.device_type == torch.autograd.DeviceType.CPU}
    # a device event named as a host event is an annotation's span on the
    # device timeline (the `hnt::` ranges among them), not a kernel
    spans = [(e.time_range.start, e.time_range.end, e.name[len("hnt::"):])
             for e in cuda_events if e.name.startswith("hnt::")]
    kernels = [e for e in cuda_events if e.name not in host_names]
    groups: Dict[str, float] = {}
    for k in kernels:
        g = "K3 (d0..d2)" if K3_KERNEL in k.name else next(
            (n for a, b, n in spans if a <= k.time_range.start < b), "other")
        groups[g] = groups.get(g, 0.0) + k.device_time / 1e3
    if not spans:  # no device spans: the group of each kernel's host op
        groups = {}
        for e in events:
            if e.device_type == torch.autograd.DeviceType.CPU:
                for k in e.kernels:
                    g = ("K3 (d0..d2)" if K3_KERNEL in k.name
                         else _group_of(e))
                    groups[g] = groups.get(g, 0.0) + k.duration / 1e3
    total = sum(k.device_time for k in kernels) / 1e3
    groups["unattributed"] = total - sum(groups.values())
    with torch.no_grad(), standard_encoder(not fused):
        event_ms = time_ms(lambda: infer_output(model, imgs), imgs.device, 3)
    return {"groups_ms": groups, "kernel_ms": total, "window_ms": window,
            "event_ms": event_ms,
            "by": "device spans" if spans else "host ops"}


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--size", type=int, default=1000)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--split", choices=("none", "forward"), default="none")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = card_line(dev)
    cfg = HoVerNetConfig(mode="fast", nr_types=None, width=args.width,
                         dtype=torch.bfloat16)
    model = fill_synthetic(HoVerNet(cfg)).to(dev).eval()
    win, step = cfg.patch_input_shape, cfg.patch_output_shape
    size = args.size
    coords, grid, canvas = canonical_grid(size, win, step)
    coords = torch.from_numpy(coords).to(dev)
    print(f"# {card}; grid {grid}, canvas {canvas}^2, width {args.width}",
          flush=True)
    img = torch.from_numpy(np.random.default_rng(0).integers(
        0, 255, (canvas, canvas, 3), dtype=np.uint8)).to(dev)
    full_h, full_w = grid[0] * step, grid[1] * step
    pred = torch.from_numpy(synth_pred_map(full_h, full_w))[None].to(dev)
    valid = torch.zeros((1, full_h, full_w), dtype=torch.bool, device=dev)
    valid[:, :size, :size] = True

    def ms(fn):
        return time_ms(torch.no_grad()(fn), dev, args.reps)

    def forward():
        patches = extract_patches(img, coords, win)
        return assemble_grid(forward_batches(model, patches, args.batch),
                             grid)

    stages = {"forward": ms(forward)}
    flops, _ = forward_flops(model, len(coords))
    out = {"forward_flops_per_tile": flops,
           "forward_mfu_pct": (flops / (stages["forward"] / 1e3)
                               / BF16_PEAK_FLOPS * 100.0)}
    print(f"forward_stitch_ms_per_tile: {stages['forward']:.3f} "
          f"({flops / 1e12:.4f} TFLOP, {out['forward_mfu_pct']:.1f} % of "
          f"{BF16_PEAK_FLOPS / 1e12:.0f} TFLOP/s)", flush=True)
    stages["post_proc"] = ms(lambda: proc_np_hv_batch(pred, valid))
    stages["prep"] = ms(lambda: energy_inputs(pred, valid))
    inst0 = proc_np_hv_batch(pred, valid)
    full0 = torch.zeros((full_h, full_w, 3), device=dev)
    stages["compact"] = ms(lambda: compact_labels_u16(inst0))
    stages["tables"] = ms(lambda: tables_tail(full0, inst0, None))
    total = stages["forward"] + stages["post_proc"] + stages["tables"]
    print(f"post_proc_ms_per_tile: {stages['post_proc']:.3f}; prep "
          f"{stages['prep']:.3f} (K1 ~= {stages['post_proc'] - stages['prep']:.3f})"
          f"; compact {stages['compact']:.3f}; tables {stages['tables']:.3f}",
          flush=True)
    print(f"TOTAL_device_ms_per_tile: {total:.3f} (=> {1000.0 / total:.2f} "
          "tiles/s ceiling)", flush=True)
    out.update(stages_ms=stages, total_ms=total,
               tiles_per_sec_ceiling=1000.0 / total)

    if args.split == "forward":
        prefix = {}
        for cut in CUTS:
            prefix[cut] = ms(lambda cut=cut: prefix_forward(
                model, extract_patches(img, coords, win).permute(0, 3, 1, 2),
                cut))
            print(f"prefix[{cut}]: {prefix[cut]:.3f} ms", flush=True)
        split = {"stem+d0": prefix["d0"],
                 "d1-d3+conv_bot": prefix["enc"] - prefix["d0"],
                 "decoder (one)": prefix["dec1"] - prefix["enc"],
                 "decoders (the others)": prefix["full"] - prefix["dec1"]}
        for k, v in split.items():
            print(f"stage {k}: {v:.3f} ms", flush=True)
        batch = extract_patches(img, coords, win)[:args.batch].contiguous()
        windows = {}
        for name, fused in (("cudnn", False), ("fused_enc", True)):
            windows[name] = layer_group_ms(model, batch, fused)
            w = windows[name]
            print(f"layer groups, {name}, batch {len(batch)}: " + (
                "not measured (no device kernels)" if w is None else
                f"{w['kernel_ms']:.3f} ms of kernels in a {w['window_ms']:.3f}"
                f" ms window ({w['event_ms']:.3f} ms by CUDA events "
                "unprofiled): " + ", ".join(
                    f"{g} {v:.3f}" for g, v in sorted(
                        w["groups_ms"].items(), key=lambda kv: -kv[1]))),
                flush=True)
        out.update(prefix_ms=prefix, split_ms=split, layer_groups=windows,
                   layer_groups_batch=len(batch))
    out.update(width=args.width, size=size, device=str(dev), card=card)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
