"""Slide traffic for a ViT configuration (CellViT-SAM-H): whole
pseudo-slides through `run_infer wsi --model_mode <mode>`, that is
`WSIInferManager.process_wsi_list`, one slide a call, back to back.

The slides, the mask, the warm-up, the window, `wsi_mpx_per_s` and the
three numbers of `correct` are `traffic/wsi.py`'s (its painter and helpers
are imported); what this kind has of its own:

- the weights: `reference/cellvit_recipe.py`, trained where missing and
  left out of `setup_s`;
- the reference: the plain float32 CellViT (`reference/cellvit.py`) over
  the patches whose centre `patch_output` meets a checked region
  (`CellViTReference`);
- the FLOP counts of the per-layer shares: the reference's whole forward
  of one patch, and its attention modules (qkv, the scores, the
  relative-position products, the weighted sum and proj: the work inside
  the program's `global_attn` and `window_attn` parts);
- the control (`python3 -m benchmark.traffic.wsi_vit --workload <cell>
  --seeds ...`): the reference with every convolution, transposed
  convolution, linear layer and attention matmul rounded to fp8 in the
  program's place, judged by the cell's limits as a run is;
  `--rounding bf16` gives the bf16 witness. The program's own readings
  over many seeds are `benchmark.control --program`'s.

A traced run's facts hold `traffic/wsi.py`'s keys, so its `.wsi` readers
read this kind too, with `attn_flops_per_patch` and `traced_slide` (the
traced slide's timing key) beside them.
"""

from __future__ import annotations

import argparse
import functools
import json
import logging
import os
import sys
import time

import numpy as np

from .. import common
from ..reference import compare
from ..reference.geometry import slide_patches, slide_windows
from ..reference.infer import Reference
from .wsi import (
    LOGGER,
    MASK_SCALE,
    _Errors,
    _one_slide_dirs,
    checked_slide,
    draw_regions,
    draw_tile,
    paint_one,
    paint_slides,
)


class CellViTReference(Reference):
    """`reference.infer.Reference` over the plain CellViT: float32, TF32
    off, `batch` patches a forward; a patch's map is the centre
    `patch_output`^2 of its outputs. `rounding` (`lowp.ROUNDINGS`) puts
    the control's or the witness's rounding on every convolution, linear
    layer and attention matmul but the float32 heads."""

    def __init__(self, cfg: dict, weights: str, device: str,
                 rounding=None, batch: int = 2):
        import torch

        from ..reference.cellvit import CellViTRef, set_quant
        from ..reference.lowp import ROUNDINGS

        self.cfg, self.device, self.batch = cfg, device, batch
        self.model = CellViTRef(cfg, cfg["nr_types"])
        state = torch.load(weights, map_location="cpu", weights_only=True)
        self.model.load_state_dict(state["desc"])
        self.model.to(device).eval()
        if rounding is not None:
            set_quant(self.model, ROUNDINGS[rounding])
        self.win, self.step = cfg["patch_input"], cfg["patch_output"]

    def patches(self, patches: np.ndarray) -> np.ndarray:
        """[K, win, win, 3] uint8 -> [K, step, step, 4] float32 maps."""
        import torch

        from ..reference.cellvit import branch_logits
        from ..reference.model import head_maps

        m = (self.win - self.step) // 2
        out = []
        with torch.no_grad():
            for i in range(0, len(patches), self.batch):
                x = torch.from_numpy(np.ascontiguousarray(
                    patches[i:i + self.batch])).to(self.device)
                maps = head_maps(branch_logits(self.model(
                    x.permute(0, 3, 1, 2))))
                out.append(maps[:, m:m + self.step, m:m + self.step]
                           .cpu().numpy())
        return np.concatenate(out)


@functools.lru_cache(maxsize=4)
def vit_flops(cfg_json: str, size: int):
    """(FLOPs of one forward of a `size`^2 patch through the reference,
    FLOPs of its attention modules), a multiply-add counting 2, counted
    by `FlopCounterMode` on the meta device."""
    import re

    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from ..reference.cellvit import CellViTRef

    cfg = json.loads(cfg_json)
    with torch.device("meta"):
        model = CellViTRef(cfg, cfg["nr_types"]).eval()
        x = torch.zeros(1, 3, size, size)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(x)
    attn = sum(sum(ops.values()) for name, ops
               in counter.get_flop_counts().items()
               if re.fullmatch(r".*\.encoder\.blocks\.\d+\.attn", name))
    return int(counter.get_total_flops()), int(attn)


def ensure_supported(mode: str):
    """Fail at once where the program has no `--model_mode mode` (a
    program from before the mode: nothing is trained or painted)."""
    try:
        from hover_net_tpu_torch.models.zoo import MODES
    except ImportError as e:
        raise SystemExit(f"the program has no model zoo ({e}): "
                         f"--model_mode {mode} is not supported")
    if mode not in MODES:
        raise SystemExit(f"the program has no --model_mode {mode}")


def weights(ctx) -> str:
    """The configuration's cached recipe weights; the seconds of training
    them where missing are left out of `setup_s`."""
    from ..reference import cellvit_recipe

    t = time.perf_counter()
    path = cellvit_recipe.ensure_weights(ctx.cfg)
    spent = time.perf_counter() - t
    ctx.excluded_s += spent
    if spent > 1:
        common.log(f"recipe weights trained in {spent:.3f} s, left out of "
                   f"setup_s")
    return path


def run(ctx: common.Context) -> dict:
    ensure_supported(ctx.cfg["mode"])
    import cv2
    import torch

    from hover_net_tpu_torch.infer.wsi import WSIInferManager

    cell, cfg = ctx.cell, ctx.cfg
    work = ctx.workdir()
    wts = weights(ctx)
    src = os.path.join(work, "src")
    os.makedirs(src)
    slides = paint_slides(ctx, src, src)
    warm = cell["warm_size"]
    np.save(os.path.join(src, "warm.npy"), slides[0][0][:warm, :warm])
    wm = -(-warm // MASK_SCALE)
    cv2.imwrite(os.path.join(src, "warm.png"), slides[0][1][:wm, :wm] * 255)
    check_slide = checked_slide(ctx)
    type_info = common.write_type_info(ctx)

    handler = _Errors()
    logger = logging.getLogger(LOGGER)
    logger.addHandler(handler)
    logger.propagate = False
    kept, current = {}, [None]
    stretch = None
    if ctx.trace:
        from ..trace import Stretch, span

        stretch = Stretch(work)

    mgr = WSIInferManager(
        model_path=wts, mode=cfg["mode"], nr_types=cfg["nr_types"],
        type_info_path=type_info, dtype=getattr(torch, cfg["dtype"]),
        batch_size=cfg["batch_size"], device=ctx.device,
        chunk_shape=cell["chunk_shape"], tile_shape=cell["tile_shape"],
        ambiguous_size=cell["ambiguous_size"], proc_mag=40,
        cache_path=os.path.join(work, "cache"))
    post_process = mgr.post_process_phases

    def tapped():
        if current[0] == check_slide:
            kept["pred"] = mgr._pred_dev
        return post_process()

    mgr.post_process_phases = tapped
    if stretch is not None:
        mgr._run_chunk = span("bench.chunk", mgr._run_chunk)
        mgr._dispatch_post_processing = span(
            "bench.post_proc_phase", mgr._dispatch_post_processing)
    _, d_in, d_mask = _one_slide_dirs(work, "warm", "warm")
    mgr.process_wsi_list(d_in, os.path.join(work, "out", "warm"),
                         input_mask_dir=d_mask)
    mgr.timings.clear()
    traced = cell["trace_slide"]
    if ctx.device.startswith("cuda"):
        torch.cuda.synchronize()
    setup_s = ctx.elapsed()

    written, calls = 0, 0
    t_start = time.perf_counter()
    while time.perf_counter() - t_start < ctx.seconds:
        _, d_in, d_mask = _one_slide_dirs(
            work, f"w{calls % len(slides)}", calls)
        current[0] = calls
        if stretch is not None and calls == traced:
            stretch.start()
        written += mgr.process_wsi_list(
            d_in, os.path.join(work, "out", str(calls)),
            input_mask_dir=d_mask)
        if stretch is not None and calls == traced:
            stretch.stop()
        calls += 1
    window_s = time.perf_counter() - t_start
    if stretch is not None and stretch.prof is not None \
            and stretch.host_s is None:
        stretch.stop()
    timings = dict(mgr.timings)
    size = cell["slide_size"]
    mpx = calls * size * size / 1e6
    device = common.device_info(ctx.device)
    img, mask = slides[check_slide]
    regions = draw_regions(ctx, mask)
    box = draw_tile(ctx, mask)
    port, pred = None, kept.pop("pred", None)
    if pred is not None:
        r, t = cell["check_region"], cell["tile_shape"]
        port = {"regions": [pred[y:y + r, x:x + r].float().cpu().numpy()
                            for y, x in regions],
                "tile": pred[box[0]:box[0] + t, box[1]:box[1] + t]
                .float().cpu().numpy()}
    del mgr, pred
    logger.removeHandler(handler)
    common.free_cuda()

    json_path = os.path.join(work, "out", str(check_slide),
                             f"s{check_slide:03d}.json")
    out = {"attempted": calls, "failed": calls - written, "device": device,
           "e2e": {"setup_s": setup_s, "wsi_mpx_per_s": mpx / window_s},
           "checks": check(ctx, wts, slides[check_slide], regions, box,
                           port, json_path)}
    common.log(f"window {window_s:.3f} s, {written} slides; setup "
               f"{setup_s:.3f} s")
    if stretch is not None:
        img, mask = slides[traced % len(slides)]
        win, step = cfg["patch_input"], cfg["patch_output"]
        summary = stretch.summary()
        flops, attn = vit_flops(json.dumps(cfg, sort_keys=True), win)
        out["trace"] = summary
        out["facts"] = {
            "timings": timings, "mpx": mpx, "trace": summary,
            "flops_per_patch": flops, "attn_flops_per_patch": attn,
            "traced_slide": f"s{traced:03d}",
            "patches": len(slide_patches(img.shape[:2], mask,
                                         cell["chunk_shape"], win, step)),
            "k1_pixels": sum(h * w for h, w in slide_windows(
                img.shape[:2], mask, cell["tile_shape"],
                cell["ambiguous_size"])),
        }
    return out


def check(ctx, wts, slide, regions, box, port, json_path) -> dict:
    """`traffic/wsi.check` with the CellViT reference: the numbers that
    decide `correct`, each [value, limit]."""
    from ..reference.postproc import proc_np_hv

    cell, cfg = ctx.cell, ctx.cfg
    limits = cell["limits"]
    if port is None or not os.path.exists(json_path):
        return {"checked_slide_missing": [1, 0]}
    img, mask = slide
    boxes = slide_patches(img.shape[:2], mask, cell["chunk_shape"],
                          cfg["patch_input"], cfg["patch_output"])
    ref = CellViTReference(cfg, wts, ctx.device)
    nuc = compare.load_nuclei(json_path)
    r, m = cell["check_region"], cell["margin"]
    interior = np.zeros((r, r), bool)
    interior[m:r - m, m:r - m] = True
    tally = compare.Tally(True)
    for (y, x), port_map in zip(regions, port["regions"]):
        ref_map = ref.region(img, boxes, (y, x), r)
        tally.add_maps(port_map, ref_map)
        ref_inst, ref_types = compare.reference_instances(ref_map, True)
        lab, types = compare.raster(nuc, (y, x), (r, r))
        tally.add_match(*compare.match(ref_inst, ref_types, lab, types,
                                       interior))
    t = cell["tile_shape"]
    band = 2 * cell["ambiguous_size"] + m
    inner = np.zeros((t, t), bool)
    inner[band:t - band, band:t - band] = True
    lab, _ = compare.raster(nuc, box, (t, t))
    counted, missed, _ = compare.match(
        proc_np_hv(port["tile"][..., 1:4]), None, lab, None, inner)
    tally.add_stage(counted, missed)
    common.log(f"readings (not compared) {tally.readings()}")
    return {k: [v, limits[k]] for k, v in tally.numbers().items()}


def control_checks(ctx, wts: str, rounding: str = "fp8") -> dict:
    """{name: [value, limit]}: the reference under `rounding` in the
    program's place against the float32 reference, on the slide regions
    that a run with the seed checks, each number beside the cell's
    limit."""
    cfg, cell = ctx.cfg, ctx.cell
    ref = CellViTReference(cfg, wts, ctx.device)
    ctl = CellViTReference(cfg, wts, ctx.device, rounding=rounding)
    tally = compare.Tally(True)
    img, mask = paint_one(ctx, checked_slide(ctx))
    boxes = slide_patches(img.shape[:2], mask, cell["chunk_shape"],
                          cfg["patch_input"], cfg["patch_output"])
    r, m = cell["check_region"], cell["margin"]
    interior = np.zeros((r, r), bool)
    interior[m:r - m, m:r - m] = True
    for y, x in draw_regions(ctx, mask):
        ref_map = ref.region(img, boxes, (y, x), r)
        ctl_map = ctl.region(img, boxes, (y, x), r)
        tally.add_maps(ctl_map, ref_map)
        ref_inst, ref_types = compare.reference_instances(ref_map, True)
        ctl_inst, ctl_types = compare.reference_instances(ctl_map, True)
        tally.add_match(*compare.match(ref_inst, ref_types, ctl_inst,
                                       ctl_types, interior))
    common.log(f"readings (not compared) {tally.readings()}")
    limits = cell["limits"]
    return {k: [v, limits[k]] for k, v in tally.numbers().items()}


def main(argv=None):
    p = argparse.ArgumentParser("benchmark.traffic.wsi_vit")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--rounding", default="fp8", choices=("fp8", "bf16"))
    args = p.parse_args(argv)
    common.setup_env()
    from .. import run

    for seed in args.seeds:
        t0 = time.perf_counter()
        ctx = run.make_context(argparse.Namespace(
            workload=args.workload, seed=seed, seconds=0, trace=0))
        checks = control_checks(ctx, weights(ctx), args.rounding)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "rounding": args.rounding,
                          "correct": run.judge(checks),
                          "checks": {k: {"value": v, "limit": lim}
                                     for k, (v, lim) in checks.items()},
                          "seconds": time.perf_counter() - t0}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
