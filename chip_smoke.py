"""Smoke run of hover_net_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. device: a CUDA card must be present; prints its name and power limit;
2. build: compiles the post-processing kernel K1 from csrc/;
3. K1 against its plain PyTorch version on the card: identical labels on
   a 1148^2 canvas of synthetic nuclei mirrored about a 1000^2 source
   (with its valid mask), a noisy map, an empty map and a 164^2 map;
   median times of both at 1148^2;
4. the tile path as a user runs it: TileInferManager, fast mode, width
   64, bf16 body, seeded random weights loaded from a `.tar`, three
   1000^2 images written as json, then one typed image (nr_types=5);
   K1 must have run once per image and the json must come from the
   device tables through the native contour tracer; prints the per-tile
   split of device and host time;
5. the width-64 bf16 forward agrees with its float32 version on one
   patch; finalize on real nuclei: the 1148^2 synthetic map through the
   kernel, the tables and the host finalize gives the instances of the
   plain path, exactly;
6. prints the kernel table as one JSON line, the card line, and last
   {"ok": true, "device": {...}}.

Outputs go to build/chip_smoke/ in the checkout.
"""

from __future__ import annotations

import json
import os
import shutil
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
SRC_HW = 1000      # source tile of the main path
CANVAS = 1148      # its canonical fast-mode canvas (7 x 164 + 92)
N_NUCLEI = 1200


def log(msg):
    print(msg, flush=True)


# ------------------------------------------------------ synthetic data

def synth_inst(h, w, n_nuclei, seed):
    """Disc nuclei of radius 5..10 dropped at random (later ones do not
    overwrite earlier ones): the bench recipe of the JAX package."""
    rng = np.random.default_rng(seed)
    inst = np.zeros((h, w), np.int32)
    yy, xx = np.mgrid[-12:13, -12:13]
    for k in range(1, n_nuclei + 1):
        cy, cx = rng.integers(14, h - 14), rng.integers(14, w - 14)
        r = rng.integers(5, 11)
        sub = inst[cy - 12:cy + 13, cx - 12:cx + 13]
        sub[((yy**2 + xx**2) <= r * r) & (sub == 0)] = k
    return inst


def synth_pred(inst):
    """(np prob, hv x, hv y) of an instance map: offsets from each
    instance's centroid, negatives and positives scaled to [-1, 1]."""
    ys, xs = np.nonzero(inst)
    lab = inst[ys, xs]
    n = int(inst.max()) + 1
    cnt = np.maximum(np.bincount(lab, minlength=n), 1)
    hv = np.zeros(inst.shape + (2,), np.float32)
    for ch, coord in enumerate((xs, ys)):
        off = coord - (np.bincount(lab, coord, n) / cnt)[lab]
        lo = np.zeros(n)
        hi = np.zeros(n)
        np.minimum.at(lo, lab, off)
        np.maximum.at(hi, lab, off)
        scale = np.where(off < 0, -lo[lab], hi[lab])
        hv[ys, xs, ch] = off / np.where(scale > 0, scale, 1.0)
    return np.dstack([(inst > 0).astype(np.float32), hv])


def mirrored_canvas(pred):
    """Reflect-101 a SRC_HW^2 map over the CANVAS^2 canvas, + valid mask."""
    rr = np.arange(CANVAS)
    idx = np.where(rr < SRC_HW, rr, 2 * SRC_HW - 2 - rr)
    valid = (rr < SRC_HW)[:, None] & (rr < SRC_HW)[None, :]
    return pred[idx][:, idx], valid


def synth_image(seed):
    """A 1000^2 RGB tile: pale background, purple nuclei."""
    inst = synth_inst(SRC_HW, SRC_HW, N_NUCLEI, seed)
    img = np.full((SRC_HW, SRC_HW, 3), (230, 200, 220), np.uint8)
    img[inst > 0] = (120, 60, 150)
    noise = np.random.default_rng(seed).integers(0, 20, img.shape)
    return (img - noise).astype(np.uint8)


# ------------------------------------------------------------- phases

def card_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def median_ms(fn, reps):
    import torch

    fn()  # warm-up
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def check_kernel(dev):
    """Phase 3: K1 == plain on four maps; times at 1148^2."""
    import torch

    from hover_net_tpu_torch.ops import post_proc_cuda as k1
    from hover_net_tpu_torch.ops.post_proc_device import energy_inputs

    pred, valid = mirrored_canvas(synth_pred(synth_inst(
        SRC_HW, SRC_HW, N_NUCLEI, 0)))
    rng = np.random.default_rng(1)
    noisy = pred + rng.normal(0, 0.1, pred.shape).astype(np.float32)
    small = synth_pred(synth_inst(164, 164, 30, 2))
    cases = [("canvas_1148", pred, valid), ("noisy_1148", noisy, valid),
             ("empty_1148", np.zeros_like(pred), valid),
             ("tile_164", small, None)]
    inputs = {}
    max_err = 0
    for name, p, v in cases:
        blb, sob = energy_inputs(
            torch.from_numpy(np.ascontiguousarray(p))[None].to(dev),
            None if v is None else torch.from_numpy(v)[None].to(dev))
        got = k1.proc_tail(blb, sob)
        want = k1.proc_tail_reference(blb, sob)
        torch.cuda.synchronize()
        n_diff = int((got != want).sum())
        max_err = max(max_err, int((got.long() - want.long()).abs().max()))
        n_inst = len(torch.unique(want)) - 1
        log(f"K1 vs plain {name} {tuple(blb.shape)}: {n_inst} instances, "
            f"{n_diff} labels differ")
        if n_diff:
            raise AssertionError(f"K1 disagrees with its plain version on "
                                 f"{name}")
        if name != "empty_1148" and n_inst < 10:
            raise AssertionError(f"{name}: only {n_inst} instances")
        inputs[name] = (blb, sob, got)
    blb, sob, got = inputs["canvas_1148"]
    ms = median_ms(lambda: k1.proc_tail(blb, sob), 20)
    plain_ms = median_ms(lambda: k1.proc_tail_reference(blb, sob), 5)
    log(f"K1 time at {CANVAS}^2: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms "
        f"(median, CUDA events)")
    return {"ms": ms, "plain_ms": plain_ms, "max_abs_err": max_err,
            "canvas": inputs["canvas_1148"]}


def write_tar(path, nr_types, seed):
    import torch

    from hover_net_tpu_torch.models.hovernet import HoVerNet, HoVerNetConfig

    net = HoVerNet(HoVerNetConfig(mode="fast", nr_types=nr_types, width=64),
                   generator=torch.Generator().manual_seed(seed))
    torch.save({"desc": net.state_dict()}, path)


def run_slice(work):
    """Phase 4: the tile path at full width, as a user calls it."""
    import cv2

    from hover_net_tpu_torch.infer.tile import TileInferManager
    from hover_net_tpu_torch.ops.post_proc_cuda import proc_tail

    runs = [("untyped", None, 3), ("typed", 5, 1)]
    tars, dirs = {}, {}
    for name, nr_types, n_img in runs:
        tars[name] = os.path.join(work, f"{name}.tar")
        write_tar(tars[name], nr_types, seed=0)
        dirs[name] = os.path.join(work, f"in_{name}")
        os.makedirs(dirs[name])
        for i in range(n_img):
            img = synth_image(10 + i + (nr_types or 0))
            cv2.imwrite(os.path.join(dirs[name], f"tile{i}.png"),
                        cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
    mgrs = {name: TileInferManager(
        model_path=tars[name], mode="fast", nr_types=nr_types, width=64,
        type_info_path=os.path.join(ROOT, "type_info.json"), device="cuda")
        for name, nr_types, _ in runs}

    proc_tail.launches = 0
    t0 = time.perf_counter()
    for name, _, n_img in runs:
        out = os.path.join(work, f"out_{name}")
        written = mgrs[name].process_file_list(dirs[name], out,
                                               save_format="json")
        if written != n_img:
            raise AssertionError(f"{name}: {written}/{n_img} images written")
    wall = time.perf_counter() - t0
    launches = proc_tail.launches

    n_images = sum(n for _, _, n in runs)
    log(f"slice: {n_images} images in {wall:.3f} s wall, K1 launches "
        f"{launches}")
    if launches != n_images:
        raise AssertionError(f"K1 ran {launches} times for {n_images} images")
    stages = ("forward", "energy", "post_proc_tail", "tables", "finalize_ms")
    for name, _, _ in runs:
        for t in mgrs[name].timings:
            if not t["from_tables"]:
                raise AssertionError(f"{t['name']}: the native table path "
                                     "did not run")
            path = os.path.join(work, f"out_{name}", "json",
                                f"{t['name']}.json")
            with open(path) as f:
                payload = json.load(f)
            if len(payload["nuc"]) != t["n_nuclei"]:
                raise AssertionError(f"{path}: json disagrees")
            log(f"tile {name}/{t['name']}: {t['n_nuclei']} nuclei; ms "
                + ", ".join(f"{s} {t[s]:.3f}" for s in stages))
    return launches, mgrs["untyped"]


def check_forward(mgr):
    """The bf16 forward of the tile path against the same weights in f32
    (TF32 off) on one 256^2 patch: finite, expected shapes, and within
    15% of the output scale (bf16 through ~100 layers of a random
    network: 3-5% measured on the CPU)."""
    import torch

    from hover_net_tpu_torch.models.hovernet import HoVerNet, HoVerNetConfig

    ref = HoVerNet(HoVerNetConfig(mode="fast", nr_types=mgr.nr_types,
                                  width=64)).to(mgr.device).eval()
    ref.load_state_dict(mgr.model.state_dict())
    x = torch.from_numpy(synth_image(99)[:256, :256]).permute(2, 0, 1)[None]
    x = x.to(mgr.device)
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=True,
                                                     allow_tf32=False):
        want = ref(x)
        got = mgr.model(x)
    for name, w in want.items():
        g = got[name]
        rel = float((g - w).abs().max() / w.abs().max())
        log(f"forward bf16 vs f32 {name} {tuple(g.shape)}: relative max "
            f"|delta| {rel:.4f}")
        if g.shape != (1, w.shape[1], 164, 164) or not torch.isfinite(g).all() \
                or rel > 0.15:
            raise AssertionError(f"forward head {name} is off")


def finalize_real_nuclei(mgr, canvas):
    """Phase 5: 1148^2 synthetic nuclei through the kernel, the tables and
    the host finalize == the plain path, instance for instance."""
    import torch

    from hover_net_tpu_torch.infer.steps import tables_tail
    from hover_net_tpu_torch.ops.post_proc_cuda import proc_tail_reference

    blb, sob, labels = canvas
    full = torch.zeros((CANVAS, CANVAS, 3), device=blb.device)
    img = np.zeros((SRC_HW, SRC_HW, 3), np.uint8)
    infos = {}
    for name, lab in (("kernel", labels),
                      ("plain", proc_tail_reference(blb, sob))):
        inst, n_labels, tp_map, tables = tables_tail(full, lab, None)
        _, inst_map, info = mgr.finalize_prediction(
            img, (full, inst[0], n_labels, tp_map, tables),
            pull_pred_map=False)
        if not mgr.last_from_tables:
            raise AssertionError("the native table path did not run")
        infos[name] = (inst_map, info)
    (map_k, info_k), (map_p, info_p) = infos["kernel"], infos["plain"]
    log(f"finalize at {CANVAS}^2: kernel {len(info_k)} nuclei, plain "
        f"{len(info_p)} nuclei")
    if len(info_k) < 100 or not np.array_equal(map_k, map_p) \
            or info_k.keys() != info_p.keys():
        raise AssertionError("finalized instances differ from the plain path")
    for k, v in info_p.items():
        w = info_k[k]
        if not all(np.array_equal(v[f], w[f])
                   for f in ("bbox", "contour", "centroid")):
            raise AssertionError(f"nucleus {k} differs")


def main():
    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    from hover_net_tpu_torch.ops import post_proc_cuda

    dev = torch.device("cuda")
    card = card_line()
    log(f"device: {torch.cuda.get_device_name(0)} ({card}), torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")

    t0 = time.perf_counter()
    post_proc_cuda.build()
    log(f"build: K1 built and loaded in {time.perf_counter() - t0:.3f} s")

    k1 = check_kernel(dev)

    work = os.path.join(ROOT, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    launches, mgr = run_slice(work)
    check_forward(mgr)
    finalize_real_nuclei(mgr, k1["canvas"])

    kernels = [{
        "name": "post_proc_tail",
        "route": "cuda",
        "source": "hover_net_tpu_torch/csrc/post_proc_tail.cu",
        "replaces": "hover_net_tpu/ops/post_proc_pallas.py:272",
        "launches": launches,
        "max_abs_err": k1["max_abs_err"],
        "ms": k1["ms"],
        "plain_ms": k1["plain_ms"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


if __name__ == "__main__":
    main()
