"""Smoke run of hover_net_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. device: a CUDA card must be present; prints its name and power limit;
2. build: compiles the kernels from csrc/, one nvcc per source, started
   together: post_proc_tail.cu (K1, K2 and K4) and fused_block.cu (K3),
   whose build goes on beside phase 3 (it uses K1 alone) and is
   waited for by phase 4's tile path (its encoder is K3) and at phase 6;
   prints K3's registers (ptxas) and its count of HGMMA (wgmma) and
   UTMALDG (TMA load) instructions (cuobjdump), and fails without both;
3. K1 against its plain PyTorch version on the card: identical labels on
   a 1148^2 canvas of synthetic nuclei mirrored about a 1000^2 source
   (with its valid mask), a noisy map, an empty map and a 164^2 map;
   median times of both at 1148^2, and K1's own split there (CUDA
   events at its stage boundaries, the sweeps of each watershed phase;
   each kernel's device time under torch.profiler);
4. the tile path as a user runs it: TileInferManager, fast mode, width
   64, bf16 body, seeded random weights loaded from a `.tar`, three
   1000^2 images written as json, then one typed image (nr_types=5);
   K1 must have run once per image, K3 (the default encoder) 4 times
   per forward batch, and the json must come from the
   device tables through the native contour tracer; prints the per-tile
   split of device and host time. From this phase on, every inference
   manager the run builds (those inside the CLIs too), each replica its
   `model_on` makes (one on the host here: every slot of a one-card run
   shares the loaded model) and each model K3's packs are folded from
   must hold every BatchNorm's weight, bias and running statistics in
   float32 under the bf16 body, as flax keeps them (checked as each
   appears; the counts are printed after phase 16);
5. the width-64 bf16 forward agrees with its float32 version on one
   patch; finalize on real nuclei: the 1148^2 synthetic map through the
   kernel, the tables and the host finalize gives the instances of the
   plain path, exactly;
6. K3, the fused-block encoder, against its plain PyTorch version at the
   width-64 shapes of its four block calls (d0, d1, d2a, d2b) on a batch
   of 32 patches: error within 3% of the output scale, median times of
   the kernel (with TFLOP/s, share of the bound and the design's own
   bytes per call; each launch's device time under torch.profiler, with
   its TFLOP/s and share of its byte floor) and of the plain version,
   and of the standard cuDNN
   modules twice: the default path and channels-last with
   cudnn.benchmark (the faster is the library time); two tile sizes and
   the 3 + 3 split of d2 give bit-identical output;
   the fused forward agrees with the float32 standard forward on one
   patch within 15%;
7. the WSI path as a user runs it: WSIInferManager (d0..d2 as K3, the
   default on a card), width 64, bf16, seeded random weights from a
   `.tar`, a 4096^2 `.npy` pseudo-slide of synthetic nuclei with a
   `.png` mask, chunks of 2048
   (several, so the prefetch runs), 2048^2 post-proc tiles; the json is
   written and a second call skips it; K3 ran 4 times per forward batch
   and K1 once per post-proc window batch; prints the inference and
   per-phase post-proc seconds;
8. real nuclei through the WSI post-processing: a 4096^2 synthetic
   prediction map of 1500 discs through the 3 phases from the device
   buffer, from an mmap, and with K1's plain version in K1's place:
   identical instances all three ways; K1 gives the plain labels on
   every [4, 2048, 2048]-class window batch and on the whole map;
   median times of both at the 2048^2 batch and K1's two splits there;
   against the single-shot K1
   solve of the whole map, counts within 1% and AJI > 0.95;
9. K2, the standalone watershed, against its plain version, element for
   element, in all three sweep orders: the 128^2 watershed test maps
   (seeds 0 and 1, a batch of 3) and the 1148^2 probe canvas (energy,
   markers and mask from the tail's stages before the watershed, where
   K2 must also give K1's labels); median times and K2's split at
   1148^2; the blocked
   entry at 800x700 with 160 nuclei (the op API as a user calls it):
   identical to the same entry's plain version on its [9, 512, 512]
   window batch, and against the whole-map K2 an equal instance count
   and AJI > 0.999;
10. K4, the tail's stage-ablation variants: each of the six against its
   plain version at 1148^2 (identical labels; skip="none" equals K1) with
   median times of both; then the stage probe as a user runs it
   (cli/probe_pp_stages --size 1000), which prints the per-stage split;
11. training as a user runs it: a synthetic CoNSeP-style dataset (three
   1000^2 training images and one validation image of 1200 nuclei, 7 raw
   types), 540^2 patches at a 164 step from cli/extract_patches, then
   cli/run_train with the two default phases for one epoch each at
   width 64 (frozen encoder at batch 16, then everything at batch 4;
   float32, cuDNN's default TF32). Every step's loss is finite; after
   phase 1 the frozen parameters (d0's unit towers, d1..d3) are
   bit-identical to their seeded start while every other parameter and
   d1..d3's BN statistics moved; after phase 2 every parameter moved;
   both `net_epoch=1.tar` and stats.json (valid-np_dice) are written; the
   tile manager loads phase 2's `.tar` and writes one 1000^2 image's
   json; one width-8 phase-2 step on the card agrees with the CPU's:
   with the model body in float64 every loss term and grad_norm within
   1e-5 relative; in float32 with TF32 on, as the trainer runs, the loss
   terms within 2e-2 (40x TF32's unit roundoff 2^-11), grad_norm printed
   (a random net's float32 gradient is chaotic). Prints each phase's ms
   per step, its per-step rate and loader wait share, patches/s over the
   phase's whole run, the peak device memory and the TF32 setting, and
   the phase's own seconds by part;
12. evaluation as a user runs it: the typed checkpoint of
   cli/recipe.train_e2e_checkpoint(nr_types=5) (400 seeded steps at batch
   8 on deterministic algorithms, the same every run; its sha256
   printed) through
   cli/run_infer on four held-out 1000^2 CoNSeP-style images (fast,
   width 64, bf16, --save_format all) three times: (a) the device path
   with --profile_dir, (b) --host_post_proc, (c) the standard cuDNN
   encoder (`steps.standard_encoder()`). K1 ran once per image in (a) and
   (c) and never in (b), K3 4 times per forward batch in (a) and (b)
   (the default) and never in (c); the trace names K1's kernels; every json and
   mat is written; per image AJI((b), (a)) >= 0.93, the JAX package's
   floor for its device path against the host oracle;
   cli/convert_format writes one tsv row per nucleus. Prints
   cli/compute_stats of each run against the truth (types merged as
   CoNSeP's loader merges them), the drift of (a) against (b) and of (a)
   (K3) against (c) (cuDNN) per image with mean and min (beside the JAX
   package's TPU record) and of (c) and (a) against (d), the standard
   forward in float32 (TF32 off: the bf16 noise floor of the
   checkpoint), each of
   the last three beside its record from before the bf16 body kept its
   BatchNorms in float32, the host
   post-processing seconds per image, the trained model's summary
   totals and the phase's own seconds by part;
13. multi-device inference on one card: the mesh of infer/wsi.py and the
   tile round-robin with every slot on cuda:0, each against the
   single-device path, bit for bit: (a) phase 8's 4096^2 prediction map
   of 1500 discs through the 3 phases (1024^2 tiles) from a 4-slot
   striped buffer and from the single-device buffer: identical instance
   maps and instance ids, K1 launched once per window-batch shard (as
   often as the single-device run's batches, in fewer batches); (b)
   phase 7's pseudo-slide through `WSIInferManager(devices=["cuda:0"] *
   2)` and the single-device manager, once with the standard cuDNN
   encoder (`steps.standard_encoder()`) and once with the default (K3):
   the identical stitched prediction, json nuclei and instance map, the
   same forward batches, K1 once per shard, K3 4 times per forward shard
   with the default encoder; (c) phase 4's three
   untyped 1000^2 images through `TileInferManager(devices=["cuda:0"] *
   2)` (a dispatch thread a slot) and the single-device manager: the
   json of phase 4, K1 once per image. Each part runs single, striped
   (2 or 4 slots), striped, single, and prints each run's seconds (the
   striping overhead on one card);
14. multi-device training on one card, one process a rank
   (parallel/distributed.py), every rank on cuda:0, the three spawns
   below started at once (a rank's start is mostly host work): (a)
   `entry.dryrun_multichip(1)`, a one-rank NCCL group, then the striped
   inference dryrun; (b) the step of `dryrun_train_step(2, devices=
   ["cuda:0"] * 2)`, gloo with CUDA tensors: a finite loss and
   bit-identical ranks; (c), in (b)'s spawn of the ranks
   (`dp_check.dryrun_and_rank_steps`), the
   exactness check (parallel/dp_check.py): width 64, 256^2 -> 164^2, the
   model's body, heads and loss in float64 (cuDNN's double convolutions),
   2 ranks on a global batch of 4 for 3 steps in both freeze modes
   against the one-process steps on the same global batches, at the
   tolerances of tests/test_torch_train_step.py (loss terms 1e-5,
   grad_norm 1e-4 relative at every step; step 1's gradients 1e-4 of
   their scale; parameters 0.1 * lr and BN stats 1e-5 of their scale
   after step 3; frozen parameters bit-identical), the ranks
   bit-identical after step 3; (d) `TrainManager(devices=["cuda:0"] * 2)` on
   32 of phase 11's training patches and 8 of its validation patches,
   both default phases at per-rank batches of 8 and 2 (phase 11's
   global 16 and 4), each for the epochs that give it 8 steps (4 and 1):
   finite losses, the freeze cut, one `.tar` an epoch from rank 0, the
   ranks checked identical by the trainer after each phase, and the last
   `.tar` through the tile manager. Prints each phase's ms per step and
   patches/s beside the card line: two ranks sharing one card, not a
   scaling number; each spawn of ranks logs every rank's timeline (up,
   device bound, group joined, first step, returned, exited);
15. the probes and correctness sweeps at full width (w64, bf16), each
   through its main(argv), each printing its JSON line: the untyped
   recipe checkpoint (trained in a process of its own from the start of
   phase 11 to the end of phase 12, its sha256 printed beside the
   recorded one, as phase 12's typed one is),
   cli/bench_train at batch 16 and 4 (float32 parameters, bf16 body),
   cli/probe_device_time --split forward (stages, prefix cuts, kernel
   time by layer group with cuDNN and with K3),
   cli/fused_encoder_drift --n 4 (one forward batch a tile, K3 4 times
   in each fused one; its three AJI pairs beside their record) and
   cli/parity_drift_sweep --n 4 (AJI of the device path against the
   host oracle >= 0.93);
16. original mode (270^2 -> 80^2 patches, the JAX package's default
   training configuration) at full width, typed (nr_types=5): (a) K1
   against its plain version on 1000^2 synthetic nuclei mirrored over the
   exact 13 x 13 grid's 1040^2 map and over the 1120^2 map of the 14 x 14
   canonical grid the tile path runs, identical labels, median times of
   both; (b) cli/run_train at TrainConfig's defaults (original mode, the
   two default phases, one epoch each) on phase 11's 540^2 patches, with
   phase 11's checks (finite losses, the freeze cut, each phase's `.tar`
   and stats.json) and one original-mode width-8 step on the card against
   the CPU with the body in float64 (1e-5 relative); (c) cli/eval_consep,
   the CoNSeP recipe, on two of phase 12's held-out images in the CoNSeP
   layout with (b)'s `.tar`: K1 once per image and identical to its plain version
   on each image's stitched map, every json and mat written, both
   compute_stats lines printed; then the warm json pipeline's tiles/s and
   per-tile device split; (d) WSIInferManager in original mode on a
   2048^2 pseudo-slide: K1 once per window batch, the json written, a
   second call skips the slide; prints the phase's seconds by part;
17. the JAX package's checkpoint format, read and written without flax
   (models/msgpack_io.py): (a) prints which of jax, flax, optax and
   msgpack are installed here and fails if one was imported; (b) phase
   12's typed recipe `.tar` written as the JAX package's `.msgpack`, then
   cli/run_infer tile on phase 12's held-out images from the `.tar` and
   from the `.msgpack`: identical json and instance maps, K1 once per
   image from the `.msgpack`; (c) phase 11's second-phase `.tar` written
   as the JAX trainer's `net_epoch=1.msgpack` and `.opt` (weights, Adam
   moments, step) in a phase directory of its own, and cli/run_train
   --resume from it and from the `.tar` for two one-step epochs on four
   of phase 11's patches, under deterministic algorithms: finite losses,
   the step going on from the `.msgpack`'s, the port's `.tar` written
   after each epoch, and the first resumed update from the `.msgpack`
   within one float32 ulp of the one from the `.tar`; (d) phase 12's
   recipe `.tar` through cli/convert_chkpt to the JAX package's
   `.msgpack`: `load_model_state` of it equals the `.tar`'s on every
   tensor, and its variables written back by `save_torch_tar` (keys
   prefixed 'module.') reload equal to the original;
18. prints the kernel table as one JSON line (K1's times at the WSI
   window batch; each kernel's bound from its inputs and outputs at the
   timed shape; the launches of K1 and K3 are phase 7's, phase 13's,
   phase 15's and, for K1, phase 16's and phase 17's), the card line,
   the seconds of each phase as one JSON line ({"phase_seconds": {"1":
   s, ..., "17": s}, "parts": {...}, "total_s": s}; "2" is K1's build),
   and last {"ok": true, "device": {...}}.

Outputs go to build/chip_smoke/ in the checkout. On its way out, whether
it passed or failed, the script stops every process it started (the
training loader's forkserver and multiprocessing's resource tracker
included) and waits for each to end.
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
SLIDE = 4096       # side of the WSI pseudo-slide
SLIDE_NUCLEI = 1500
K3_BATCH = 32      # patches per forward batch of the WSI path
# published peaks of one H100 SXM (NVIDIA data sheet): HBM bytes/s and
# dense bf16 tensor-core FLOP/s, for each kernel's bound
HBM_BYTES_PER_S = 3.35e12
BF16_FLOPS = 989e12


def log(msg):
    print(msg, flush=True)


def use_bytecode_cache():
    """Python's bytecode cache, under build/pycache, for this run and for
    every process it starts. Where the interpreter is told to write none
    (PYTHONDONTWRITEBYTECODE) and site-packages holds none, as on the
    card's machine, every process compiles torch's modules anew: 6-9 s
    of each rank's start there, against ~4 s from the cache (PERF.md
    §6). This process compiles and writes them once; its children read
    them."""
    prefix = os.path.join(ROOT, "build", "pycache")
    sys.dont_write_bytecode = False
    sys.pycache_prefix = prefix
    os.environ.pop("PYTHONDONTWRITEBYTECODE", None)
    os.environ["PYTHONPYCACHEPREFIX"] = prefix


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


def mirrored_canvas(pred, canvas=CANVAS):
    """Reflect-101 a SRC_HW^2 map over the canvas^2 canvas, + valid mask."""
    rr = np.arange(canvas)
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


# ------------------------------------------------- BatchNorm in float32

# every bf16-body model the run builds whose BatchNorms were checked:
# the managers' loaded models, the replicas `model_on` makes, and the
# models K3's packs are folded from (ids, so a model counts once)
BN_CHECKED = {"manager": set(), "replica": set(), "fused": set()}


def check_bn_float32(model, what):
    """Under a bf16 body every BatchNorm of `model` holds float32 weight,
    bias and running statistics, as flax keeps them; raises otherwise.
    Returns whether the model has a bf16 body."""
    import torch

    from hover_net_tpu_torch.models.blocks import BatchNorm2d

    if model.cfg.dtype != torch.bfloat16:
        return False
    bad = [name for name, m in model.named_modules()
           if isinstance(m, BatchNorm2d) and any(
               t.dtype != torch.float32 for t in (
                   m.weight, m.bias, m.running_mean, m.running_var))]
    if bad:
        raise AssertionError(f"{what}: BatchNorm tensors not float32 in "
                             f"{len(bad)} modules, e.g. {bad[:3]}")
    return True


def guard_bn_float32():
    """From here on, every inference manager the run builds (the CLIs'
    and the measurement entry points' inside them included), every
    replica its `model_on` makes and every model K3's pack is folded from
    go through check_bn_float32 as they appear."""
    from hover_net_tpu_torch.infer.base import InferManagerBase
    from hover_net_tpu_torch.models import encoder_fused

    init, model_on = InferManagerBase.__init__, InferManagerBase.model_on
    pack = encoder_fused.pack_encoder

    def checked(kind, model):
        if check_bn_float32(model, kind):
            BN_CHECKED[kind].add(id(model))
        return model

    def checked_init(self, *args, **kwargs):
        init(self, *args, **kwargs)
        checked("manager", self.model)

    def checked_model_on(self, device):
        return checked("replica" if device != self.device else "manager",
                       model_on(self, device))

    def checked_pack(model):
        checked("fused", model)
        return pack(model)

    InferManagerBase.__init__ = checked_init
    InferManagerBase.model_on = checked_model_on
    encoder_fused.pack_encoder = checked_pack


def log_bn_checked(where):
    log(f"BatchNorm in float32 under the bf16 body, {where}: "
        + ", ".join(f"{len(v)} {k} models" for k, v in BN_CHECKED.items()))


# ------------------------------------------------------------- phases

def card_line():
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]


def tensor_bytes(*tensors):
    return sum(t.numel() * t.element_size() for t in tensors)


def bound(nbytes, flops=0.0):
    """(ms, "bytes" | "operations"): the least time the card could take,
    each input read once and each output written once. K1, K2 and K4 do
    a few integer operations per pixel and sweep (no tensor-core work),
    so they pass no FLOPs and are bound by bytes."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / BF16_FLOPS * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


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


def launch_us(fn, kernel, n_launches, reps, tries=20):
    """(median device µs of each launch of `kernel` that `fn` makes over
    `reps` runs under torch.profiler, runs the profiler did not see
    whole). The first profiled run is a warm-up and is discarded. The
    profiler can miss a launch now and then, so a run that does not show
    all `n_launches` is run again, up to `tries` runs in all; the times
    are None when fewer than `reps` runs were whole. The split is only
    printed: each kernel's time comes from CUDA events (median_ms)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    runs, missed = [], []
    for k in range(tries + 1):
        if len(runs) == reps:
            break
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        times = [e.device_time for e in prof.events()
                 if e.device_type == torch.autograd.DeviceType.CUDA
                 and kernel in e.name]
        if k == 0:
            continue
        if len(times) == n_launches:
            runs.append(times)
        else:
            missed.append(len(times))
    if len(runs) < reps:
        return None, missed
    return ([statistics.median(r[i] for r in runs)
             for i in range(n_launches)], missed)


def log_split(what, call, reps=10):
    """Print the kernel's own split of `call(stats)` (ops/post_proc_cuda
    STAGES: CUDA events at the stage boundaries inside the call): the
    median of each stage over `reps` calls after a warm-up, and the
    sweep counts of the two watershed phases seen in those calls. Fails
    unless both phases swept at least once."""
    from hover_net_tpu_torch.ops.post_proc_cuda import STAGES

    runs = []
    for _ in range(reps + 1):
        stats = {}
        call(stats)
        runs.append(stats)
    runs = runs[1:]
    ms = {k: statistics.median(r["stage_ms"][k] for r in runs)
          for k in STAGES}
    sweeps = sorted({(r["sweeps"]["ws_phase1"], r["sweeps"]["ws_phase2"])
                     for r in runs})
    log(f"{what} split (ms, median of {reps}, CUDA events inside the call): "
        + ", ".join(f"{k} {v:.3f}" for k, v in ms.items())
        + f"; sum {sum(ms.values()):.3f}; sweeps (phase 1, phase 2) "
        + ", ".join(f"{a} + {b}" for a, b in sweeps))
    if any(min(sw) < 1 for sw in sweeps):
        raise AssertionError(f"{what}: a watershed phase ran no sweep")


def kernel_split(what, call, reps=3):
    """Print each kernel's device time in one `call()` under
    torch.profiler (the median over `reps` profiled calls after a
    warm-up, all launches of one name summed) and its launches; the
    split is only printed."""
    import re

    import torch
    from torch.profiler import ProfilerActivity, profile

    call()
    runs = []
    for _ in range(reps):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            call()
            torch.cuda.synchronize()
        run = {}
        for e in prof.events():
            if e.device_type != torch.autograd.DeviceType.CUDA:
                continue
            name = re.sub(r"\(anonymous namespace\)::", "", e.name)
            name = name.split("(")[0].split("::")[-1] or e.name
            us, n = run.get(name, (0.0, 0))
            run[name] = (us + e.device_time, n + 1)
        runs.append(run)
    names = {k for r in runs for k in r}
    split = sorted(((statistics.median(r.get(k, (0.0, 0))[0] for r in runs),
                     k, max(r.get(k, (0.0, 0))[1] for r in runs))
                    for k in names), reverse=True)
    log(f"{what} per kernel (us of device time in one call, median of "
        f"{reps}, torch.profiler): " + ", ".join(
            f"{k} {us:.1f} ({n}x)" for us, k, n in split))


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
    log_split(f"K1 at {CANVAS}^2", lambda st: k1.proc_tail(blb, sob, stats=st))
    kernel_split(f"K1 at {CANVAS}^2", lambda: k1.proc_tail(blb, sob))
    return {"ms": ms, "plain_ms": plain_ms, "max_abs_err": max_err,
            "canvas": inputs["canvas_1148"]}


def write_tar(path, nr_types, seed):
    import torch

    from hover_net_tpu_torch.models.hovernet import HoVerNet, HoVerNetConfig

    net = HoVerNet(HoVerNetConfig(mode="fast", nr_types=nr_types, width=64),
                   generator=torch.Generator().manual_seed(seed))
    torch.save({"desc": net.state_dict()}, path)


def run_slice(work):
    """Phase 4: the tile path at full width, as a user calls it: K1 once
    per image, K3 (the default encoder) 4 times per forward batch.
    Returns the launches of K1 and K3, and the untyped manager."""
    import cv2

    from hover_net_tpu_torch.cli.fused_encoder_drift import (
        count_forward_batches,
    )
    from hover_net_tpu_torch.infer.tile import TileInferManager
    from hover_net_tpu_torch.ops.fused_block_cuda import fused_block_apply
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

    batches = [count_forward_batches(mgr) for mgr in mgrs.values()]
    proc_tail.launches = fused_block_apply.launches = 0
    t0 = time.perf_counter()
    for name, _, n_img in runs:
        out = os.path.join(work, f"out_{name}")
        written = mgrs[name].process_file_list(dirs[name], out,
                                               save_format="json")
        if written != n_img:
            raise AssertionError(f"{name}: {written}/{n_img} images written")
    wall = time.perf_counter() - t0
    launches, k3 = proc_tail.launches, fused_block_apply.launches
    n_fwd = sum(n[0] for n in batches)

    n_images = sum(n for _, _, n in runs)
    log(f"slice: {n_images} images in {wall:.3f} s wall, K1 launches "
        f"{launches}, K3 launches {k3} in {n_fwd} forward batches")
    if launches != n_images:
        raise AssertionError(f"K1 ran {launches} times for {n_images} images")
    if k3 != 4 * n_fwd or n_fwd == 0:
        raise AssertionError(f"K3 ran {k3} times for {n_fwd} forward batches")
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
    return launches, k3, mgrs["untyped"]


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


def cuobjdump_path():
    """The toolkit's cuobjdump, or the copy Triton's package carries."""
    found = shutil.which("cuobjdump")
    cands = [found] if found else []
    cands.append(os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "cuobjdump"))
    try:
        import triton
        cands.append(os.path.join(os.path.dirname(triton.__file__), "backends",
                                  "nvidia", "bin", "cuobjdump"))
    except ImportError:
        pass
    for c in cands:
        if os.path.exists(c):
            return c
    raise RuntimeError("no cuobjdump: cannot read K3's SASS")


def build_kernels():
    """Phase 2: post_proc_tail.cu (K1, K2, K4) and fused_block.cu (K3)
    from csrc/, one nvcc each, started together. Waits for K1's library
    and returns `finish_k3`, which waits for K3's (its nvcc goes on
    beside phase 3, which needs K1 alone; phase 4's tile path, whose
    encoder is K3, waits for the build) and checks K3's registers
    from ptxas and its wgmma (HGMMA) and TMA load (UTMALDG)
    instructions; phase 6 calls it."""
    from concurrent.futures import ThreadPoolExecutor

    from hover_net_tpu_torch.ops import fused_block_cuda, post_proc_cuda

    def timed(build):
        t0 = time.perf_counter()
        lib = build()
        return time.perf_counter() - t0, lib._name

    pool = ThreadPoolExecutor(max_workers=2)
    futs = {name: pool.submit(timed, mod.build) for name, mod in (
        ("K1/K2/K4", post_proc_cuda), ("K3", fused_block_cuda))}

    def built(name):
        secs, lib = futs[name].result()
        log(f"build: {name} built by nvcc and loaded in {secs:.3f} s "
            f"({os.path.relpath(lib, ROOT)})")
        return lib

    def finish_k3():
        try:
            k3_lib = built("K3")
        finally:
            pool.shutdown()
        with open(os.path.splitext(k3_lib)[0] + ".log") as f:
            for line in f:
                if "Used" in line or "spill" in line:
                    log(f"build: K3 ptxas: {line.strip()}")
        sass = subprocess.run([cuobjdump_path(), "-sass", k3_lib],
                              capture_output=True, text=True,
                              check=True).stdout
        counts = {op: sum(op in line for line in sass.splitlines())
                  for op in ("HGMMA", "UTMALDG")}
        log(f"build: K3 SASS: {counts['HGMMA']} HGMMA, {counts['UTMALDG']} "
            f"UTMALDG instructions")
        if not counts["HGMMA"] or not counts["UTMALDG"]:
            raise AssertionError("K3's SASS has no wgmma or no TMA load")

    built("K1/K2/K4")
    return finish_k3


def make_wsi_inputs(work):
    """A 4096^2 `.npy` pseudo-slide of synthetic nuclei, its `.png` tissue
    mask, and a width-64 untyped `.tar` of seeded random weights."""
    import cv2

    dirs = {k: os.path.join(work, k) for k in ("slides", "masks", "wsi_out")}
    for d in dirs.values():
        os.makedirs(d)
    inst = synth_inst(SLIDE, SLIDE, SLIDE_NUCLEI, seed=7)
    img = np.full((SLIDE, SLIDE, 3), (230, 200, 220), np.uint8)
    img[inst > 0] = (120, 60, 150)
    noise = np.random.default_rng(7).integers(0, 20, img.shape, np.uint8)
    np.save(os.path.join(dirs["slides"], "slide.npy"), img - noise)
    cv2.imwrite(os.path.join(dirs["masks"], "slide.png"),
                np.full((SLIDE // 16, SLIDE // 16), 255, np.uint8))
    tar = os.path.join(work, "wsi.tar")
    write_tar(tar, None, seed=1)
    return tar, dirs


def check_k3(model):
    """Phase 6: K3 against its plain version at the four block calls of
    the width-64 encoder on a batch of 32 patches (each call fed the
    kernel's previous output), with per-call TFLOP/s, share of the bound
    and the design's own bytes, and the per-launch split; the cuDNN
    modules twice (the default
    path, and channels-last with cudnn.benchmark); tile and split
    invariance."""
    import copy

    import torch

    from hover_net_tpu_torch.models.encoder_fused import (
        CALLS,
        pack_block,
        pack_encoder,
    )
    from hover_net_tpu_torch.ops.fused_block_cuda import (
        fused_block_apply,
        fused_block_reference,
        launch_plan,
    )

    dev = next(model.parameters()).device
    pk = pack_encoder(model)
    tiles = [synth_image(50 + i)[y:y + 256, x:x + 256] for i in range(4)
             for y in (0, 372, 744) for x in (0, 372, 744)][:K3_BATCH]
    imgs = torch.from_numpy(np.stack(tiles)).to(dev)
    with torch.no_grad():
        x = model.conv0(imgs.permute(0, 3, 1, 2).to(torch.bfloat16) / 255.0)
    x = x.permute(0, 2, 3, 1).contiguous()
    inputs, ms, plain_ms, max_err = {}, 0.0, 0.0, 0.0
    nbytes, flops, design = 0, 0, 0
    for name, _, _, kw in CALLS:
        packed, units = pk[name]
        inputs[name] = x
        got = fused_block_apply(x, packed, units=units, **kw)
        want = fused_block_reference(x, packed, **kw)
        torch.cuda.synchronize()
        # each launch's FLOPs, and the bytes the design itself moves:
        # every launch's own inputs, weights, residual and output (conv1
        # and conv2 outputs round-trip through device memory)
        plan = launch_plan(x.shape, units[0]["w1t"].shape[0],
                           units[0]["w3t"].shape[0], **kw)
        c_bytes = tensor_bytes(x, got, *packed.values())
        c_flops = sum(f for _, f, _ in plan)
        c_design = sum(b for _, _, b in plan)
        nbytes, flops, design = (nbytes + c_bytes, flops + c_flops,
                                 design + c_design)
        diff = (got.float() - want.float()).abs()
        err = diff.max().item()
        scale = want.float().abs().max().item()
        share = (diff > 0).float().mean().item()
        t_k = median_ms(lambda: fused_block_apply(x, packed, units=units,
                                                  **kw), 10)
        t_p = median_ms(lambda: fused_block_reference(x, packed, **kw), 3)
        b_ms, b_by = bound(c_bytes, c_flops)
        log(f"K3 vs plain {name} {tuple(x.shape)} -> {tuple(got.shape)}: "
            f"max |delta| {err:.6g} = {err / scale:.5f} of the output scale "
            f"{scale:.6g}, {share:.4f} of elements differ; kernel "
            f"{t_k:.3f} ms, plain {t_p:.3f} ms (median, CUDA events); "
            f"{c_flops / t_k / 1e9:.1f} TFLOP/s, {100 * b_ms / t_k:.1f} % of "
            f"its bound {b_ms:.3f} ms ({b_by}); the design moves "
            f"{c_design / 1e9:.3f} GB = {c_design / HBM_BYTES_PER_S * 1e3:.3f}"
            f" ms at {HBM_BYTES_PER_S / 1e12} TB/s")
        if not torch.isfinite(got.float()).all() or err > 0.03 * scale:
            raise AssertionError(f"K3 disagrees with its plain version on "
                                 f"{name}")
        us, missed = launch_us(lambda: fused_block_apply(
            x, packed, units=units, **kw), "conv_gemm", len(plan), 5)
        if missed:
            log(f"  K3 {name}: the profiler saw {missed} conv_gemm launches "
                f"in {len(missed)} runs, not {len(plan)}; those runs were "
                f"dropped from the split")
        if us is None:
            log(f"  K3 {name} per launch: not measured (too few whole "
                f"profiled runs)")
            us = []
        else:
            log(f"  K3 {name} per launch (median of 5, torch.profiler): "
                f"{sum(us) / 1e3:.3f} ms in {len(us)} launches")
        for (what, l_flops, l_bytes), t in zip(plan, us):
            floor = l_bytes / HBM_BYTES_PER_S * 1e6
            log(f"    {what:18s} {t:9.1f} us {l_flops / t / 1e6:7.1f} TFLOP/s"
                f" {l_bytes / 1e9:6.3f} GB = {floor:7.1f} us at "
                f"{HBM_BYTES_PER_S / 1e12} TB/s ({100 * floor / t:5.1f} %)")
        ms, plain_ms, max_err = ms + t_k, plain_ms + t_p, max(max_err, err)
        x = got
    k3_bound = bound(nbytes, flops)
    log(f"K3 encoder d0..d2 at batch {K3_BATCH}: kernel {ms:.3f} ms, plain "
        f"{plain_ms:.3f} ms; {flops / 1e12:.4f} TFLOP, {nbytes / 1e6:.3f} MB; "
        f"{flops / ms / 1e9:.1f} TFLOP/s, {100 * k3_bound[0] / ms:.1f} % of "
        f"the bound {k3_bound[0]:.3f} ms ({k3_bound[1]}); the design moves "
        f"{design / 1e9:.3f} GB = {design / HBM_BYTES_PER_S * 1e3:.3f} ms")

    # the library yardstick, never called by the port: the standard cuDNN
    # modules on the same inputs, (a) the default path (NHWC memory
    # viewed as NCHW, weights as loaded, cudnn.benchmark off) and (b)
    # channels-last weights and input with cudnn.benchmark on
    blocks = (("d0", model.d0, "d0"), ("d1", model.d1, "d1"),
              ("d2", model.d2, "d2a"))
    lib_ms = {"default": 0.0, "channels_last": 0.0}
    prev = torch.backends.cudnn.benchmark
    with torch.no_grad():
        for name, block, src in blocks:
            xin = inputs[src].permute(0, 3, 1, 2)
            t_c = median_ms(lambda: block(xin), 10)
            lib_ms["default"] += t_c
            log(f"cuDNN standard module {name} at batch {K3_BATCH} "
                f"(default): {t_c:.3f} ms (median, CUDA events)")
        torch.backends.cudnn.benchmark = True
        try:
            for name, block, src in blocks:
                cl = copy.deepcopy(block).to(memory_format=torch.channels_last)
                xin = inputs[src].permute(0, 3, 1, 2).contiguous(
                    memory_format=torch.channels_last)
                t_c = median_ms(lambda: cl(xin), 10)
                lib_ms["channels_last"] += t_c
                log(f"cuDNN standard module {name} at batch {K3_BATCH} "
                    f"(channels-last, cudnn.benchmark): {t_c:.3f} ms (median,"
                    f" CUDA events)")
                del cl
        finally:
            torch.backends.cudnn.benchmark = prev
    library_ms = min(lib_ms.values())
    log(f"cuDNN d0+d1+d2 at batch {K3_BATCH}: default "
        f"{lib_ms['default']:.3f} ms, channels-last + benchmark "
        f"{lib_ms['channels_last']:.3f} ms; K3 {ms:.3f} ms is "
        f"{library_ms / ms:.2f}x the faster one's speed")

    kws = {name: kw for name, _, _, kw in CALLS}

    def call(name, x, **extra):
        packed, units = pk[name]
        return fused_block_apply(x, packed, units=units, **kws[name], **extra)

    x0, x1 = inputs["d0"][:4].contiguous(), inputs["d1"][:4].contiguous()
    same = (torch.equal(call("d0", x0), call("d0", x0, th=2))
            and torch.equal(call("d1", x1), call("d1", x1, th=32)))
    x2 = inputs["d2a"][:4].contiguous()
    whole = fused_block_apply(x2, pack_block(model.d2, 6), count=6, stride=2)
    chain = call("d2b", call("d2a", x2))
    split = torch.equal(whole, chain)
    log(f"K3 tile sizes (auto 8x16 vs 2x64 at d0, auto vs 32x4 at d1) "
        f"bit-identical: {same}; d2 as 3 + 3 units == 6 units bit for bit: "
        f"{split}")
    if not (same and split):
        raise AssertionError("K3 output depends on the tiling or the split")
    return {"ms": ms, "plain_ms": plain_ms, "max_abs_err": max_err,
            "bound": k3_bound, "library_ms": library_ms}


def check_fused_forward(model):
    """The fused forward (K3) against the float32 standard forward (TF32
    off) on one 256^2 patch, within the 15% bound of check_forward."""
    import torch

    from hover_net_tpu_torch.models.encoder_fused import fused_forward
    from hover_net_tpu_torch.models.hovernet import HoVerNet, HoVerNetConfig

    dev = next(model.parameters()).device
    ref = HoVerNet(HoVerNetConfig(mode="fast", nr_types=None,
                                  width=64)).to(dev).eval()
    ref.load_state_dict(model.state_dict())
    x = torch.from_numpy(synth_image(98)[:256, :256]).to(dev)[None]
    with torch.no_grad(), torch.backends.cudnn.flags(enabled=True,
                                                     allow_tf32=False):
        want = ref(x.permute(0, 3, 1, 2))
        got = fused_forward(model, x)
    for name, w in want.items():
        g = got[name]
        rel = float((g - w).abs().max() / w.abs().max())
        log(f"fused forward (K3) vs f32 standard {name} {tuple(g.shape)}: "
            f"relative max |delta| {rel:.4f}")
        if g.shape != (1, 2, 164, 164) or not torch.isfinite(g).all() \
                or rel > 0.15:
            raise AssertionError(f"fused forward head {name} is off")


def run_wsi(mgr, dirs):
    """Phase 7: `process_wsi_list` on the pseudo-slide (K3 by default)."""
    from hover_net_tpu_torch.ops.fused_block_cuda import fused_block_apply
    from hover_net_tpu_torch.ops.post_proc_cuda import proc_tail

    out = os.path.join(dirs["wsi_out"], "slide.json")
    fused_block_apply.launches = 0
    proc_tail.launches = 0
    t0 = time.perf_counter()
    written = mgr.process_wsi_list(dirs["slides"], dirs["wsi_out"],
                                   input_mask_dir=dirs["masks"])
    wall = time.perf_counter() - t0
    k3, k1 = fused_block_apply.launches, proc_tail.launches
    if written != 1 or not os.path.exists(out):
        raise AssertionError("the WSI run wrote no json")
    with open(out) as f:
        payload = json.load(f)
    log(f"wsi: {SLIDE}^2 slide in {wall:.3f} s wall: {mgr.n_forward_batches} "
        f"forward batches of <= {mgr.batch_size} patches, "
        f"{mgr.n_window_batches} post-proc window batches, "
        f"{len(payload['nuc'])} nuclei; K3 launches {k3}, K1 launches {k1}")
    log("wsi seconds: " + ", ".join(
        f"{k} {v:.3f}" for k, v in mgr.timings["slide"].items()))
    if k3 != 4 * mgr.n_forward_batches or mgr.n_forward_batches == 0:
        raise AssertionError(f"K3 ran {k3} times for "
                             f"{mgr.n_forward_batches} forward batches")
    if k1 != mgr.n_window_batches or k1 == 0:
        raise AssertionError(f"K1 ran {k1} times for "
                             f"{mgr.n_window_batches} window batches")
    mtime = os.path.getmtime(out)
    if mgr.process_wsi_list(dirs["slides"], dirs["wsi_out"]) != 0 \
            or os.path.getmtime(out) != mtime:
        raise AssertionError("the second WSI call did not skip the slide")
    log("wsi resume: the second call skipped the written slide")
    return k3, k1


def aji_of(true, pred):
    """Aggregated Jaccard index of two label maps with ids of any range
    (metrics.stats.get_fast_aji wants contiguous ids: remap first)."""
    from hover_net_tpu_torch.metrics.stats import get_fast_aji, remap_label

    return get_fast_aji(remap_label(true), remap_label(pred))


def wsi_real_nuclei(mgr, work):
    """Phase 8: a 4096^2 synthetic prediction map through the 3 phases
    three times: K1 from the device buffer, K1 from an mmap, and K1's
    plain version in its place (each window batch also runs K1, which
    must give the same labels). The three instance maps must be
    identical. Returns K1's max |label difference| and its times against
    plain at the [4, 2048, 2048] window batches."""
    import torch

    from hover_net_tpu_torch.infer.wsi import scatter_patches
    from hover_net_tpu_torch.ops.post_proc_cuda import (
        proc_tail,
        proc_tail_reference,
    )
    from hover_net_tpu_torch.ops.post_proc_device import (
        compact_labels_u16,
        energy_inputs,
    )

    pred = synth_pred(synth_inst(SLIDE, SLIDE, SLIDE_NUCLEI, seed=8)
                      ).astype(np.float16)
    out_sz = mgr.cfg.patch_output_shape
    grid = np.arange(0, SLIDE, out_sz)
    padded = np.zeros((grid[-1] + out_sz,) * 2 + (3,), np.float16)
    padded[:SLIDE, :SLIDE] = pred
    coords = np.array([(y, x) for y in grid for x in grid], np.int32)
    batches = []  # (blb, sob) of the first window batch of the plain run
    max_err = 0

    def plain_post_proc(seg, valid):
        nonlocal max_err
        blb, sob = energy_inputs(seg, valid)
        want = proc_tail_reference(blb, sob)
        got = proc_tail(blb, sob)
        n_diff = int((got != want).sum())
        max_err = max(max_err, int((got.long() - want.long()).abs().max()))
        log(f"K1 vs plain on WSI window batch {tuple(blb.shape)}: "
            f"{n_diff} labels differ")
        if n_diff:
            raise AssertionError("K1 disagrees with its plain version on a "
                                 "WSI window batch")
        if not batches:
            batches.append((blb, sob))
        return compact_labels_u16(want)

    results = {}
    for mode in ("device", "mmap", "plain"):
        mgr.wsi_proc_shape = np.array((SLIDE, SLIDE))
        mgr.wsi_mask = np.ones((SLIDE // 16, SLIDE // 16), np.uint8)
        mgr._mask_integral = None
        mgr.wsi_inst_info = {}
        mgr.wsi_inst_map = np.zeros((SLIDE, SLIDE), np.int32)
        if mode != "mmap":  # as the chunk loop scatters patch outputs
            mgr._alloc_pred_dev(3)
            for i in range(0, len(coords), K3_BATCH):
                c = coords[i:i + K3_BATCH]
                outs = torch.from_numpy(np.stack(
                    [padded[y:y + out_sz, x:x + out_sz] for y, x in c]))
                scatter_patches(mgr._pred_dev, outs.to(mgr.device), c)
        else:
            mgr._pred_dev, mgr._pred_dev_mode = None, False
            mgr._pred_map_path = os.path.join(work, "pred_map.npy")
            np.save(mgr._pred_map_path, pred)
        if mode == "plain":  # the plain version in K1's place
            mgr._post_proc = plain_post_proc
        secs = mgr.post_process_phases()
        results[mode] = (mgr.wsi_inst_map.copy(), {
            k: v["centroid"].tolist() for k, v in mgr.wsi_inst_info.items()})
        log(f"wsi post-proc of {SLIDE}^2 real nuclei ({mode}): "
            f"{len(results[mode][1])} nuclei, {mgr.n_window_batches} window "
            "batches; phase seconds " + ", ".join(f"{v:.3f}" for v in secs))
    del mgr._post_proc
    mgr._pred_dev = None
    map_d, info_d = results["device"]
    for mode in ("mmap", "plain"):
        if not np.array_equal(results[mode][0], map_d) \
                or results[mode][1] != info_d:
            raise AssertionError(f"the {mode} run's instances differ from "
                                 "the device-buffer run's")
    log("wsi: device buffer, mmap and plain K1 give identical instances")

    blb, sob = batches[0]  # the full 2048^2 tiles of phase 1
    ms = median_ms(lambda: proc_tail(blb, sob), 10)
    plain_ms = median_ms(lambda: proc_tail_reference(blb, sob), 3)
    log(f"K1 time at WSI window batch {tuple(blb.shape)}: kernel "
        f"{ms:.3f} ms, plain {plain_ms:.3f} ms (median, CUDA events)")
    log_split(f"K1 at WSI window batch {tuple(blb.shape)}",
              lambda st: proc_tail(blb, sob, stats=st))
    kernel_split(f"K1 at WSI window batch {tuple(blb.shape)}",
                 lambda: proc_tail(blb, sob))
    k1_bound = bound(tensor_bytes(blb, sob, proc_tail(blb, sob)))

    # the stitching algorithm against the single-shot solve of the whole
    # map: the fixing rule of phases 2-3 may drop a re-predicted nucleus
    # that touches a kept boundary straddler (the JAX manager does the
    # same, tests/test_torch_wsi.py), so counts agree to 1%, not exactly
    blb, sob = energy_inputs(torch.from_numpy(pred.astype(np.float32))[None]
                             .to(mgr.device))
    whole = proc_tail(blb, sob)
    if not torch.equal(whole, proc_tail_reference(blb, sob)):
        raise AssertionError("K1 disagrees with its plain version on the "
                             "whole map")
    whole = whole[0].cpu().numpy()
    n_whole = len(np.unique(whole)) - 1
    n_tiled = len(np.unique(map_d)) - 1
    aji = aji_of(whole, map_d)
    log(f"wsi stitched vs single-shot K1 at {SLIDE}^2: {n_tiled} vs "
        f"{n_whole} instances, AJI {aji:.5f}")
    if abs(n_tiled - n_whole) > 0.01 * n_whole or aji <= 0.95 \
            or n_whole < 1000:
        raise AssertionError("the stitched WSI instances are off")
    return {"ms": ms, "plain_ms": plain_ms, "max_abs_err": max_err,
            "bound": k1_bound}


def check_k2(dev, canvas):
    """Phase 9: K2 == plain on the watershed test maps and the 1148^2
    canvas in all three sweep orders; times at 1148^2; the blocked entry
    against its plain version (the same entry on the CPU) element for
    element, and against the whole-map K2 at instance level."""
    import torch

    from hover_net_tpu_torch.ops.post_proc_cuda import (
        SWEEP_ORDERS,
        proc_tail,
        watershed_inputs,
    )
    from hover_net_tpu_torch.ops.watershed_cuda import (
        watershed,
        watershed_blocked,
        watershed_reference,
    )

    sys.path.append(os.path.join(ROOT, "tests"))
    threads = torch.get_num_threads()
    from test_torch_watershed import make_case  # numpy, pytest, torch only
    torch.set_num_threads(threads)  # the test module pins one thread

    def on_card(*maps):
        return [torch.from_numpy(np.stack(m)).to(dev) for m in zip(*maps)]

    cases = [(f"make_case_seed{seed}",
              on_card(make_case(np.random.default_rng(seed))))
             for seed in (0, 1)]
    rng = np.random.default_rng(2)
    cases.append(("make_case_batch3", on_card(*[make_case(rng)
                                                for _ in range(3)])))
    blb, sob = canvas
    cases.append((f"canvas_{CANVAS}", list(watershed_inputs(blb, sob))))
    max_err = 0
    for name, (e, m, b) in cases:
        want = watershed_reference(e, m, b)
        for order in SWEEP_ORDERS:
            got = watershed(e, m, b, sweep_order=order)
            torch.cuda.synchronize()
            n_diff = int((got != want).sum())
            max_err = max(max_err, int((got.long() - want.long()).abs().max()))
            if n_diff:
                raise AssertionError(f"K2 disagrees with its plain version "
                                     f"on {name}, sweep order {order}")
        log(f"K2 vs plain {name} {tuple(e.shape)}: {len(torch.unique(want)) - 1}"
            f" instances, identical in sweep orders {SWEEP_ORDERS}")
    if not torch.equal(want, proc_tail(blb, sob)):
        raise AssertionError("K2 on the tail's own stages differs from K1")
    ms = median_ms(lambda: watershed(e, m, b), 20)
    plain_ms = median_ms(lambda: watershed_reference(e, m, b), 5)
    log(f"K2 time at {CANVAS}^2: kernel {ms:.3f} ms, plain {plain_ms:.3f} ms "
        f"(median, CUDA events); K2 on the tail's stages == K1")
    log_split(f"K2 at {CANVAS}^2", lambda st: watershed(e, m, b, stats=st))
    k2_bound = bound(tensor_bytes(e, m, b, want))

    # the op API as a user calls it: the blocked entry and the whole map
    e, m, b = on_card(make_case(np.random.default_rng(5), (800, 700), 160))
    watershed.launches = 0
    whole = watershed(e, m, b)
    blocked = watershed_blocked(e, m, b)
    launches = watershed.launches
    # the plain version of the blocked entry: the same window batch
    # ([9, 512, 512] here), solved by watershed_reference on the CPU
    plain = watershed_blocked(e.cpu(), m.cpu(), b.cpu())
    n_diff = int((blocked.cpu() != plain).sum())
    max_err = max(max_err, int((blocked.cpu().long() - plain.long())
                               .abs().max()))
    whole, blocked = whole[0].cpu().numpy(), blocked[0].cpu().numpy()
    n_whole = len(np.unique(whole)) - 1
    n_blocked = len(np.unique(blocked)) - 1
    aji = aji_of(whole, blocked)
    log(f"K2 blocked (core 320, halo 96) at 800x700: {n_diff} labels differ "
        f"from its plain version; vs whole map {n_blocked} vs {n_whole} "
        f"instances, AJI {aji:.6f}; K2 launches {launches}")
    if n_diff:
        raise AssertionError("the blocked K2 disagrees with its plain version")
    if launches != 2 or n_blocked != n_whole or aji <= 0.999 \
            or n_whole < 100:
        raise AssertionError("the blocked K2 is off")
    return {"ms": ms, "plain_ms": plain_ms, "max_abs_err": max_err,
            "bound": k2_bound, "launches": launches}


def check_k4(canvas):
    """Phase 10: the six K4 variants == plain at 1148^2 and their times;
    then the stage probe as a user runs it."""
    import torch

    from hover_net_tpu_torch.cli import probe_pp_stages
    from hover_net_tpu_torch.ops.post_proc_cuda import (
        SKIPS,
        proc_tail,
        proc_tail_reference,
    )

    blb, sob = canvas
    full = proc_tail(blb, sob)
    max_err, ms, plain_ms = 0, [], []
    for skip in SKIPS:
        got = proc_tail(blb, sob, skip=skip)
        want = proc_tail_reference(blb, sob, skip=skip)
        torch.cuda.synchronize()
        n_diff = int((got != want).sum())
        max_err = max(max_err, int((got.long() - want.long()).abs().max()))
        if n_diff or (skip == "none" and not torch.equal(got, full)):
            raise AssertionError(f"K4 variant {skip} disagrees with its "
                                 "plain version or with K1")
        if skip != "none":
            ms.append(median_ms(lambda: proc_tail(blb, sob, skip=skip), 20))
            plain_ms.append(median_ms(
                lambda: proc_tail_reference(blb, sob, skip=skip), 5))
            timing = f"; kernel {ms[-1]:.3f} ms, plain {plain_ms[-1]:.3f} ms"
        else:
            timing = " (K1)"
        log(f"K4 vs plain skip={skip} {tuple(blb.shape)}: "
            f"{len(torch.unique(want)) - 1} labels, identical{timing}")

    proc_tail.skip_launches = 0
    log(f"$ python -m hover_net_tpu_torch.cli.probe_pp_stages --size {SRC_HW}")
    probe_pp_stages.main(["--size", str(SRC_HW)])
    launches = proc_tail.skip_launches
    if launches != (probe_pp_stages.REPS + 1) * (len(SKIPS) - 1):
        raise AssertionError(f"the probe launched K4 {launches} times")
    return {"ms": statistics.mean(ms), "plain_ms": statistics.mean(plain_ms),
            "max_abs_err": max_err,
            "bound": bound(tensor_bytes(blb, sob, full)),
            "launches": launches}


# ------------------------------------------------- multi-device inference

MESH_SLOTS = 4     # stripe slots of phase 13 (a), all on cuda:0
MESH_TILE = 1024   # its post-proc tile: 16 windows a phase-1 batch, so
                   # that every slot's shard runs K1
# the order of the runs of phase 13 (a) and (b), in turns, so that the
# striping overhead is read against a single-device run on either side
TURNS = ("single", "striped", "striped", "single")


def stitched_pred(mgr):
    """The slide's stitched prediction in `mgr`'s device pred buffer, on
    the first slot's device: the buffer cropped to the slide, or under a
    mesh the stripes' core rows in slot order."""
    import torch

    h, w = (int(v) for v in mgr.wsi_proc_shape)
    if mgr.mesh is None:
        return mgr._pred_dev[:h, :w].clone()
    s_rows, halo = mgr._stripe
    return torch.cat([b[halo:halo + s_rows].to(mgr.device)
                      for b in mgr._pred_dev])[:h, :w]


def striped_post_proc(tar, work, card, device="cuda"):
    """Phase 13 (a): the 4096^2 prediction map of phase 8 through the 3
    phases from a MESH_SLOTS-slot striped buffer on cuda:0 and from the
    single-device buffer, in TURNS. Returns K1's launches."""
    import torch

    from hover_net_tpu_torch.infer.wsi import WSIInferManager, fill_pred_dev
    from hover_net_tpu_torch.ops.post_proc_cuda import proc_tail

    pred = synth_pred(synth_inst(SLIDE, SLIDE, SLIDE_NUCLEI, seed=8)
                      ).astype(np.float16)
    out_sz = 164
    grid = np.arange(0, SLIDE, out_sz)
    padded = np.zeros((grid[-1] + out_sz,) * 2 + (3,), np.float16)
    padded[:SLIDE, :SLIDE] = pred
    coords = np.array([(y, x) for y in grid for x in grid], np.int32)
    outs = torch.from_numpy(np.stack(
        [padded[y:y + out_sz, x:x + out_sz] for y, x in coords]))
    res, launches = [], 0
    for name in TURNS:
        devices = [device] * (MESH_SLOTS if name == "striped" else 1)
        mgr = WSIInferManager(
            model_path=tar, mode="fast", nr_types=None, width=64,
            batch_size=K3_BATCH, devices=devices,
            tile_shape=MESH_TILE, ambiguous_size=128,
            cache_path=os.path.join(work, f"mesh_cache_{name}"))
        mgr.wsi_proc_shape = np.array((SLIDE, SLIDE))
        mgr.wsi_mask = np.ones((SLIDE // 16, SLIDE // 16), np.uint8)
        mgr.wsi_inst_info = {}
        mgr.wsi_inst_map = np.zeros((SLIDE, SLIDE), np.int32)
        mgr._alloc_pred_dev(3)
        fill_pred_dev(mgr, outs, coords, K3_BATCH)
        proc_tail.launches = 0
        t0 = time.perf_counter()
        secs = mgr.post_process_phases()
        wall = time.perf_counter() - t0
        k1 = proc_tail.launches
        launches += k1
        res.append((name, mgr.wsi_inst_map.copy(), set(mgr.wsi_inst_info),
                    mgr.n_window_batches, mgr.n_window_shards))
        stripe = (f", stripes of {mgr._stripe[0]} core + 2 x "
                  f"{mgr._stripe[1]} halo rows" if mgr._stripe else "")
        log(f"mesh (a) {name}: {len(res[-1][2])} nuclei, "
            f"{mgr.n_window_batches} window batches, {mgr.n_window_shards} "
            f"shards, K1 launches {k1}{stripe}; post-proc {wall:.3f} s, "
            "phase seconds " + ", ".join(f"{v:.3f}" for v in secs)
            + f" ({card})")
        if k1 != mgr.n_window_shards or k1 == 0:
            raise AssertionError(f"mesh (a) {name}: K1 ran {k1} times for "
                                 f"{mgr.n_window_shards} shards")
        del mgr
    _, map_1, ids_1, batches_1, _ = res[0]
    for name, map_n, ids_n, batches_n, shards_n in res[1:]:
        if not np.array_equal(map_n, map_1) or ids_n != ids_1:
            raise AssertionError(f"mesh (a): a {name} run's instances "
                                 "differ from the first single-device run's")
        if name == "striped" and (shards_n != batches_1
                                  or batches_n >= shards_n):
            raise AssertionError(f"mesh (a): {shards_n} shards in "
                                 f"{batches_n} batches, single-device "
                                 f"{batches_1} batches")
    log(f"mesh (a): {MESH_SLOTS} slots == one device, bit for bit "
        f"({len(ids_1)} nuclei)")
    return launches


def striped_slide(tar, dirs, work, card, device="cuda"):
    """Phase 13 (b): phase 7's pseudo-slide through the 2-slot mesh
    manager and the single-device manager in TURNS, once with the
    standard cuDNN encoder (`steps.standard_encoder()`) and once with the
    default (K3 on every slot): the stitched prediction (before
    post-processing), the json and the instance map must be identical to
    the first single-device run's of the same encoder. Returns the
    launches of K1 and K3."""
    from hover_net_tpu_torch.infer.steps import standard_encoder

    k1 = k3 = 0
    for fused in (False, True):
        with standard_encoder(not fused):
            launches = striped_slide_turns(tar, dirs, work, card, device,
                                           fused)
        k1 += launches[0]
        k3 += launches[1]
    return k1, k3


def striped_slide_turns(tar, dirs, work, card, device, fused):
    """Phase 13 (b) with one encoder (K3 when `fused`): the runs in TURNS
    and their comparison. Returns the launches of K1 and K3."""
    import torch

    from hover_net_tpu_torch.infer.wsi import WSIInferManager
    from hover_net_tpu_torch.ops.fused_block_cuda import fused_block_apply
    from hover_net_tpu_torch.ops.post_proc_cuda import proc_tail

    enc = "K3" if fused else "cuDNN"
    res, launches, k3_launches = [], 0, 0
    for turn, name in enumerate(TURNS):
        devices = [device] * (2 if name == "striped" else 1)
        out = os.path.join(work, f"mesh_out_{enc}_{turn}_{name}")
        mgr = WSIInferManager(
            model_path=tar, mode="fast", nr_types=None, width=64,
            batch_size=K3_BATCH, devices=devices, chunk_shape=2048,
            tile_shape=2048, ambiguous_size=128, proc_mag=40,
            cache_path=os.path.join(work, f"mesh_cache_{enc}_{turn}"))
        preds = []
        phases = mgr.post_process_phases

        def keep_pred_then_phases():
            preds.append(stitched_pred(mgr))
            return phases()

        mgr.post_process_phases = keep_pred_then_phases
        proc_tail.launches = 0
        fused_block_apply.launches = 0
        t0 = time.perf_counter()
        written = mgr.process_wsi_list(dirs["slides"], out,
                                       input_mask_dir=dirs["masks"])
        wall = time.perf_counter() - t0
        k1, k3 = proc_tail.launches, fused_block_apply.launches
        launches += k1
        k3_launches += k3
        if written != 1:
            raise AssertionError(f"mesh (b) {enc} {name}: no json written")
        with open(os.path.join(out, "slide.json")) as f:
            nuc = json.load(f)["nuc"]
        # the single-device map is a tensor on the card, the mesh's a
        # host memmap
        res.append((name, nuc, np.array(torch.as_tensor(
                        mgr.wsi_inst_map).cpu()),
                    mgr.n_forward_batches, preds[0]))
        log(f"mesh (b) {enc} {name}: {SLIDE}^2 slide in {wall:.3f} s wall, "
            f"{mgr.n_forward_batches} forward batches, "
            f"{mgr.n_window_batches} window batches, {mgr.n_window_shards} "
            f"shards, K1 launches {k1}, K3 launches {k3}, {len(nuc)} "
            "nuclei; seconds "
            + ", ".join(f"{k} {v:.3f}" for k, v in
                        mgr.timings["slide"].items()) + f" ({card})")
        if k1 != mgr.n_window_shards or k1 == 0:
            raise AssertionError(f"mesh (b) {enc} {name}: K1 ran {k1} times "
                                 f"for {mgr.n_window_shards} shards")
        if k3 != (4 * mgr.n_forward_batches if fused else 0) \
                or mgr.n_forward_batches == 0:
            raise AssertionError(f"mesh (b) {enc} {name}: K3 ran {k3} times "
                                 f"for {mgr.n_forward_batches} forward "
                                 "shards")
        del mgr
    _, nuc_1, map_1, fwd_1, pred_1 = res[0]
    if not torch.isfinite(pred_1).all():
        raise AssertionError(f"mesh (b) {enc}: the prediction is not finite")
    for name, nuc_n, map_n, fwd_n, pred_n in res[1:]:
        if not torch.equal(pred_n, pred_1) or nuc_n != nuc_1 \
                or not np.array_equal(map_n, map_1) or fwd_n != fwd_1:
            raise AssertionError(f"mesh (b) {enc}: a {name} run differs "
                                 "from the first single-device run")
    log(f"mesh (b) {enc}: 2 slots == one device, bit for bit: the stitched "
        f"{tuple(pred_1.shape)} prediction (max |value| "
        f"{float(pred_1.abs().max()):.3f}), {len(nuc_1)} nuclei")
    return launches, k3_launches


def round_robin_tiles(work, card, device="cuda"):
    """Phase 13 (c): phase 4's untyped images through a 2-slot tile
    manager on cuda:0 (a dispatch thread a slot) and a single-device one,
    in TURNS; every json must be phase 4's. Returns K1's launches."""
    from hover_net_tpu_torch.infer.tile import TileInferManager
    from hover_net_tpu_torch.ops.post_proc_cuda import proc_tail

    src = os.path.join(work, "in_untyped")
    names = sorted(os.listdir(src))
    launches = 0
    for turn, name in enumerate(TURNS):
        mgr = TileInferManager(
            model_path=os.path.join(work, "untyped.tar"), mode="fast",
            nr_types=None, width=64,
            type_info_path=os.path.join(ROOT, "type_info.json"),
            devices=[device] * (2 if name == "striped" else 1))
        out = os.path.join(work, f"mesh_out_tiles_{turn}")
        proc_tail.launches = 0
        t0 = time.perf_counter()
        written = mgr.process_file_list(src, out, save_format="json")
        wall = time.perf_counter() - t0
        k1 = proc_tail.launches
        launches += k1
        if written != len(names) or k1 != len(names) \
                or mgr._rr != len(names):
            raise AssertionError(f"mesh (c) {name}: {written} images "
                                 f"written, K1 ran {k1} times, {mgr._rr} "
                                 "dispatched")
        for fname in names:
            stem = os.path.splitext(fname)[0]
            with open(os.path.join(out, "json", f"{stem}.json")) as f:
                got = json.load(f)
            with open(os.path.join(work, "out_untyped", "json",
                                   f"{stem}.json")) as f:
                want = json.load(f)
            if got != want:
                raise AssertionError(f"mesh (c) {name}: {stem}.json "
                                     "differs from phase 4's")
        log(f"mesh (c) {name}: {written} images over "
            f"{len(mgr.devices)} slot(s) in {wall:.3f} s wall, K1 launches "
            f"{k1}; json == phase 4's ({card})")
        del mgr
    return launches


def check_multi_device(work, dirs, card, device="cuda:0"):
    """Phase 13: (a), (b) and (c), every slot on `device`. Returns the
    launches of K1 in all three and of K3 in (b)."""
    import torch

    t0 = time.perf_counter()
    tar = os.path.join(work, "wsi.tar")
    k1 = striped_post_proc(tar, work, card, device)
    torch.cuda.empty_cache()
    k1_b, k3 = striped_slide(tar, dirs, work, card, device)
    torch.cuda.empty_cache()
    k1 += k1_b + round_robin_tiles(work, card, device)
    log(f"phase 13 in {time.perf_counter() - t0:.1f} s")
    return k1, k3


# ------------------------------------------------------------ training

TRAIN_IMAGES = 3    # 1000^2 training images: 3 x 49 patches of 540^2
TRAIN_WIDTH = 64    # the trainer's model, full width


def write_consep(root, n_images, seed):
    """A CoNSeP-style dataset: Images/*.png and Labels/*.mat with
    `inst_map` and a raw `type_map` of 7 classes (the loader merges them
    to 4 + background), synthetic nuclei made as bench.py makes them."""
    import cv2
    import scipy.io as sio

    for sub in ("Images", "Labels"):
        os.makedirs(os.path.join(root, sub))
    for i in range(n_images):
        inst = synth_inst(SRC_HW, SRC_HW, N_NUCLEI, seed + i)
        rng = np.random.default_rng(seed + i)
        types = rng.integers(1, 8, inst.max() + 1)
        img = np.full((SRC_HW, SRC_HW, 3), 225, np.float32)
        img += rng.normal(0, 4, img.shape)
        img[inst > 0] = (np.array([120, 70, 150])
                         + rng.normal(0, 10, (inst.max() + 1, 3)))[inst[inst > 0]]
        img = np.clip(img, 0, 255).astype(np.uint8)
        cv2.imwrite(os.path.join(root, "Images", f"img{i}.png"),
                    cv2.cvtColor(img, cv2.COLOR_RGB2BGR))
        sio.savemat(os.path.join(root, "Labels", f"img{i}.mat"),
                    {"inst_map": inst,
                     "type_map": np.where(inst > 0, types[inst], 0)})


def step_stats(info, batch):
    """(median ms of a step after the first two, the per-step rate in
    patches/s over those steps' step and wait time, the loader's share of
    that time, patches/s over the phase's whole run)."""
    steps, waits = info.step_s[2:], info.wait_s[2:]
    total = sum(steps) + sum(waits)
    return (statistics.median(steps) * 1e3, batch * len(steps) / total,
            sum(waits) / total, batch * len(info.step_s) / info.run_s)


# the w8 step checks: (case, body dtype, cuDNN TF32, bound on the relative
# difference of the loss terms; grad_norm too with the float64 body)
STEP_CASES = (("float64 body", "float64", False, 1e-5),
              ("float32, TF32 on", "float32", True, 2e-2))


def train_cpu_vs_cuda(patch_dir, mode="fast", cases=STEP_CASES):
    """One phase-2 step at width 8 in `mode` from the same weights and
    batch (the mode's input and target crops of the 540^2 patches) on the
    card and on the CPU, for each case: the model body in float64 (heads
    and loss float32, as in the float64 parity test of
    tests/test_torch_train_step.py), and float32 with cuDNN's default
    TF32, as the trainer runs. Prints each case's relative differences
    and fails past its bound: in float32 the random net's gradient is
    chaotic (grad_norm moves by ~1e-2 between any two float32 runs), so
    only the float64 body holds grad_norm."""
    import torch

    from hover_net_tpu_torch.data.train_pipeline import (
        PatchDataset,
        TrainLoader,
    )
    from hover_net_tpu_torch.models.hovernet import (
        MODE_SHAPES,
        HoVerNet,
        HoVerNetConfig,
    )
    from hover_net_tpu_torch.parallel import train_parallel as tp

    win, out_sz = MODE_SHAPES[mode]
    loader = TrainLoader(PatchDataset([patch_dir]), batch_size=4,
                         input_shape=(win, win), mask_shape=(out_sz, out_sz),
                         mode="valid", with_type=True, num_workers=0)
    batch = {k: torch.from_numpy(v) for k, v in next(iter(loader)).items()}
    start = HoVerNet(HoVerNetConfig(mode=mode, nr_types=5, width=8),
                     generator=torch.Generator().manual_seed(4))

    def terms(device, body):
        net = HoVerNet(HoVerNetConfig(mode=mode, nr_types=5, width=8,
                                      dtype=body))
        net.load_state_dict(start.state_dict())
        tx, schedule = tp.make_optimizer()
        state = tp.init_train_state(net, tx, device)
        step = tp.make_train_step(net, schedule, freeze_encoder=False)
        _, (out, _) = step(state, {k: v.to(device) for k, v in batch.items()})
        return {k: float(v) for k, v in out.items()}

    for case, body, tf32, tol in cases:
        body = getattr(torch, body)
        want = terms("cpu", body)
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=tf32):
            got = terms("cuda", body)
        rel = {k: abs(got[k] - w) / abs(w) for k, w in want.items()}
        checked = {k: v for k, v in rel.items()
                   if k != "grad_norm" or body == torch.float64}
        worst = max(checked.items(), key=lambda kv: kv[1])
        log(f"w8 step ({mode}, {win}^2 -> {out_sz}^2) cuda vs cpu, {case}: "
            f"largest relative difference {worst[1]:.2e} ({worst[0]}; bound "
            f"{tol:g}); " + ", ".join(f"{k} {v:.1e}" for k, v in rel.items()))
        if worst[1] > tol:
            raise AssertionError("the card's train step disagrees with "
                                 "the CPU's")


def run_default_phases(root, cfg_path, mode, width, device="cuda"):
    """cli/run_train on `cfg_path` (the two default phases, one epoch
    each, writing under root/logs; a model of `width`), then the checks of
    phase 11: every loss finite; after phase 1 the frozen parameters
    bit-identical to the trainer's seeded start, every other parameter
    and d1..d3's BN statistics moved; after phase 2 every parameter
    moved; each phase's `.tar` and stats.json written. Prints each
    phase's ms per step, rates, loader share, and the peak device memory.
    Returns (the two `.tar` paths, the training's wall seconds)."""
    import torch

    from hover_net_tpu_torch.cli import run_train
    from hover_net_tpu_torch.config import TrainConfig, default_phases
    from hover_net_tpu_torch.models.checkpoints import load_torch_tar
    from hover_net_tpu_torch.models.hovernet import HoVerNet, HoVerNetConfig

    phases = default_phases(mode)
    torch.cuda.reset_peak_memory_stats()
    log(f"$ python -m hover_net_tpu_torch.cli.run_train --config {cfg_path}"
        f" (model_mode={mode}; cudnn.allow_tf32="
        f"{torch.backends.cudnn.allow_tf32}, cuda.matmul.allow_tf32="
        f"{torch.backends.cuda.matmul.allow_tf32})")
    t0 = time.perf_counter()
    infos = run_train.main(["--config", cfg_path, "--device", device])
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"training ({mode}): 2 phases in {wall:.1f} s wall, peak device "
        f"memory {peak:.2f} GiB")
    for idx, (info, phase) in enumerate(zip(infos, phases)):
        batch = phase.batch_size["train"]
        if len(info.losses) < 8 or not np.all(np.isfinite(info.losses)):
            raise AssertionError(f"phase {idx}: {len(info.losses)} steps, "
                                 f"losses {info.losses}")
        ms, rate, share, run_rate = step_stats(info, batch)
        log(f"train ({mode}) phase {idx} (freeze_encoder="
            f"{phase.freeze_encoder}, batch {batch}): {len(info.losses)} "
            f"steps, {ms:.3f} ms per step (median after 2), per-step rate "
            f"{rate:.1f} patches/s, loader wait {100 * share:.1f} % of the "
            f"step; {run_rate:.1f} patches/s over the phase's whole run of "
            f"{info.run_s:.1f} s (validation, checkpoints and the workers' "
            f"start included); overall_loss {info.losses[0]:.4f} -> "
            f"{info.losses[-1]:.4f}")

    logs = os.path.join(root, "logs")
    tars = [os.path.join(logs, f"{i:02d}", "net_epoch=1.tar")
            for i in range(2)]
    for i, tar in enumerate(tars):
        with open(os.path.join(logs, f"{i:02d}", "stats.json")) as f:
            stats = json.load(f)
        if not os.path.exists(tar) or "valid-np_dice" not in stats["1"]:
            raise AssertionError(f"phase {i}: no checkpoint or no stats")
    start = HoVerNet(HoVerNetConfig(mode=mode, nr_types=5, width=width),
                     generator=torch.Generator().manual_seed(
                         TrainConfig().seed)).state_dict()
    p0, p1 = load_torch_tar(tars[0]), load_torch_tar(tars[1])
    params = [k for k, _ in HoVerNet(HoVerNetConfig(
        mode=mode, nr_types=5, width=8)).named_parameters()]
    frozen = [k for k in params
              if k.startswith(("d1.", "d2.", "d3.", "d0.units."))]
    stats_d13 = [k for k in p0 if k.startswith(("d1.", "d2.", "d3."))
                 and k.endswith(("running_mean", "running_var"))]
    bad = ([k for k in frozen if not torch.equal(p0[k], start[k])]
           + [k for k in params if k not in frozen
              and torch.equal(p0[k], start[k])]
           + [k for k in stats_d13 if torch.equal(p0[k], start[k])]
           + [k for k in params if torch.equal(p1[k], p0[k])])
    log(f"freeze cut ({mode}): {len(frozen)} frozen parameters unchanged, "
        f"{len(params) - len(frozen)} trained, {len(stats_d13)} d1..d3 BN "
        f"statistics moved in phase 1; all {len(params)} moved in phase 2; "
        f"{len(bad)} off")
    if bad:
        raise AssertionError(f"the freeze cut is off at {bad[:5]}")
    return tars, wall


def check_training(work, device="cuda"):
    """Phase 11: training as a user runs it, at full width: a synthetic
    CoNSeP dataset, patches from cli/extract_patches (540 / 164), the
    two default phases (frozen encoder at batch 16, then all at batch 4)
    for one epoch each through cli/run_train; checks the freeze cut, the
    checkpoints and stats, loads the trained `.tar` into the tile
    manager, and holds one width-8 step on the card against the CPU."""
    import torch

    from hover_net_tpu_torch.cli import extract_patches
    from hover_net_tpu_torch.infer.tile import TileInferManager

    root = os.path.join(work, "train")
    t_start = t0 = time.perf_counter()
    patch_dirs = {}
    for split, n_img, seed in (("train", TRAIN_IMAGES, 200),
                               ("valid", 1, 300)):
        src = os.path.join(root, "consep", split)
        write_consep(src, n_img, seed)
        patch_dirs[split] = os.path.join(root, "patches", split)
        extract_patches.main([
            "--dataset", "consep", "--with_type",
            "--img_dir", os.path.join(src, "Images"),
            "--ann_dir", os.path.join(src, "Labels"),
            "--out_dir", patch_dirs[split],
            "--win_size", "540", "--step_size", "164"])
    n_patches = {k: len(os.listdir(v)) for k, v in patch_dirs.items()}
    data_s = time.perf_counter() - t0
    log(f"training data: {n_patches} patches of 540^2 in {data_s:.1f} s")

    cfg_path = os.path.join(root, "config.py")
    with open(cfg_path, "w") as f:
        f.write(
            "from hover_net_tpu_torch.config import TrainConfig\n"
            f"config = TrainConfig(model_mode='fast', nr_types=5, "
            f"width={TRAIN_WIDTH}, log_dir={os.path.join(root, 'logs')!r}, "
            f"train_dir_list=[{patch_dirs['train']!r}], "
            f"valid_dir_list=[{patch_dirs['valid']!r}])\n"
            "for phase in config.phases:\n"
            "    phase.nr_epochs = 1\n")
    tars, wall = run_default_phases(root, cfg_path, "fast", TRAIN_WIDTH,
                                    device)

    img_dir = os.path.join(root, "tile_in")
    os.makedirs(img_dir)
    shutil.copy(os.path.join(root, "consep", "valid", "Images", "img0.png"),
                img_dir)
    mgr = TileInferManager(model_path=tars[1], mode="fast", nr_types=5,
                           width=TRAIN_WIDTH, device=device,
                           type_info_path=os.path.join(ROOT,
                                                       "type_info.json"))
    out = os.path.join(root, "tile_out")
    if mgr.process_file_list(img_dir, out, save_format="json") != 1:
        raise AssertionError("the trained checkpoint wrote no json")
    with open(os.path.join(out, "json", "img0.json")) as f:
        n_nuc = len(json.load(f)["nuc"])
    log(f"trained .tar -> TileInferManager: img0.json with {n_nuc} nuclei")

    t0 = time.perf_counter()
    checks_s = t0 - t_start - data_s - wall
    train_cpu_vs_cuda(patch_dirs["valid"])
    now = time.perf_counter()
    log(f"phase 11 in {now - t_start:.1f} s: data {data_s:.1f}, training "
        f"{wall:.1f}, checkpoint checks and tile {checks_s:.1f}, w8 cuda vs "
        f"cpu {now - t0:.1f}")
    del mgr
    torch.cuda.empty_cache()
    return tars[1]


# ---------------------------------------------------------- evaluation

EVAL_IMAGES = 4     # held-out 1000^2 images (phase 11 used seeds 200-202, 300)
EVAL_SEED = 400
# the JAX package's record of its device path against the host oracle
# (scripts/parity_drift_sweep_r5_tpu.csv: 50 trained-checkpoint tiles on a
# TPU v5 lite), printed beside the port's: AJI mean, min
TPU_DRIFT_RECORD = (0.981, 0.960)
AJI_FLOOR = 0.93    # the JAX package's composed parity floor, device vs host
# the record of the same checks while the bf16 body still rounded its
# BatchNorms to bf16 (runs of this script on an NVIDIA H100 80GB HBM3 at
# 700.00 W, PERF.md §6): AJI (mean, min) of each drift pair of phase 12
# (typed, 4 images) and of cli/fused_encoder_drift in phase 15 (untyped,
# 4 tiles), min None where it was not recorded; the recipe checkpoints'
# sha256 (training is float32, which the BatchNorm dtype rule leaves
# alone, so they should not change)
BN_BF16_DRIFT = {
    "typed": {"fused_vs_standard": (0.94195, 0.92402),
              "floor_standard_vs_float32": (0.86615, 0.77386),
              "fused_vs_float32": (0.872, None)},
    "untyped": {"fused_vs_standard": (0.98508, 0.96926),
                "floor_standard_vs_float32": (0.96908, 0.95875),
                "fused_vs_float32": (0.967, None)},
}
RECIPE_SHA256 = {"typed": "468ba087", "untyped": "2a69ddd3"}


def log_beside_record(what, mean, low, record, card):
    log(f"{what}: AJI mean {mean:.5f}, min {low:.5f} ({card}); recorded "
        f"with the BatchNorms in bf16: mean {record[0]}, min "
        f"{record[1] or 'not recorded'} (NVIDIA H100 80GB HBM3, 700.00 W)")


class UntypedRecipe:
    """Phase 15's untyped recipe checkpoint (`cli/recipe.
    train_e2e_checkpoint()`, cached under build/, where phase 15 reads it
    and checks its sha256), trained in a process of its own from the
    start of phase 11 to the end of phase 12: phase 11 spends half its
    time on the host (writing the dataset, extracting patches, the CPU
    side of the w8 step check) while the card idles. The training is
    deterministic, the same weights whatever runs beside it."""

    def __init__(self):
        import multiprocessing

        from hover_net_tpu_torch.cli import recipe

        self.t0 = time.perf_counter()
        self.proc = multiprocessing.get_context("spawn").Process(
            target=recipe.train_e2e_checkpoint, name="untyped-recipe")
        self.proc.start()

    def join(self):
        """Waits for the training, fails if it failed, and returns its
        seconds from its start."""
        self.proc.join()
        if self.proc.exitcode != 0:
            raise AssertionError("the untyped recipe's training exited with "
                                 f"{self.proc.exitcode}")
        return time.perf_counter() - self.t0


def log_sha256(what, path, secs, recorded_prefix):
    from hover_net_tpu_torch.cli import recipe

    sha = recipe.checkpoint_sha256(path)
    same = ("the same as" if sha.startswith(recorded_prefix)
            else "differs from")
    log(f"{what} in {secs:.1f} s: sha256 {sha}, {same} the recorded "
        f"{recorded_prefix}...")


def write_truth(root):
    """EVAL_IMAGES held-out CoNSeP-style images (Images/*.png) and a truth
    directory of `.mat` files with inst_map, inst_centroid and inst_type:
    the raw 7 types merged to 4 as data/datasets.CoNSeP.load_ann merges
    them, the centroids from ops/post_proc_host.extract_instance_info."""
    import scipy.io as sio

    from hover_net_tpu_torch.data.datasets import CoNSeP
    from hover_net_tpu_torch.metrics.stats import remap_label
    from hover_net_tpu_torch.ops.post_proc_host import extract_instance_info

    src = os.path.join(root, "consep")
    write_consep(src, EVAL_IMAGES, EVAL_SEED)
    truth = os.path.join(root, "truth")
    os.makedirs(truth)
    for i in range(EVAL_IMAGES):
        ann = CoNSeP().load_ann(os.path.join(src, "Labels", f"img{i}.mat"),
                                with_type=True)
        inst, info = extract_instance_info(remap_label(ann[..., 0]),
                                           ann[..., 1], n_types=5)
        sio.savemat(os.path.join(truth, f"img{i}.mat"), {
            "inst_map": inst,
            "inst_centroid": np.array([v["centroid"] for v in info.values()]),
            "inst_type": np.array([[v["type"]] for v in info.values()])})
    return os.path.join(src, "Images"), truth


def drift(name, want, got, names, tpu_record=False):
    """Per image AJI(want, got) and the change in nucleus count, printed
    with their mean and min (and the JAX package's TPU record of the
    same comparison); returns the AJIs."""
    ajis, deltas = [], []
    for n in names:
        ajis.append(aji_of(want[n][1], got[n][1]))
        deltas.append(got[n][0] - want[n][0])
        log(f"{name} {n}: AJI {ajis[-1]:.5f}, nuclei {want[n][0]} -> "
            f"{got[n][0]} ({deltas[-1]:+d})")
    record = (f"; the JAX package's TPU record of its device path against "
              f"the host oracle (TPU v5 lite, 50 tiles): AJI mean "
              f"{TPU_DRIFT_RECORD[0]}, min {TPU_DRIFT_RECORD[1]}"
              if tpu_record else "")
    log(f"{name}: AJI mean {statistics.mean(ajis):.5f}, min {min(ajis):.5f};"
        f" count change mean {statistics.mean(deltas):+.2f}, largest "
        f"{max(deltas, key=abs):+d}{record}")
    return ajis


def check_evaluation(work, tar, device="cuda"):
    """Phase 12: evaluation as a user runs it. A trained typed `.tar`
    through cli/run_infer three times on held-out images: (a) the device
    path with --profile_dir, (b) --host_post_proc, both with K3, the
    default, (c) the standard cuDNN encoder (`steps.standard_encoder()`);
    launch counts, the trace, the outputs, AJI(b, a) >= AJI_FLOOR per
    image, cli/convert_format and cli/compute_stats against the truth.
    (d), the manager in float32, gives the bf16 floor (c) is read
    against."""
    import glob

    import scipy.io as sio
    import torch

    from hover_net_tpu_torch.cli import compute_stats, convert_format
    from hover_net_tpu_torch.cli import run_infer
    from hover_net_tpu_torch.data.tiling import prepare_tile_patching
    from hover_net_tpu_torch.infer.steps import standard_encoder
    from hover_net_tpu_torch.infer.tile import TileInferManager
    from hover_net_tpu_torch.models.checkpoints import load_torch_tar
    from hover_net_tpu_torch.models.hovernet import HoVerNet, HoVerNetConfig
    from hover_net_tpu_torch.ops.fused_block_cuda import fused_block_apply
    from hover_net_tpu_torch.ops.post_proc_cuda import proc_tail
    from hover_net_tpu_torch.utils.summary import model_summary

    root = os.path.join(work, "eval")
    t_start = time.perf_counter()
    img_dir, truth = write_truth(root)
    names = [f"img{i}" for i in range(EVAL_IMAGES)]
    data_s = time.perf_counter() - t_start

    batch = 32  # the CLI's default --batch_size
    k = int(np.prod(prepare_tile_patching((SRC_HW, SRC_HW), 256, 164)[2]))
    batches = -(-k // batch) if 2 * batch < k else 1  # steps.forward_batches
    prof = os.path.join(root, "profile")
    runs = {"a": ["--profile_dir", prof], "b": ["--host_post_proc"],
            "c": []}
    out, secs, mgrs, k1, k3 = {}, {}, {}, {}, {}
    for run, flags in runs.items():
        out[run] = os.path.join(root, f"out_{run}")
        argv = (["--model_path", tar, "--model_mode", "fast", "--width",
                 str(TRAIN_WIDTH), "--nr_types", "5", "--type_info_path",
                 os.path.join(ROOT, "type_info.json"), "--device", device,
                 "--batch_size", str(batch)] + flags
                + ["tile", "--input_dir", img_dir, "--output_dir", out[run],
                   "--save_format", "all"])
        proc_tail.launches = fused_block_apply.launches = 0
        t0 = time.perf_counter()
        with standard_encoder(run == "c"):
            mgrs[run] = run_infer.main(argv)
        secs[run] = time.perf_counter() - t0
        k1[run], k3[run] = proc_tail.launches, fused_block_apply.launches
        log(f"eval run ({run}) {' '.join(flags) or '(standard encoder)'}: "
            f"{EVAL_IMAGES} images in {secs[run]:.3f} s, K1 launches "
            f"{k1[run]}, K3 launches {k3[run]}")
    k3_runs = 4 * batches * EVAL_IMAGES
    want = {"a": (EVAL_IMAGES, k3_runs), "b": (0, k3_runs),
            "c": (EVAL_IMAGES, 0)}
    if any((k1[r], k3[r]) != want[r] for r in runs):
        raise AssertionError(f"launches (K1, K3) {k1} {k3}, want {want}")

    traces = glob.glob(os.path.join(prof, "*.pt.trace.json"))
    if len(traces) != 1:
        raise AssertionError(f"--profile_dir wrote {traces}")
    with open(traces[0]) as f:
        trace = f.read()
    k1_names = [n for n in ("energy_dist", "morph5", "ws_final")
                if n in trace]
    log(f"profile: {os.path.relpath(traces[0], ROOT)}, "
        f"{len(trace) / 2**20:.1f} MiB, names K1's {', '.join(k1_names)}")
    if not k1_names:
        raise AssertionError("the --profile_dir trace does not name K1")

    # the bf16 noise floor of this checkpoint, for reading (a): (d) the
    # standard forward in float32 (TF32 off) through the same manager
    out["d"] = os.path.join(root, "out_d")
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        t0 = time.perf_counter()
        TileInferManager(
            model_path=tar, mode="fast", nr_types=5, width=TRAIN_WIDTH,
            dtype=torch.float32, device=device,
            type_info_path=os.path.join(ROOT, "type_info.json"),
        ).process_file_list(img_dir, out["d"], save_format="all")
        secs["d"] = time.perf_counter() - t0

    maps = {}
    for run in out:
        maps[run] = {}
        for n in names:
            with open(os.path.join(out[run], "json", f"{n}.json")) as f:
                n_nuc = len(json.load(f)["nuc"])
            inst = sio.loadmat(os.path.join(out[run], "mat", f"{n}.mat"))[
                "inst_map"]
            maps[run][n] = (n_nuc, inst)
    host_s = [t["post_proc_ms"] / 1e3 for t in mgrs["b"].timings]
    log("host post-processing (b), s per image (cv2/scipy and the Python "
        "priority-flood watershed): " + ", ".join(f"{s:.3f}" for s in host_s))
    ajis = drift("parity_drift_sweep (a) device vs (b) host oracle",
                 maps["b"], maps["a"], names, tpu_record=True)
    pairs = {
        "fused_vs_standard": drift(
            "fused_encoder_drift (a) K3 vs (c) standard forward", maps["c"],
            maps["a"], names),
        "floor_standard_vs_float32": drift(
            "bf16 floor (c) standard bf16 vs (d) standard float32",
            maps["d"], maps["c"], names),
        "fused_vs_float32": drift(
            "(a) K3 bf16 vs (d) standard float32", maps["d"], maps["a"],
            names)}
    for key, a in pairs.items():
        log_beside_record(f"phase 12 (typed, {EVAL_IMAGES} images) {key}",
                          statistics.mean(a), min(a),
                          BN_BF16_DRIFT["typed"][key], card_line())
    if min(ajis) < AJI_FLOOR or min(n for n, _ in maps["a"].values()) < 10:
        raise AssertionError(f"device vs host oracle AJI {ajis} below "
                             f"{AJI_FLOOR}, or too few nuclei")

    tsv_dir = os.path.join(root, "qupath")
    convert_format.main(["--json_dir", os.path.join(out["a"], "json"),
                         "--output_dir", tsv_dir, "--nr_types", "5",
                         "--type_info_path",
                         os.path.join(ROOT, "type_info.json")])
    rows = {}
    for n in names:
        with open(os.path.join(tsv_dir, f"{n}.tsv")) as f:
            rows[n] = len(f.readlines()) - 1
    log(f"convert_format: {len(os.listdir(tsv_dir))} tsv, rows {rows}")
    if sorted(os.listdir(tsv_dir)) != [f"{n}.tsv" for n in names] or any(
            rows[n] != maps["a"][n][0] for n in names):
        raise AssertionError("convert_format wrote the wrong rows")

    for run in out:
        pred = os.path.join(out[run], "mat")
        log(f"compute_stats ({run}) --mode instance: [DICE, AJI, DQ, SQ, "
            "PQ, AJI+] =")
        inst = compute_stats.main(["--mode", "instance", "--pred_dir", pred,
                                   "--true_dir", truth])
        log(f"compute_stats ({run}) --mode type: [F1_d, acc, F1 of types "
            "1-4] =")
        typ = compute_stats.main(["--mode", "type", "--pred_dir", pred,
                                  "--true_dir", truth])
        if not (np.all(np.isfinite(inst)) and np.all(np.isfinite(typ))):
            raise AssertionError(f"run ({run}): metrics not finite")

    net = HoVerNet(HoVerNetConfig(mode="fast", nr_types=5,
                                  width=TRAIN_WIDTH))
    net.load_state_dict(load_torch_tar(tar))
    log("model_summary of the trained model: " + "; ".join(
        model_summary(net).splitlines()[-2:]))
    now = time.perf_counter()
    checks_s = now - t_start - data_s - sum(secs.values())
    log(f"phase 12 in {now - t_start:.1f} s: data {data_s:.1f}, runs "
        + ", ".join(f"({r}) {secs[r]:.1f}" for r in secs)
        + f", checks and metrics {checks_s:.1f}")
    del mgrs
    torch.cuda.empty_cache()


# ----------------------------------------------- multi-device training

DP_WIDTH = 64       # the exactness check (c): the model at full width,
DP_SIZE = (256, 164)  # fast mode's patches,
DP_GLOBAL = 4       # a global batch of 4 over 2 ranks, for 3 steps
DP_STEPS = 3
DP_SCHEDULE = dict(lr=1.0e-4, step_epochs=1, steps_per_epoch=2, gamma=0.1)
FROZEN_PREFIXES = ("d1.", "d2.", "d3.", "d0.units.")


DP_CASES = [(True, None), (False, None)]  # (freeze_encoder, mutation)


def dp_inputs():
    """The exactness check's model configuration (width 64, the body,
    heads and loss in float64), seeded start state, and DP_STEPS global
    batches of DP_GLOBAL patches, 256^2 -> 164^2.

    The heads run in float64 here (`head_dtype`): in float32, a rounding
    in the order of a head's sum moves some gradients near Adam's eps,
    whose updates then part by up to ~lr over three steps (parallel/
    dp_check.py)."""
    import torch

    from hover_net_tpu_torch.models.hovernet import HoVerNet, HoVerNetConfig

    cfg = HoVerNetConfig(mode="fast", nr_types=5, width=DP_WIDTH,
                         dtype=torch.float64, head_dtype=torch.float64)
    start = HoVerNet(HoVerNetConfig(mode="fast", nr_types=5, width=DP_WIDTH),
                     generator=torch.Generator().manual_seed(14)).state_dict()
    rng = np.random.default_rng(14)
    (size, out), n = DP_SIZE, DP_GLOBAL
    data = [{
        "img": rng.integers(0, 256, (n, size, size, 3), np.uint8),
        "np_map": (rng.uniform(0, 1, (n, out, out)) > 0.4).astype(np.uint8),
        "hv_map": rng.uniform(-1, 1, (n, out, out, 2)).astype(np.float32),
        "tp_map": rng.integers(0, 5, (n, out, out)).astype(np.int32),
    } for _ in range(DP_STEPS)]
    return cfg, start, data


def dp_ranks(inputs, device="cuda:0"):
    """Phase 14 (b) and (c)'s ranks, in one spawn of 2 ranks on `device`
    (`dp_check.dryrun_and_rank_steps`): (b) the step of
    `dryrun_train_step(2, ...)` (its checks: a finite loss and
    bit-identical ranks), then (c)'s DP_STEPS steps of both freeze modes
    on `inputs` (`dp_inputs()`). Returns (the dryrun's loss, rank 0's
    runs)."""
    from hover_net_tpu_torch.parallel import dp_check

    cfg, start, data = inputs
    return dp_check.dryrun_and_rank_steps([device] * 2, cfg, start, data,
                                          DP_CASES, DP_SCHEDULE)


def dp_exactness(inputs, ranks, card, device="cuda:0"):
    """Phase 14 (c): the ranks' runs against the one-process steps on the
    same global batches, at the tolerances of
    tests/test_torch_train_step.py (terms at every step, the gradients of
    step 1, the parameters and BN stats after step 3, the freeze cut), and
    the ranks bit-identical after the last step."""
    from hover_net_tpu_torch.models.hovernet import HoVerNet, HoVerNetConfig
    from hover_net_tpu_torch.parallel import dp_check

    cfg, start, data = inputs
    params = [k for k, p in HoVerNet(HoVerNetConfig(
        mode="fast", nr_types=5, width=8)).named_parameters()]
    for (freeze, _), got in zip(DP_CASES, ranks):
        t0 = time.perf_counter()
        want = dp_check.one_process_steps(device, cfg, start, data, freeze,
                                          DP_SCHEDULE)
        t_one = time.perf_counter() - t0
        frozen = [k for k in params
                  if freeze and k.startswith(FROZEN_PREFIXES)]
        worst = dp_check.misses(got, want, start, params, frozen,
                                DP_SCHEDULE["lr"])
        log(f"(c) w{DP_WIDTH} float64 body and heads, 2 ranks on {device} "
            f"vs one process, freeze_encoder={freeze}, global batch "
            f"{DP_GLOBAL}, {DP_STEPS} steps: worst error / tolerance "
            + ", ".join(f"{k} {v:.3g}" for k, v in worst.items())
            + f"; ranks bit-identical: {got['equal']}; one process "
            f"{t_one:.1f} s ({card})")
        finite = all(np.isfinite(v) for t in got["terms"] for v in t.values())
        if max(worst.values()) > 1.0 or not got["equal"] or not finite:
            raise AssertionError("the 2-rank steps disagree with the "
                                 "one-process steps")


# phase 14 (d): the trainer's ranks on the first DP_PATCHES of phase 11's
# training and validation patches, phase 0 for as many epochs as give
# it 8 steps at the global batch 16, phase 1 for one epoch (8 steps at
# 4): each step of two ranks sharing the card waits ~533 times on the
# other rank's collectives, ~1.3 s a step
DP_PATCHES = {"train": 32, "valid": 8}
DP_MIN_STEPS = 8


def dp_patch_subset(root):
    """Directories of symlinks to the first DP_PATCHES of phase 11's
    patches, by name; returns {split: dir}."""
    out = {}
    for split, n in DP_PATCHES.items():
        src = os.path.join(root, "patches", split)
        out[split] = os.path.join(root, "patches_2ranks", split)
        os.makedirs(out[split])
        names = sorted(f for f in os.listdir(src) if f.endswith(".npy"))
        if len(names) < n:
            raise AssertionError(f"{len(names)} {split} patches, want {n}")
        for name in names[:n]:
            os.symlink(os.path.join(src, name), os.path.join(out[split], name))
    return out


def dp_trainer(work, card, device="cuda:0"):
    """Phase 14 (d): TrainManager(devices=["cuda:0"] * 2) on DP_PATCHES
    of phase 11's patches, both default phases at per-rank batches of 8
    and 2 (the global 16 and 4 of phase 11), each for the epochs that
    give it DP_MIN_STEPS steps."""
    import torch

    from hover_net_tpu_torch.config import TrainConfig
    from hover_net_tpu_torch.infer.tile import TileInferManager
    from hover_net_tpu_torch.models.checkpoints import load_torch_tar
    from hover_net_tpu_torch.models.hovernet import HoVerNet, HoVerNetConfig
    from hover_net_tpu_torch.train.manager import TrainManager

    root = os.path.join(work, "train")
    logs = os.path.join(root, "logs_2ranks")
    dirs = dp_patch_subset(root)
    config = TrainConfig(
        model_mode="fast", nr_types=5, width=TRAIN_WIDTH, log_dir=logs,
        train_dir_list=[dirs["train"]], valid_dir_list=[dirs["valid"]],
        nr_procs_train=1, nr_procs_valid=1)
    for phase, batch in zip(config.phases, (8, 2)):
        steps = DP_PATCHES["train"] // (2 * batch)
        phase.nr_epochs = -(-DP_MIN_STEPS // steps)
        phase.batch_size = dict(phase.batch_size, train=batch)
    t0 = time.perf_counter()
    infos = TrainManager(config, devices=[device] * 2).run()
    wall = time.perf_counter() - t0
    for idx, (info, phase) in enumerate(zip(infos, config.phases)):
        batch = 2 * phase.batch_size["train"]
        if len(info.losses) < 8 or not np.all(np.isfinite(info.losses)):
            raise AssertionError(f"2 ranks, phase {idx}: {len(info.losses)} "
                                 f"steps, losses {info.losses}")
        ms, rate, share, run_rate = step_stats(info, batch)
        log(f"(d) 2 ranks on one card, phase {idx} (freeze_encoder="
            f"{phase.freeze_encoder}, global batch {batch}, "
            f"{phase.nr_epochs} epoch(s) of {DP_PATCHES['train']} patches): "
            f"{len(info.losses)} steps, {ms:.3f} ms per step (median after "
            f"2), {rate:.1f} patches/s per step, rank 0's loader wait "
            f"{100 * share:.1f} %; {run_rate:.1f} patches/s over the phase's "
            f"run of {info.run_s:.1f} s; overall_loss {info.losses[0]:.4f} "
            f"-> {info.losses[-1]:.4f} ({card}; two ranks sharing one card, "
            "not a scaling number)")
    tars = [[os.path.join(logs, f"{i:02d}", f"net_epoch={e}.tar")
             for e in range(1, phase.nr_epochs + 1)]
            for i, phase in enumerate(config.phases)]
    if not all(os.path.exists(t) for ts in tars for t in ts):
        raise AssertionError("2 ranks: an epoch wrote no checkpoint")
    start = HoVerNet(HoVerNetConfig(mode="fast", nr_types=5,
                                    width=TRAIN_WIDTH),
                     generator=torch.Generator().manual_seed(config.seed)
                     ).state_dict()
    p0 = load_torch_tar(tars[0][-1])
    params = [k for k, _ in HoVerNet(HoVerNetConfig(
        mode="fast", nr_types=5, width=8)).named_parameters()]
    bad = [k for k in params
           if torch.equal(p0[k], start[k]) != k.startswith(FROZEN_PREFIXES)]
    if bad:
        raise AssertionError(f"2 ranks: the freeze cut is off at {bad[:5]}")
    mgr = TileInferManager(model_path=tars[1][-1], mode="fast", nr_types=5,
                           width=TRAIN_WIDTH, device=device,
                           type_info_path=os.path.join(ROOT,
                                                       "type_info.json"))
    out = os.path.join(root, "tile_out_2ranks")
    if mgr.process_file_list(os.path.join(root, "tile_in"), out,
                             save_format="json") != 1:
        raise AssertionError("the 2-rank checkpoint wrote no json")
    log(f"(d) TrainManager on 2 ranks: 2 phases in {wall:.1f} s wall (spawn, "
        "data workers and validation included); frozen parameters "
        "unchanged after phase 1 and the rest moved; the ranks identical "
        f"after each phase (the trainer checks it); one .tar an epoch "
        f"({sum(map(len, tars))}); the last through TileInferManager: one "
        "json")
    del mgr


def check_multi_device_training(work, card, device="cuda:0",
                                parts=lambda name, secs: None):
    """Phase 14: (a) dryrun_multichip(1), a one-rank NCCL group on cuda:0;
    (b) the dryrun's step on 2 ranks on cuda:0 (gloo, CUDA tensors) and
    (c) the exactness check, in one spawn; (d) the trainer on 2 ranks.
    The three spawns run at once ((a) and (b)+(c) on threads of this
    process, which wait for their ranks): most of a spawn's seconds are
    each rank's imports and start on the host (run_ranks logs every
    rank's timeline). (c)'s one-process steps follow its ranks on its
    thread; they run in float64, which cuDNN's process-wide TF32 setting
    does not touch.
    `parts(name, s)` takes each part's seconds, from the phase's start."""
    from concurrent.futures import ThreadPoolExecutor

    import torch

    from hover_net_tpu_torch.entry import dryrun_multichip
    from hover_net_tpu_torch.parallel.distributed import backend_for

    t_start = time.perf_counter()

    def timed(name, fn, *args):
        out = fn(*args)
        secs = time.perf_counter() - t_start
        parts(name, secs)
        return out, secs

    def b_and_c():
        inputs = dp_inputs()
        loss, ranks = dp_ranks(inputs, device)
        log(f"(b) dryrun_train_step's step on 2 ranks on {device} "
            f"({backend_for([device] * 2)}): loss {loss:.4f}, finite, the "
            f"ranks bit-identical; (b) and (c)'s ranks done "
            f"{time.perf_counter() - t_start:.1f} s into the phase (one "
            "spawn)")
        dp_exactness(inputs, ranks, card, device)

    with ThreadPoolExecutor(2) as pool:
        run_a = pool.submit(timed, "14 (a)", dryrun_multichip, 1, [device])
        run_bc = pool.submit(timed, "14 (b)+(c)", b_and_c)
        timed("14 (d)", dp_trainer, work, card, device)
        _, secs = run_a.result()
        log(f"(a) dryrun_multichip(1) (one rank on {device}, "
            f"{backend_for([device])}) done {secs:.1f} s into the phase")
        run_bc.result()
    torch.cuda.empty_cache()
    log(f"phase 14 in {time.perf_counter() - t_start:.1f} s")


# ------------------------------------- probes and correctness sweeps

def check_measurement(work, card, parts=lambda name, secs: None):
    """Phase 15: the probes and correctness sweeps at full width (w64,
    bf16), each through its main(argv), which prints its JSON line: the
    untyped recipe checkpoint (cached after its first run),
    cli.bench_train at batch 16 and 4, cli.probe_device_time --split
    forward, cli.fused_encoder_drift and cli.parity_drift_sweep. Checks
    each line and returns the launches of K1 and K3 over the phase;
    `parts(name, s)` takes the recipe's seconds."""
    import torch

    from hover_net_tpu_torch.cli import (
        bench_train,
        fused_encoder_drift,
        parity_drift_sweep,
        probe_device_time,
        recipe,
    )
    from hover_net_tpu_torch.infer.steps import standard_encoder
    from hover_net_tpu_torch.ops.fused_block_cuda import fused_block_apply
    from hover_net_tpu_torch.ops.post_proc_cuda import proc_tail

    root = os.path.join(work, "measure")
    t_start = t0 = time.perf_counter()
    ckpt = recipe.train_e2e_checkpoint()
    parts("15 recipe", time.perf_counter() - t0)
    log_sha256(f"untyped recipe checkpoint {os.path.relpath(ckpt, ROOT)}",
               ckpt, time.perf_counter() - t0, RECIPE_SHA256["untyped"])
    # (name, main, argv), run under the standard cuDNN encoder; the probe's
    # fused window and fused_encoder_drift's fused passes choose K3
    runs = [
        ("bench_train batch 16", bench_train.main,
         ["--steps", "30", "--batch", "16"]),
        ("bench_train batch 4", bench_train.main,
         ["--steps", "30", "--batch", "4"]),
        ("probe_device_time --split forward", probe_device_time.main,
         ["--split", "forward"]),
        ("fused_encoder_drift", fused_encoder_drift.main, ["--n", "4"]),
        ("parity_drift_sweep", parity_drift_sweep.main,
         ["--n", "4", "--csv", os.path.join(root, "parity.csv")]),
    ]
    proc_tail.launches = fused_block_apply.launches = 0
    res, secs = {}, {}
    for name, main_fn, argv in runs:
        t0 = time.perf_counter()
        with standard_encoder():
            res[name] = main_fn(argv)
        secs[name] = time.perf_counter() - t0
        torch.cuda.empty_cache()
    k1, k3 = proc_tail.launches, fused_block_apply.launches

    for batch in (16, 4):
        t = res[f"bench_train batch {batch}"]
        log(f"bench_train batch {batch}: {t['ms_per_step']:.3f} ms a step, "
            f"{t['value']:.1f} samples/s, loss {t['final_loss']:.4f}, "
            f"parameters {t['param_dtype']}, peak {t['peak_gib']:.2f} GiB")
        if t["param_dtype"] != "torch.float32":
            raise AssertionError("bench_train: parameters are not float32")
    p = res["probe_device_time --split forward"]
    log("probe_device_time: stages " + ", ".join(
        f"{k} {v:.3f}" for k, v in p["stages_ms"].items())
        + "; forward split " + ", ".join(
            f"{k} {v:.3f}" for k, v in p["split_ms"].items()))
    for name, w in p["layer_groups"].items():
        if w is None or (name == "fused_enc"
                         and w["groups_ms"].get("K3 (d0..d2)", 0) <= 0):
            raise AssertionError(f"probe_device_time: no {name} window")
    d = res["fused_encoder_drift"]
    q = res["parity_drift_sweep"]
    log(f"fused_encoder_drift: K3 vs standard AJI mean "
        f"{d['fused_vs_standard']['aji_mean']:.5f} min "
        f"{d['fused_vs_standard']['aji_min']:.5f}; bf16 floor "
        f"{d['floor_standard_vs_float32']['aji_mean']:.5f} min "
        f"{d['floor_standard_vs_float32']['aji_min']:.5f}; parity_drift_sweep"
        f" AJI mean {q['aji_mean']:.5f} min {q['aji_min']:.5f} (the JAX "
        f"package's TPU record {TPU_DRIFT_RECORD[0]}, {TPU_DRIFT_RECORD[1]})")
    if q["aji_min"] < AJI_FLOOR:
        raise AssertionError(f"parity_drift_sweep: AJI {q['aji_min']} below "
                             f"{AJI_FLOOR}")
    for key in BN_BF16_DRIFT["untyped"]:
        log_beside_record(f"fused_encoder_drift (untyped, {d['n_tiles']} "
                          f"tiles) {key}", d[key]["aji_mean"],
                          d[key]["aji_min"], BN_BF16_DRIFT["untyped"][key],
                          card)
    # the K3 pair is K3's only where every fused pass ran K3: one forward
    # batch a 1000^2 tile (49 patches), 4 launches a batch
    log(f"fused_encoder_drift: K3 launches {d['k3_launches']} in "
        f"{d['fused_forward_batches']} fused forward batches over "
        f"{d['n_tiles']} tiles")
    if d["fused_forward_batches"] != d["n_tiles"] \
            or d["k3_launches"] != 4 * d["fused_forward_batches"]:
        raise AssertionError("fused_encoder_drift: the fused passes did not "
                             "all run K3")
    log(f"phase 15 in {time.perf_counter() - t_start:.1f} s: " + ", ".join(
        f"{k} {v:.1f}" for k, v in secs.items()) + f"; K1 launches {k1}, "
        f"K3 launches {k3}")
    if not k1 or not k3:
        raise AssertionError("phase 15 launched no K1 or no K3")
    return k1, k3


# ------------------------------------------------------- original mode

ORIG_SLIDE = 2048   # side of phase 16's WSI pseudo-slide
ORIG_EVAL_IMAGES = 2  # phase 16 (c): the first of phase 12's held-out images
ORIG_SLIDE_NUCLEI = 400  # phase 7's density


def orig_canvases():
    """(the exact patch grid's stitched side, the side the tile path
    runs): a SRC_HW^2 tile takes a 13 x 13 grid of 270^2 patches at a step
    of 80 (1040^2 of outputs), which the tile manager rounds up to its
    canonical class, 14 x 14 (1120^2), as the JAX package does."""
    from hover_net_tpu_torch.data.tiling import (
        bucket_grid_dim,
        prepare_tile_patching,
    )

    grid = int(prepare_tile_patching((SRC_HW, SRC_HW), 270, 80)[2][0])
    return grid * 80, bucket_grid_dim(grid) * 80


def orig_k1(dev):
    """Phase 16 (a): K1 against its plain version on a SRC_HW^2 map of
    synthetic nuclei mirrored over each original-mode canvas with its
    valid mask: identical labels; median times of both; the bound.
    Returns the times at the canvas the tile path runs."""
    import torch

    from hover_net_tpu_torch.ops import post_proc_cuda as k1
    from hover_net_tpu_torch.ops.post_proc_device import energy_inputs

    src = synth_pred(synth_inst(SRC_HW, SRC_HW, N_NUCLEI, 16))
    for canvas in orig_canvases():
        pred, valid = mirrored_canvas(src, canvas)
        blb, sob = energy_inputs(
            torch.from_numpy(np.ascontiguousarray(pred))[None].to(dev),
            torch.from_numpy(valid)[None].to(dev))
        got = k1.proc_tail(blb, sob)
        want = k1.proc_tail_reference(blb, sob)
        n_diff = int((got != want).sum())
        n_inst = len(torch.unique(want)) - 1
        max_err = int((got.long() - want.long()).abs().max())
        ms = median_ms(lambda: k1.proc_tail(blb, sob), 20)
        plain_ms = median_ms(lambda: k1.proc_tail_reference(blb, sob), 5)
        b = bound(tensor_bytes(blb, sob, got))
        log(f"(a) K1 vs plain at {tuple(blb.shape)}: {n_inst} instances, "
            f"{n_diff} labels differ; kernel {ms:.3f} ms, plain "
            f"{plain_ms:.3f} ms (median, CUDA events); bound "
            f"{b[0] * 1e3:.2f} us ({b[1]})")
        if n_diff or n_inst < 100:
            raise AssertionError(f"K1 disagrees with its plain version at "
                                 f"{canvas}^2, or found too few nuclei")
    return {"ms": ms, "plain_ms": plain_ms, "max_abs_err": max_err,
            "bound": b}


def orig_training(work, device):
    """Phase 16 (b): cli/run_train at TrainConfig's defaults (original
    mode, 5 types, width 64, the two default phases), one epoch each, on
    phase 11's 540^2 patches, with phase 11's checks; one original-mode
    w8 step on the card against the CPU, body in float64. Returns (the
    last phase's `.tar`, the model's width)."""
    from hover_net_tpu_torch.config import TrainConfig

    root = os.path.join(work, "orig", "train")
    os.makedirs(root)
    patches = os.path.join(work, "train", "patches")
    cfg_path = os.path.join(root, "config.py")
    with open(cfg_path, "w") as f:
        f.write(
            "from hover_net_tpu_torch.config import TrainConfig\n"
            f"config = TrainConfig(log_dir={os.path.join(root, 'logs')!r}, "
            f"train_dir_list=[{os.path.join(patches, 'train')!r}], "
            f"valid_dir_list=[{os.path.join(patches, 'valid')!r}])\n"
            "for phase in config.phases:\n"
            "    phase.nr_epochs = 1\n")
    cfg = TrainConfig()
    log(f"(b) TrainConfig defaults: model_mode {cfg.model_mode}, nr_types "
        f"{cfg.nr_types}, width {cfg.width}, act {cfg.act_shape}, out "
        f"{cfg.out_shape}, batches "
        f"{[p.batch_size['train'] for p in cfg.phases]}")
    tars, _ = run_default_phases(root, cfg_path, cfg.model_mode, cfg.width,
                                 device)
    train_cpu_vs_cuda(os.path.join(patches, "valid"), cfg.model_mode,
                      STEP_CASES[:1])
    return tars[1], cfg.width


STAT_PREFIX = "["  # compute_stats prints its means as one numpy array line


def orig_eval(work, tar, width, device):
    """Phase 16 (c): cli/eval_consep on ORIG_EVAL_IMAGES of phase 12's
    held-out images in the CoNSeP layout (raw types), original mode,
    width 64, with (b)'s `.tar`;
    K1 held against its plain version on each image's stitched map inside
    the run; then the json pipeline once more on the warm manager for the
    tile's device split and tiles/s. Returns K1's launches."""
    import contextlib
    import io

    from hover_net_tpu_torch.cli import eval_consep
    from hover_net_tpu_torch.cli.probe_device_time import forward_flops
    from hover_net_tpu_torch.infer import steps
    from hover_net_tpu_torch.ops import post_proc_cuda as k1

    consep = os.path.join(work, "orig", "CoNSeP")
    names = [f"img{i}" for i in range(ORIG_EVAL_IMAGES)]
    for sub in ("Images", "Labels"):
        src = os.path.join(work, "eval", "consep", sub)
        os.makedirs(os.path.join(consep, "Test", sub))
        for f in sorted(os.listdir(src)):
            if os.path.splitext(f)[0] in names:
                shutil.copy(os.path.join(src, f),
                            os.path.join(consep, "Test", sub))
    canvas = orig_canvases()[1]
    n_patches = (canvas // 80) ** 2
    compared = []

    def k1_and_plain(blb, sob, **kw):
        got = k1.proc_tail(blb, sob, **kw)
        compared.append((tuple(blb.shape), int(
            (got != k1.proc_tail_reference(blb, sob)).sum())))
        return got

    out = os.path.join(work, "orig", "eval_out")
    argv = [consep, tar, out, "original", str(width), "--device", device]
    log(f"$ python -m hover_net_tpu_torch.cli.eval_consep {' '.join(argv)}")
    printed = io.StringIO()
    steps.proc_tail = k1_and_plain
    k1.proc_tail.launches = 0
    try:
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(printed):
            res = eval_consep.main(argv)
        secs = time.perf_counter() - t0
    finally:
        steps.proc_tail = k1.proc_tail
    launches = k1.proc_tail.launches
    lines = printed.getvalue().splitlines()
    for line in lines:
        log(f"eval_consep | {line}")
    stats = [line for line in lines if line.startswith(STAT_PREFIX)]
    log(f"(c) eval_consep: {ORIG_EVAL_IMAGES} images of {SRC_HW}^2 "
        f"({n_patches} patches of 270^2 each, a {canvas}^2 canvas) in "
        f"{secs:.3f} s; K1 launches {launches}; "
        f"K1 vs plain on each stitched map {compared}")
    if launches != ORIG_EVAL_IMAGES or len(compared) != ORIG_EVAL_IMAGES \
            or any(n for _, n in compared) \
            or any(shape != (1, canvas, canvas) for shape, _ in compared):
        raise AssertionError("eval_consep: K1 did not run once an image, or "
                             "disagrees with its plain version")
    for n in names:
        for sub, ext in (("json", "json"), ("mat", "mat"), ("true", "mat")):
            if not os.path.exists(os.path.join(out, sub, f"{n}.{ext}")):
                raise AssertionError(f"eval_consep wrote no {sub}/{n}.{ext}")
    if len(stats) != 2 or not np.all(np.isfinite(res["instance"])):
        raise AssertionError(f"eval_consep printed {stats}")

    mgr = res["manager"]
    k1.proc_tail.launches = 0
    t0 = time.perf_counter()
    written = mgr.process_file_list(os.path.join(consep, "Test", "Images"),
                                    os.path.join(work, "orig", "tile_json"),
                                    save_format="json")
    wall = time.perf_counter() - t0
    launches += k1.proc_tail.launches
    if written != ORIG_EVAL_IMAGES or k1.proc_tail.launches != ORIG_EVAL_IMAGES:
        raise AssertionError("the warm json run did not write every image "
                             "through K1")
    split = {k: statistics.median(t.get(k, float("nan"))
                                  for t in mgr.timings[-ORIG_EVAL_IMAGES:])
             for k in ("forward", "energy", "post_proc_tail", "tables",
                       "finalize_ms")}
    nuclei = [t["n_nuclei"] for t in mgr.timings[-ORIG_EVAL_IMAGES:]]
    flops = forward_flops(mgr.model, n_patches)[0]
    log(f"(c) original-mode tile, warm json pipeline: {ORIG_EVAL_IMAGES / wall:.3f}"
        f" tiles/s ({wall:.3f} s for {ORIG_EVAL_IMAGES}); per tile (median, ms): "
        f"forward over {n_patches} patches {split['forward']:.3f} "
        f"({flops / 1e12:.2f} TFLOP by FlopCounterMode, "
        f"{flops / split['forward'] / 1e9:.1f} TFLOP/s), energy "
        f"{split['energy']:.3f}, K1 {split['post_proc_tail']:.3f}, tables "
        f"{split['tables']:.3f}, host finalize {split['finalize_ms']:.3f}; "
        f"nuclei {nuclei}")
    return launches


def orig_wsi(work, tar, width, device):
    """Phase 16 (d): WSIInferManager in original mode (5 types, width 64,
    bf16) with (b)'s `.tar` on an ORIG_SLIDE^2 pseudo-slide built as phase
    7 builds its slide: K1 once per window batch, the json written, a
    second call skips the slide. Returns K1's launches."""
    import cv2

    from hover_net_tpu_torch.infer.wsi import WSIInferManager
    from hover_net_tpu_torch.ops.post_proc_cuda import proc_tail

    root = os.path.join(work, "orig", "wsi")
    dirs = {k: os.path.join(root, k) for k in ("slides", "masks", "out")}
    for d in dirs.values():
        os.makedirs(d)
    inst = synth_inst(ORIG_SLIDE, ORIG_SLIDE, ORIG_SLIDE_NUCLEI, seed=17)
    img = np.full((ORIG_SLIDE, ORIG_SLIDE, 3), (230, 200, 220), np.uint8)
    img[inst > 0] = (120, 60, 150)
    noise = np.random.default_rng(17).integers(0, 20, img.shape, np.uint8)
    np.save(os.path.join(dirs["slides"], "slide.npy"), img - noise)
    cv2.imwrite(os.path.join(dirs["masks"], "slide.png"),
                np.full((ORIG_SLIDE // 16,) * 2, 255, np.uint8))
    mgr = WSIInferManager(
        model_path=tar, mode="original", nr_types=5, width=width,
        batch_size=K3_BATCH, device=device, chunk_shape=ORIG_SLIDE // 2,
        tile_shape=ORIG_SLIDE // 2, ambiguous_size=128, proc_mag=40,
        type_info_path=os.path.join(ROOT, "type_info.json"),
        cache_path=os.path.join(root, "cache"))
    out = os.path.join(dirs["out"], "slide.json")
    proc_tail.launches = 0
    t0 = time.perf_counter()
    written = mgr.process_wsi_list(dirs["slides"], dirs["out"],
                                   input_mask_dir=dirs["masks"])
    wall = time.perf_counter() - t0
    launches = proc_tail.launches
    if written != 1 or not os.path.exists(out):
        raise AssertionError("the original-mode WSI run wrote no json")
    with open(out) as f:
        n_nuc = len(json.load(f)["nuc"])
    log(f"(d) wsi (original, typed): {ORIG_SLIDE}^2 slide in {wall:.3f} s "
        f"wall: {mgr.n_forward_batches} forward batches of <= "
        f"{mgr.batch_size} patches of 270^2, {mgr.n_window_batches} "
        f"post-proc window batches, {n_nuc} nuclei; K1 launches {launches}; "
        "seconds " + ", ".join(f"{k} {v:.3f}"
                               for k, v in mgr.timings["slide"].items()))
    if launches != mgr.n_window_batches or launches == 0 \
            or mgr.n_forward_batches == 0:
        raise AssertionError(f"K1 ran {launches} times for "
                             f"{mgr.n_window_batches} window batches")
    mtime = os.path.getmtime(out)
    if mgr.process_wsi_list(dirs["slides"], dirs["out"]) != 0 \
            or os.path.getmtime(out) != mtime:
        raise AssertionError("the second WSI call did not skip the slide")
    log("(d) wsi resume: the second call skipped the written slide")
    return launches


def check_original_mode(work, card, device="cuda"):
    """Phase 16: original mode (270^2 -> 80^2, the JAX package's default
    training configuration) on the card at full width, typed: (a) K1 at
    the original-mode canvas, (b) training at TrainConfig's defaults, (c)
    the CoNSeP recipe (cli/eval_consep), (d) WSI. Returns (K1's launches
    on the path, K1's times at the canvas)."""
    import torch

    t_start = time.perf_counter()
    secs = {}
    k1_res = orig_k1(torch.device(device))
    secs["k1"] = time.perf_counter() - t_start
    t0 = time.perf_counter()
    tar, width = orig_training(work, device)
    torch.cuda.empty_cache()
    secs["training"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches = orig_eval(work, tar, width, device)
    torch.cuda.empty_cache()
    secs["eval_consep"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    launches += orig_wsi(work, tar, width, device)
    torch.cuda.empty_cache()
    secs["wsi"] = time.perf_counter() - t0
    log(f"phase 16 in {time.perf_counter() - t_start:.1f} s: " + ", ".join(
        f"{k} {v:.1f}" for k, v in secs.items())
        + f"; K1 launches {launches} ({card})")
    return launches, k1_res


JAX_MODULES = ("jax", "flax", "optax", "msgpack")
RESUME_PATCHES = {"train": 4, "valid": 2}  # phase 17 (c): one step an epoch
RESUME_EPOCHS = 3   # resumed at epoch 1: epochs 2 and 3


def log_jax_modules():
    """Phase 17 (a): which of the JAX stack's modules this interpreter can
    import and whether any was imported; fails if one was."""
    import importlib.util

    seen = {n: ("imported" if n in sys.modules else
                "installed, not imported" if importlib.util.find_spec(n)
                else "not installed") for n in JAX_MODULES}
    log("JAX stack here: " + ", ".join(f"{n} {s}" for n, s in seen.items()))
    if any(s == "imported" for s in seen.values()):
        raise AssertionError(f"a module of the JAX stack was imported: {seen}")


def msgpack_tile(work, tar, card, device):
    """Phase 17 (b): phase 12's typed recipe `.tar` written as the JAX
    package's `.msgpack` (the port's save_checkpoint over
    jax_from_state_dict), then cli/run_infer tile on phase 12's held-out
    images from the `.tar` and from the `.msgpack`: the same json and
    instance maps, K1 once per image in the `.msgpack` run. Returns
    (K1's launches in that run, its seconds)."""
    import scipy.io as sio

    from hover_net_tpu_torch.cli import run_infer
    from hover_net_tpu_torch.models import checkpoints as ckpt
    from hover_net_tpu_torch.models.hovernet import HoVerNetConfig
    from hover_net_tpu_torch.ops.post_proc_cuda import proc_tail

    root = os.path.join(work, "jax_ckpt")
    cfg = HoVerNetConfig(mode="fast", nr_types=5, width=TRAIN_WIDTH)
    msgpack = os.path.join(root, "net_epoch=400.msgpack")
    t0 = time.perf_counter()
    ckpt.save_checkpoint(msgpack, ckpt.jax_from_state_dict(
        ckpt.load_torch_tar(tar), cfg), extra={"step": 400})
    log(f"(b) {os.path.relpath(msgpack, ROOT)}: "
        f"{os.path.getsize(msgpack) / 2**20:.1f} MiB written in "
        f"{time.perf_counter() - t0:.2f} s")
    img_dir = os.path.join(work, "eval", "consep", "Images")
    out, secs = {}, {}
    for name, path in (("tar", tar), ("msgpack", msgpack)):
        out[name] = os.path.join(root, f"out_{name}")
        argv = ["--model_path", path, "--model_mode", "fast", "--width",
                str(TRAIN_WIDTH), "--nr_types", "5", "--type_info_path",
                os.path.join(ROOT, "type_info.json"), "--device", device,
                "tile", "--input_dir", img_dir, "--output_dir", out[name],
                "--save_format", "all"]
        proc_tail.launches = 0
        t0 = time.perf_counter()
        run_infer.main(argv)
        secs[name] = time.perf_counter() - t0
        launches = proc_tail.launches
        log(f"(b) run_infer tile --model_path {os.path.basename(path)}: "
            f"{EVAL_IMAGES} images in {secs[name]:.3f} s, K1 launches "
            f"{launches}")
    if launches != EVAL_IMAGES:
        raise AssertionError(f"K1 ran {launches} times on {EVAL_IMAGES} "
                             "images from the .msgpack")
    n_nuc = 0
    for i in range(EVAL_IMAGES):
        nuc = {}
        for name in out:
            with open(os.path.join(out[name], "json", f"img{i}.json")) as f:
                nuc[name] = json.load(f)["nuc"]
        inst = [sio.loadmat(os.path.join(out[name], "mat", f"img{i}.mat"))[
            "inst_map"] for name in out]
        if nuc["msgpack"] != nuc["tar"] or not np.array_equal(*inst):
            raise AssertionError(f"img{i}: the .msgpack's instances differ "
                                 "from the .tar's")
        n_nuc += len(nuc["tar"])
    log(f"(b) .msgpack == .tar: {n_nuc} nuclei over {EVAL_IMAGES} images, "
        f"json and inst_map identical ({card})")
    return launches, secs["msgpack"]


def resume_from(root, phase_dir, patches, device):
    """cli/run_train --resume on a one-phase config (phase 11's second
    phase: all parameters, batch 4, RESUME_EPOCHS epochs of one step)
    whose log dir is `phase_dir`, under deterministic algorithms. Returns
    (the RunInfo, its seconds)."""
    from hover_net_tpu_torch.cli import recipe, run_train

    cfg_path = os.path.join(root, os.path.basename(phase_dir) + ".py")
    with open(cfg_path, "w") as f:
        f.write(
            "from hover_net_tpu_torch.config import PhaseConfig, TrainConfig\n"
            f"config = TrainConfig(model_mode='fast', nr_types=5, "
            f"width={TRAIN_WIDTH}, log_dir={phase_dir!r}, debug=True, "
            f"train_dir_list=[{patches['train']!r}], "
            f"valid_dir_list=[{patches['valid']!r}], phases=[PhaseConfig("
            f"batch_size={{'train': 4, 'valid': 2}}, "
            f"nr_epochs={RESUME_EPOCHS})])\n")
    t0 = time.perf_counter()
    with recipe.deterministic_training():
        infos = run_train.main(["--config", cfg_path, "--device", device,
                                "--resume"])
    return infos[0], time.perf_counter() - t0


def msgpack_resume(work, train_tar, card, device):
    """Phase 17 (c): a phase directory holding only `net_epoch=1.msgpack`
    and its `.opt` (the JAX trainer's files), made from phase 11's second
    phase's `.tar` (weights, Adam state, step), and one holding that
    `.tar`; cli/run_train --resume on each for two steps (two epochs of
    one batch) under deterministic algorithms. Every loss finite, the
    step going on from the msgpack's extra["step"], the port's
    `net_epoch=2.tar` and `net_epoch=3.tar` written, and the first resumed
    update (epoch 2's parameters less epoch 1's) of the `.msgpack` resume
    equal to the `.tar` resume's within float32 rounding (one ulp of the
    tensor's largest parameter). Returns the seconds of the `.msgpack`
    resume."""
    import torch

    from hover_net_tpu_torch.models import checkpoints as ckpt
    from hover_net_tpu_torch.models.hovernet import HoVerNet, HoVerNetConfig

    root = os.path.join(work, "jax_ckpt", "resume")
    patches = {}
    for split, n in RESUME_PATCHES.items():
        src = os.path.join(work, "train", "patches", split)
        patches[split] = os.path.join(root, "patches", split)
        os.makedirs(patches[split])
        for name in sorted(os.listdir(src))[:n]:
            shutil.copy(os.path.join(src, name), patches[split])

    desc, opt_sd, step = ckpt.load_train_tar(train_tar)
    net = HoVerNet(HoVerNetConfig(mode="fast", nr_types=5,
                                  width=TRAIN_WIDTH))
    net.load_state_dict(desc, strict=True)
    opt = torch.optim.Adam(net.parameters())
    opt.load_state_dict(opt_sd)
    dirs = {"msgpack": os.path.join(root, "jax_phase"),
            "tar": os.path.join(root, "port_phase")}
    t0 = time.perf_counter()
    ckpt.save_train_msgpack(os.path.join(dirs["msgpack"],
                                         "net_epoch=1.msgpack"),
                            net, opt, step)
    log(f"(c) phase 11's net_epoch=1.tar (step {step}) as the JAX trainer's "
        f"net_epoch=1.msgpack + .opt in {time.perf_counter() - t0:.2f} s: "
        + ", ".join(f"{n} {os.path.getsize(os.path.join(dirs['msgpack'], n))
                                 / 2**20:.1f} MiB"
                    for n in sorted(os.listdir(dirs["msgpack"]))))
    os.makedirs(dirs["tar"])
    shutil.copy(train_tar, dirs["tar"])

    infos, secs, after = {}, {}, {}
    for name, d in dirs.items():
        infos[name], secs[name] = resume_from(root, d, patches, device)
        info = infos[name]
        saved = [torch.load(os.path.join(d, f"net_epoch={e}.tar"),
                            map_location="cpu", weights_only=True)
                 for e in (2, 3)]
        log(f"(c) run_train --resume from {name} in {secs[name]:.1f} s: "
            f"losses {[round(v, 5) for v in info.losses]}, step {step} -> "
            f"{info.train_state.step}, saved steps "
            f"{[s['step'] for s in saved]}")
        if (len(info.losses) != RESUME_EPOCHS - 1
                or not np.all(np.isfinite(info.losses))
                or info.train_state.step != step + RESUME_EPOCHS - 1
                or [s["step"] for s in saved] != [step + 1, step + 2]):
            raise AssertionError(f"the resume from the {name} went wrong")
        after[name] = saved[0]["desc"]
    _, _, msg_step = ckpt.load_train_msgpack(
        os.path.join(dirs["msgpack"], "net_epoch=1.msgpack"), net)
    if msg_step != step:
        raise AssertionError(f"the .msgpack's step {msg_step}, not {step}")

    worst, n_equal, names = 0.0, 0, [n for n, _ in net.named_parameters()]
    for key in names:
        start = desc[key].float()
        upd = {k: v[key].float() - start for k, v in after.items()}
        ulp = float(np.spacing(np.float32(max(
            float(after["tar"][key].abs().max()), float(start.abs().max())))))
        diff = float((upd["msgpack"] - upd["tar"]).abs().max())
        worst = max(worst, diff / ulp)
        n_equal += torch.equal(after["msgpack"][key], after["tar"][key])
        if not upd["tar"].abs().max() > 0:
            raise AssertionError(f"{key}: the resumed step left it as it was")
    log(f"(c) first resumed update, .msgpack vs .tar: {n_equal} of "
        f"{len(names)} parameters bit-identical, largest difference "
        f"{worst:.3f} ulp of the tensor's largest parameter (bound 1) "
        f"({card})")
    if worst > 1.0:
        raise AssertionError("the .msgpack resume's first update differs "
                             "from the .tar resume's")
    return secs["msgpack"]


def convert_round_trip(work, tar, card):
    """Phase 17 (d): phase 12's typed recipe `.tar` through the port's
    cli/convert_chkpt (the JAX CLI's arguments) to the JAX package's
    `.msgpack`: `load_model_state` of the `.msgpack` equals that of the
    `.tar` on every tensor (the `.tar` has num_batches_tracked besides);
    then the `.msgpack`'s variables written back as a reference `.tar`
    (`save_torch_tar`, keys prefixed 'module.') reload equal to the
    original. Returns its seconds."""
    import torch

    from hover_net_tpu_torch.cli import convert_chkpt
    from hover_net_tpu_torch.models import checkpoints as ckpt
    from hover_net_tpu_torch.models.hovernet import HoVerNetConfig

    root = os.path.join(work, "jax_ckpt", "convert")
    os.makedirs(root, exist_ok=True)
    cfg = HoVerNetConfig(mode="fast", nr_types=5, width=TRAIN_WIDTH)
    msgpack = os.path.join(root, "recipe_typed.msgpack")
    back = os.path.join(root, "recipe_typed_back.tar")
    t0 = time.perf_counter()
    convert_chkpt.main(["--input", tar, "--output", msgpack, "--mode",
                        "fast", "--nr_types", "5"])
    t_convert = time.perf_counter() - t0
    want = ckpt.load_model_state(tar, cfg)
    variables, extra = ckpt.load_checkpoint(msgpack)
    ckpt.save_torch_tar(back, variables, cfg)
    secs = time.perf_counter() - t0
    prefixed = all(k.startswith("module.") for k in torch.load(
        back, map_location="cpu", weights_only=True)["desc"])
    off = {}
    for name, got in (("msgpack", ckpt.load_model_state(msgpack, cfg)),
                      ("back", ckpt.load_torch_tar(back))):
        lost = set(want) - set(got)
        off[name] = sorted(k for k in got if k not in want
                           or not torch.equal(got[k], want[k]))
        off[name] += sorted(k for k in lost
                            if not k.endswith("num_batches_tracked"))
    log(f"(d) cli/convert_chkpt {os.path.basename(tar)} -> "
        f"{os.path.relpath(msgpack, ROOT)} ("
        f"{os.path.getsize(msgpack) / 2**20:.1f} MiB) in {t_convert:.2f} s, "
        f"extra {extra}; back through save_torch_tar ('module.' keys: "
        f"{prefixed}) in {secs:.2f} s in all; tensors off: .msgpack "
        f"{len(off['msgpack'])}, back {len(off['back'])} of {len(want)} "
        f"({card})")
    if off["msgpack"] or off["back"] or not prefixed \
            or extra["nr_types"] != 5:
        raise AssertionError(f"convert_chkpt round trip: {off}")
    return secs


def check_jax_checkpoints(work, eval_tar, train_tar, card, device="cuda"):
    """Phase 17: the JAX package's checkpoint format on the card, without
    flax: (a) the JAX stack is not imported, (b) cli/run_infer tile on a
    `.msgpack` of phase 12's recipe against its `.tar`, (c) run_train
    --resume of a phase whose last checkpoint is a JAX `.msgpack` and
    `.opt` against the same phase resumed from its `.tar`, (d) the `.tar`
    through cli/convert_chkpt and back through save_torch_tar. Returns
    K1's launches in (b)'s `.msgpack` run."""
    import torch

    t_start = time.perf_counter()
    log_jax_modules()
    launches, tile_s = msgpack_tile(work, eval_tar, card, device)
    torch.cuda.empty_cache()
    resume_s = msgpack_resume(work, train_tar, card, device)
    torch.cuda.empty_cache()
    convert_s = convert_round_trip(work, eval_tar, card)
    log(f"phase 17 in {time.perf_counter() - t_start:.1f} s: tile from the "
        f".msgpack {tile_s:.1f}, resume from the .msgpack {resume_s:.1f}, "
        f"convert and back {convert_s:.1f}; K1 launches {launches} ({card})")
    return launches


def main():
    import logging

    import torch

    if not torch.cuda.is_available():
        sys.exit("chip_smoke: no CUDA device")
    logging.basicConfig(
        level=logging.INFO,
        format="|%(asctime)s.%(msecs)03d| [%(levelname)s] %(message)s",
        datefmt="%Y-%m-%d|%H:%M:%S")
    t_main = time.perf_counter()
    lap = Laps()
    dev = torch.device("cuda")
    card = card_line()
    log(f"device: {torch.cuda.get_device_name(0)} ({card}), torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")
    lap("1")

    finish_k3 = build_kernels()
    lap("2")

    k1 = check_kernel(dev)
    lap("3")

    work = os.path.join(ROOT, "build", "chip_smoke")
    shutil.rmtree(work, ignore_errors=True)
    os.makedirs(work)
    guard_bn_float32()
    _, k3_slice, mgr = run_slice(work)
    # every slot of this one-card run is cuda:0 and shares the loaded
    # model, so a replica is made on the host to show model_on's copy
    mgr.model_on(torch.device("cpu"))
    mgr._replicas.clear()
    lap("4")
    check_forward(mgr)
    finalize_real_nuclei(mgr, k1["canvas"])
    del mgr, k1["canvas"]
    torch.cuda.empty_cache()
    lap("5")

    from hover_net_tpu_torch.infer.wsi import WSIInferManager

    finish_k3()
    tar, dirs = make_wsi_inputs(work)
    wsi_mgr = WSIInferManager(
        model_path=tar, mode="fast", nr_types=None, width=64,
        batch_size=K3_BATCH, device="cuda", chunk_shape=2048,
        tile_shape=2048, ambiguous_size=128, proc_mag=40,
        cache_path=os.path.join(work, "wsi_cache"))
    k3 = check_k3(wsi_mgr.model)
    check_fused_forward(wsi_mgr.model)
    torch.cuda.empty_cache()
    lap("6")
    k3_launches, k1_launches = run_wsi(wsi_mgr, dirs)
    k3_launches += k3_slice
    lap("7")
    k1_wsi = wsi_real_nuclei(wsi_mgr, work)
    del wsi_mgr
    torch.cuda.empty_cache()
    lap("8")

    from hover_net_tpu_torch.cli.probe_pp_stages import canvas_inputs

    canvas = canvas_inputs(SRC_HW, dev)
    k2 = check_k2(dev, canvas)
    lap("9")
    k4 = check_k4(canvas)
    del canvas
    torch.cuda.empty_cache()
    lap("10")

    untyped = UntypedRecipe()
    train_tar = check_training(work)
    torch.cuda.empty_cache()
    lap("11")
    from hover_net_tpu_torch.cli import recipe

    t0 = time.perf_counter()
    eval_tar = recipe.train_e2e_checkpoint(nr_types=5)
    lap.part("12 recipe", time.perf_counter() - t0)
    log_sha256("phase 12 checkpoint (the typed recipe of cli/recipe.py)",
               eval_tar, time.perf_counter() - t0, RECIPE_SHA256["typed"])
    check_evaluation(work, eval_tar)
    torch.cuda.empty_cache()
    lap.part("15 recipe, from phase 11 on", untyped.join())
    lap("12")
    k1_mesh, k3_mesh = check_multi_device(work, dirs, card)
    k1_launches += k1_mesh
    k3_launches += k3_mesh
    lap("13")
    check_multi_device_training(work, card, parts=lap.part)
    lap("14")
    k1_m, k3_m = check_measurement(work, card, parts=lap.part)
    k1_launches += k1_m
    k3_launches += k3_m
    lap("15")
    k1_o, _ = check_original_mode(work, card)
    k1_launches += k1_o
    lap("16")
    k1_launches += check_jax_checkpoints(work, eval_tar, train_tar, card)
    lap("17")
    log_bn_checked("all phases")
    if not all(BN_CHECKED.values()):
        raise AssertionError(f"a kind of model went unchecked: {BN_CHECKED}")

    def entry(name, source, replaces, launches, res):
        return {"name": name, "route": "cuda",
                "source": f"hover_net_tpu_torch/csrc/{source}",
                "replaces": replaces, "launches": launches,
                "max_abs_err": res["max_abs_err"], "ms": res["ms"],
                "plain_ms": res["plain_ms"], "bound_ms": res["bound"][0],
                "bound_by": res["bound"][1],
                "library_ms": res.get("library_ms")}

    k1_wsi["max_abs_err"] = max(k1["max_abs_err"], k1_wsi["max_abs_err"])
    kernels = [
        entry("post_proc_tail", "post_proc_tail.cu",
              "hover_net_tpu/ops/post_proc_pallas.py:272", k1_launches,
              k1_wsi),
        entry("fused_block", "fused_block.cu",
              "hover_net_tpu/models/encoder_pallas.py:220", k3_launches, k3),
        entry("watershed", "post_proc_tail.cu",
              "hover_net_tpu/ops/watershed_pallas.py:69", k2["launches"], k2),
        entry("post_proc_stages", "post_proc_tail.cu",
              "scripts/probe_pp_stages.py:73", k4["launches"], k4),
    ]
    total = time.perf_counter() - t_main
    log(f"chip_smoke: all phases in {total:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"phase_seconds": lap.phases, "parts": lap.parts,
                      "total_s": round(total, 1)}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))


class Laps:
    """The run's seconds by phase: `lap(name)` closes phase `name` (its
    seconds since the last lap); `part(name, s)` notes a part of a phase
    (a recipe's training, a spawn of ranks)."""

    def __init__(self):
        self.t = time.perf_counter()
        self.phases, self.parts = {}, {}

    def __call__(self, name):
        now = time.perf_counter()
        self.phases[name] = round(now - self.t, 1)
        self.t = now

    def part(self, name, secs):
        self.parts[name] = round(secs, 1)


def child_pids():
    """The pids of this process's live children, from /proc."""
    pids = []
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                fields = f.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == os.getpid():
            pids.append(int(name))
    return pids


def stop_children():
    """Ends every process the run started, on success and on failure:
    the training loader's forkserver and multiprocessing's resource
    tracker outlive their work (each lives until its parent exits and
    only then sees its pipe close), so they are stopped here and
    reaped; any other child left is ended and reaped too."""
    import signal
    from multiprocessing import forkserver, resource_tracker

    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()
    for pid in child_pids():
        print(f"chip_smoke: stopping child process {pid}", file=sys.stderr,
              flush=True)
        try:
            os.kill(pid, signal.SIGTERM)
            os.waitpid(pid, 0)
        except (ProcessLookupError, ChildProcessError):
            pass


if __name__ == "__main__":
    use_bytecode_cache()
    try:
        main()
    finally:
        stop_children()
