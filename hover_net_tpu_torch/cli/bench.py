"""Benchmark of the tile path: 1000^2 tiles a second through the tile
CLI's own pipeline, on one CUDA card.

Counterpart of bench.py at the repository root (the JAX package's
benchmark), with its synthetic data, its trained checkpoint and its
readouts:

    python -m hover_net_tpu_torch.cli.bench
    python -m hover_net_tpu_torch.cli.bench --device cpu --width 8 \
        --size 200 --iters 1 --reps 1 --model_path m.tar

- `synth_nuclei_image` and `synth_pred_map`: bench.py's synthetic H&E
  tile (dark-purple disks on a light background) and prediction map,
  unchanged;
- `train_e2e_checkpoint`: bench.py's `_train_e2e_checkpoint` with the
  port's train step: width 64, fast mode, untyped (or `nr_types` with
  each instance's type drawn from the same rng), 400 steps at batch 8,
  Adam at 3e-4, batches drawn from one seeded rng (their tiles by
  worker processes while the step runs: data/synthetic.py), weights
  from a seeded `torch.Generator`, float32 on deterministic cuDNN and
  cuBLAS algorithms (`deterministic_training`), so that every run on a
  card gives the same weights. The `.tar` is cached under
  build/hover_net_tpu_torch/bench/, keyed by a hash of the recipe's
  arguments and of the files whose code trains it (`RECIPE_SOURCES`): the
  first run trains it (70-95 s on an NVIDIA H100 80GB HBM3, 700.00 W),
  later runs load it;
- the headline `e2e_real_content`: tiles/s of `run_infer tile
  --save_format json` on one pre-decoded 1000^2 nuclei tile: dispatch on
  the main thread, finalize from the device tables and the json write on
  one worker thread, 3 tiles in flight; the median (and the best) of 5
  reps of 8 tiles, and `e2e_n_instances`;
- `e2e_multi_image`: 5 distinct tiles read and png-decoded inside the
  timed loop, median of 3 reps;
- device ms per tile: the sum of the tile pipeline's CUDA-event stages
  (`steps.STAGES` of a `steps.StageEvents`), the median over warm tiles,
  each stage and the forward's encoder and decoders parts named; the
  forward's FLOPs from `torch.utils.flop_counter.FlopCounterMode` and the
  pipeline's MFU against the H100's 989 TFLOP/s dense bf16 peak;
- `proxy_1kx1k_tiles_per_sec`: bench.py's first headline (patch gather,
  forward, stitch and K1 on a synthetic prediction stack in one call, the
  int32 map pulled, 3 tiles in flight, best of 3 reps);
- one typed tile (nr_types=5, weights as `entry()` builds them), whose
  typed tables stage shows in the line.

Differences from bench.py: no `vs_baseline` (its north-star rate is a
TPU figure); no lax.scan K-delta (the pipeline's CUDA events give device
time); no fallback: any failure raises and the run exits non-zero. The
line adds the card's name and power limit and the checkpoint's sha256.
On `--device cpu` the times are host-clock times of the plain versions
and the device columns read null.
"""

from __future__ import annotations

import argparse
import contextlib
import copy
import functools
import hashlib
import json
import os
import shutil
import statistics
import subprocess
import tempfile
import time
from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, Optional, Sequence

import cv2
import numpy as np
import torch

from ..data.synthetic import (
    pooled_recipe_batches,
    recipe_batches,  # noqa: F401 (bench's name for the recipe's batches)
    synth_nuclei_image,
)
from ..data.tiling import bucket_grid_dim, prepare_tile_patching
from ..data.train_pipeline import device_prefetch
from ..infer.base import resolve_device
from ..infer.steps import (
    STAGES,
    StageEvents,
    assemble_grid,
    extract_patches,
    infer_output,
)
from ..models.checkpoints import load_torch_tar, save_train_tar
from ..models.hovernet import HoVerNet, HoVerNetConfig
from ..ops.nvcc_build import BUILD_DIR
from ..ops.post_proc_device import proc_np_hv_batch
from ..ops.targets import gen_instance_hv_map
from ..parallel.train_parallel import (
    init_train_state,
    make_optimizer,
    make_train_step,
)

BENCH_DIR = os.path.join(BUILD_DIR, "bench")
# dense bf16 tensor-core peak of one H100 SXM (NVIDIA data sheet): the
# peak of PERF.md's kernel bounds
BF16_PEAK_FLOPS = 989e12
RECIPE_LR = 3e-4
# the package's files whose code trains the recipe's checkpoint: a change
# to any of them changes the cache key, so a cached `.tar` is always the
# current code's
RECIPE_SOURCES = ("cli/bench.py", "parallel/train_parallel.py",
                  "models/hovernet.py", "models/blocks.py", "ops/losses.py",
                  "ops/targets.py", "data/train_pipeline.py",
                  "models/checkpoints.py", "utils/crops.py",
                  "data/synthetic.py")
# worker processes that draw the recipe's tiles while the step runs (its
# host work, ~170 ms a batch of 8 in one process, would hold the step)
RECIPE_WORKERS = 4
# bench.py's repetitions of the secondary readouts: the multi-image rate
# (median of 3 reps of 10 tiles), the proxy (best of 3 reps of 10 tiles),
# and the warm tiles of the device-time median
MULTI_ITERS, MULTI_REPS = 10, 3
PROXY_ITERS, PROXY_REPS = 10, 3
DEVICE_TILES = 10
TYPE_INFO = {0: ("nolabe", (0, 0, 0)), 1: ("neopla", (255, 0, 0)),
             2: ("inflam", (0, 255, 0)), 3: ("connec", (0, 0, 255)),
             4: ("necros", (255, 255, 0)), 5: ("no-neo", (255, 165, 0))}


def synth_pred_map(h, w, n_nuclei=1200, seed=0):
    """Nuclei-like NP+HV prediction stack for post-proc timing."""
    rng = np.random.default_rng(seed)
    inst = np.zeros((h, w), np.int32)
    yy, xx = np.mgrid[-12:13, -12:13]
    k = 1
    for _ in range(n_nuclei):
        cy, cx = rng.integers(14, h - 14), rng.integers(14, w - 14)
        r = rng.integers(5, 11)
        m = (yy**2 + xx**2) <= r * r
        sub = inst[cy - 12 : cy + 13, cx - 12 : cx + 13]
        sub[m & (sub == 0)] = k
        k += 1
    hv = gen_instance_hv_map(inst, inst.shape)
    return np.dstack([(inst > 0).astype(np.float32), hv[..., 0], hv[..., 1]])


# ------------------------------------------------------------ checkpoint

@contextlib.contextmanager
def deterministic_training():
    """Inside the block: cuDNN and cuBLAS on deterministic algorithms
    (`torch.use_deterministic_algorithms`, which makes any op without a
    deterministic version raise; cudnn.benchmark off), cuDNN's
    convolutions in TF32 and cuBLAS's matmuls in float32, PyTorch's
    defaults. TF32 is itself deterministic; with TF32 off cuDNN's
    deterministic backward-data kernel `dgrad2d_alg1_1` alone takes 77 ms
    a call, and the recipe's step 908 ms against 150 ms at batch 8
    (NVIDIA H100 80GB HBM3, 700.00 W). The global flags and
    CUBLAS_WORKSPACE_CONFIG are restored afterwards."""
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32, torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    det = (torch.are_deterministic_algorithms_enabled(),
           torch.is_deterministic_algorithms_warn_only_enabled())
    env = os.environ.get("CUBLAS_WORKSPACE_CONFIG")
    if env is None:
        os.environ["CUBLAS_WORKSPACE_CONFIG"] = ":4096:8"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = True
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.use_deterministic_algorithms(True)
    try:
        yield
    finally:
        (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32,
         torch.backends.cudnn.deterministic,
         torch.backends.cudnn.benchmark) = flags
        torch.use_deterministic_algorithms(det[0], warn_only=det[1])
        if env is None:
            os.environ.pop("CUBLAS_WORKSPACE_CONFIG", None)


def state_sha256(state: Dict[str, torch.Tensor]) -> str:
    """sha256 over a state dict's keys, dtypes and bytes, in key order."""
    h = hashlib.sha256()
    for k in sorted(state):
        t = state[k].detach().cpu().contiguous()
        h.update(k.encode())
        h.update(str(t.dtype).encode())
        h.update(t.numpy().tobytes())
    return h.hexdigest()


def checkpoint_sha256(path: str) -> str:
    """`state_sha256` of a `.tar`'s state dict, computed once per file
    version in this process (each measurement CLI prints the cached
    recipe's; reading a trainer `.tar` takes seconds)."""
    st = os.stat(path)
    return _checkpoint_sha256(os.path.abspath(path), st.st_mtime_ns,
                              st.st_size)


@functools.lru_cache(maxsize=8)
def _checkpoint_sha256(path: str, mtime_ns: int, size: int) -> str:
    return state_sha256(load_torch_tar(path))


def recipe_sources_sha256() -> str:
    """sha256 over the bytes of RECIPE_SOURCES, in order."""
    pkg = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    h = hashlib.sha256()
    for rel in RECIPE_SOURCES:
        with open(os.path.join(pkg, rel), "rb") as f:
            h.update(rel.encode())
            h.update(f.read())
    return h.hexdigest()


def train_e2e_checkpoint(steps=400, batch=8, seed=0, width=64, nr_types=None,
                         device="cuda", ckpt_dir: Optional[str] = None) -> str:
    """Path of the recipe's `.tar` (see the module docstring), trained on
    `device` at the first call and cached in `ckpt_dir` (default
    build/hover_net_tpu_torch/bench/) under a hash of the recipe, the
    device type and the bytes of `RECIPE_SOURCES`; a later call with the
    same recipe and code trains nothing and returns the cached path.
    Prints the loss every 100 steps, the training's wall and host seconds
    and the state dict's sha256."""
    dev = resolve_device(device)
    recipe = dict(sources=recipe_sources_sha256(), steps=steps, batch=batch,
                  seed=seed, width=width, nr_types=nr_types, lr=RECIPE_LR,
                  mode="fast", device=dev.type, conv="tf32, deterministic")
    key = hashlib.sha256(json.dumps(recipe, sort_keys=True).encode()
                         ).hexdigest()[:16]
    kind = "untyped" if nr_types is None else f"typed{nr_types}"
    path = os.path.join(ckpt_dir or BENCH_DIR, f"e2e_w{width}_{kind}_{key}.tar")
    if os.path.exists(path):
        print(f"# e2e checkpoint (cached): {path}, sha256 "
              f"{checkpoint_sha256(path)}", flush=True)
        return path

    host_s = []
    with deterministic_training():
        model = HoVerNet(HoVerNetConfig(mode="fast", nr_types=nr_types,
                                        width=width),
                         generator=torch.Generator().manual_seed(seed))
        tx, schedule = make_optimizer(lr=RECIPE_LR, step_epochs=10**6,
                                      steps_per_epoch=1)
        state = init_train_state(model, tx, dev)
        step_fn = make_train_step(model, schedule)
        wait_s = []
        t0 = time.perf_counter()
        losses = []
        with contextlib.closing(pooled_recipe_batches(
                seed, batch, steps, nr_types, workers=RECIPE_WORKERS,
                host_s=host_s)) as stream:
            for i, b in enumerate(device_prefetch(stream, dev,
                                                  wait_s=wait_s)):
                state, (terms, _) = step_fn(state, b)
                if i % 100 == 0 or i == steps - 1:
                    losses.append(float(terms["overall_loss"]))
                    print(f"# e2e-ckpt train step {i}: loss="
                          f"{losses[-1]:.4f} "
                          f"({time.perf_counter() - t0:.1f}s)", flush=True)
        wall = time.perf_counter() - t0
    if not np.all(np.isfinite(losses)):
        raise FloatingPointError(f"e2e checkpoint: losses {losses}")
    save_train_tar(path, model, state.optimizer, state.step)
    print(f"# e2e checkpoint: {steps} steps at batch {batch} on {dev} in "
          f"{wall:.1f} s (host batches {sum(host_s):.1f} s in "
          f"{RECIPE_WORKERS} worker processes, waited for "
          f"{sum(wait_s):.1f} s), loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
          f"sha256 {state_sha256(model.state_dict())}; {path}", flush=True)
    return path


def resolve_checkpoint(args, nr_types=None) -> str:
    """`--model_path` when given, else the recipe's checkpoint at
    `--width` on `--device`, cached in `--ckpt_dir`."""
    if args.model_path:
        return args.model_path
    return train_e2e_checkpoint(width=args.width, nr_types=nr_types,
                                device=args.device, ckpt_dir=args.ckpt_dir)


def add_common_args(ap: argparse.ArgumentParser):
    """--device, --width, --model_path, --ckpt_dir: the flags every
    measurement CLI of the port shares."""
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu (the plain versions)")
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--model_path", default=None,
                    help="a .tar to use in place of the trained recipe "
                         "checkpoint")
    ap.add_argument("--ckpt_dir", default=BENCH_DIR,
                    help="cache of the recipe checkpoints")


def card_line(device) -> str:
    """`nvidia-smi`'s name and power limit of the card (every time is
    stated beside it), or a note that the host clock timed the CPU."""
    dev = torch.device(device)
    if dev.type != "cuda":
        return "cpu (host clock, plain versions)"
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={dev.index or 0}"],
        capture_output=True, text=True, check=True)
    return res.stdout.strip().splitlines()[0]


# ------------------------------------------------------------ tile bench

def e2e_manager(model_path, nr_types=None, width=64, dtype=torch.bfloat16,
                device="cuda", type_info_path=None):
    """The tile manager of the e2e bench: fast mode, batch 32."""
    from ..infer.tile import TileInferManager

    return TileInferManager(model_path=model_path, mode="fast",
                            nr_types=nr_types, width=width, batch_size=32,
                            dtype=dtype, device=device,
                            type_info_path=type_info_path)


def _finalize_to_json(mgr, img, out_dir, name, dev_out):
    """The CLI's json-mode finalize: instances from the device tables, no
    map pulled, the json written. Returns the nucleus count."""
    pred_map, inst_map, inst_info = mgr.finalize_prediction(
        img, dev_out, pull_pred_map=False, pull_inst_map=False)
    mgr._save_outputs(name, img, pred_map, inst_map, inst_info, out_dir,
                      save_format="json")
    return len(inst_info)


def _pipelined(mgr, images, out_dir, in_flight=3):
    """process_file_list's single-slot pipelining over `images` (a list,
    or callables that read one): dispatch on the main thread, finalize and
    json on one worker thread, in order, `in_flight` images at most
    waiting. Returns the nucleus counts."""
    counts = []
    with ThreadPoolExecutor(max_workers=1) as fin:
        futs = deque()
        for i, img in enumerate(images):
            img = img() if callable(img) else img
            futs.append(fin.submit(_finalize_to_json, mgr, img, out_dir,
                                   f"t{i}", mgr.predict_image_async(img)[0]))
            if len(futs) >= in_flight:
                counts.append(futs.popleft().result())
        while futs:
            counts.append(futs.popleft().result())
    return counts


def bench_e2e_real_content(mgr, size=1000, iters=8, reps=5, work_dir=None):
    """Tiles/s of the CLI-true json pipeline on the forward's own output
    (one pre-decoded synth_nuclei_image, seed 42). Returns best and
    median tiles/s over `reps` reps of `iters` tiles, the instance count,
    the warm-up's label map (pulled, cropped to the source), and the
    counts seen in the timed reps."""
    img, _ = synth_nuclei_image(size, size, seed=42)
    # warm-up: the label map is pulled once, outside the timed reps
    _, inst_map, info = mgr.finalize_prediction(
        img, mgr.predict_image_async(img)[0])
    out_dir = tempfile.mkdtemp(prefix="e2e_", dir=_work(work_dir))
    os.makedirs(f"{out_dir}/json")
    rates, counts = [], set()
    try:
        for _ in range(reps):
            t0 = time.perf_counter()
            counts.update(_pipelined(mgr, [img] * iters, out_dir))
            rates.append(iters / (time.perf_counter() - t0))
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    rates.sort()
    return {"best": rates[-1], "median": rates[len(rates) // 2],
            "n_instances": len(info), "inst_map": inst_map,
            "counts": sorted(counts)}


def bench_e2e_multi_image(mgr, size=1000, iters=MULTI_ITERS, n_images=5,
                          reps=MULTI_REPS, work_dir=None):
    """Tiles/s of the same pipeline on `n_images` distinct tiles (seeds
    100..), each read and png-decoded inside the timed loop; median of
    `reps` reps."""
    root = tempfile.mkdtemp(prefix="multi_", dir=_work(work_dir))
    out_dir = os.path.join(root, "out")
    os.makedirs(f"{out_dir}/json")
    paths = []
    for k in range(n_images):
        img, _ = synth_nuclei_image(size, size, seed=100 + k)
        paths.append(os.path.join(root, f"tile{k}.png"))
        cv2.imwrite(paths[-1], np.ascontiguousarray(img[..., ::-1]))

    def read(i):
        return lambda: cv2.imread(paths[i % n_images])[..., ::-1]

    rates = []
    try:
        _pipelined(mgr, [read(0)], out_dir)  # warm-up
        for _ in range(reps):
            t0 = time.perf_counter()
            _pipelined(mgr, [read(i) for i in range(iters)], out_dir)
            rates.append(iters / (time.perf_counter() - t0))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    rates.sort()
    return rates[len(rates) // 2]


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


def bench_device_time(mgr, size=1000, tiles=DEVICE_TILES, warm=2):
    """Device ms per tile of the tile pipeline: for each of `tiles` warm
    tiles the sum of its `STAGES` (CUDA events between its stages, read
    after the tile's last event), the median of those sums, and each
    stage's and forward part's median. None on a CPU (no events). Also
    the forward's FLOPs per tile (FlopCounterMode)."""
    coords, grid, canvas = canonical_grid(size, mgr.patch_input_shape,
                                          mgr.patch_output_shape)
    img, _ = synth_nuclei_image(canvas, canvas, seed=7)
    run = mgr._pipeline_for(grid, 0)
    dev = mgr.device
    img_d = torch.from_numpy(img).to(dev)
    coords_d = torch.from_numpy(coords).to(dev)
    runs = []
    for i in range(warm + tiles):
        events = StageEvents(dev)
        run(img_d, coords_d, (size, size), events)
        ms = events.ms()  # waits for the tile's last stage event
        if i >= warm:
            runs.append(ms)
    flops, _ = forward_flops(mgr.model, len(coords))
    if not runs[0]:
        return {"device_ms_per_tile": None, "stage_ms": None,
                "forward_flops_per_tile": flops}
    stages = {k: statistics.median(r[k] for r in runs) for k in runs[0]}
    return {"device_ms_per_tile": statistics.median(
                sum(r[k] for k in STAGES) for r in runs),
            "stage_ms": stages, "forward_flops_per_tile": flops}


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


def bench_proxy(device, width=64, size=1000, iters=PROXY_ITERS,
                reps=PROXY_REPS, in_flight=3):
    """bench.py's first headline: one call a tile of patch gather, forward
    (typed, bf16, timing weights), stitch, and the energy and K1 on a
    synthetic prediction stack of the stitched size, the int32 map
    cropped to the source pulled to the host; `in_flight` tiles in
    flight, best of `reps` reps of `iters` tiles."""
    dev = resolve_device(device)
    cfg = HoVerNetConfig(mode="fast", nr_types=5, width=width,
                         dtype=torch.bfloat16)
    model = fill_synthetic(HoVerNet(cfg)).to(dev).eval()
    win, step = cfg.patch_input_shape, cfg.patch_output_shape
    pads, coords, grid = prepare_tile_patching((size, size), win, step)
    img = np.random.default_rng(0).integers(0, 255, (size, size, 3),
                                            dtype=np.uint8)
    padded = np.pad(img, ((pads[0], pads[1]), (pads[2], pads[3]), (0, 0)),
                    mode="reflect")
    coords_d = torch.from_numpy(coords.astype(np.int64)).to(dev)
    full_h, full_w = grid[0] * step, grid[1] * step
    pred = torch.from_numpy(synth_pred_map(full_h, full_w))[None].to(dev)
    valid = torch.zeros((1, full_h, full_w), dtype=torch.bool, device=dev)
    valid[:, :size, :size] = True

    @torch.no_grad()
    def dispatch():
        patches = extract_patches(torch.from_numpy(padded).to(dev), coords_d,
                                  win)
        full = assemble_grid(infer_output(model, patches), grid)
        inst = proc_np_hv_batch(pred, valid)[0, :size, :size].clone()
        # a reduction of the forward folded into the pulled map, so that
        # the forward's result is used
        anchor = full[..., 1].sum().to(torch.int32)
        inst[0, 0] = torch.maximum(inst[0, 0], anchor * 0)
        return inst

    def pull(t):
        return t.cpu().numpy()

    for _ in range(2):
        pull(dispatch())
    best = 0.0
    for _ in range(reps):
        t0 = time.perf_counter()
        inflight = deque()
        for _ in range(iters):
            inflight.append(dispatch())
            if len(inflight) >= in_flight:
                pull(inflight.popleft())
        while inflight:
            pull(inflight.popleft())
        best = max(best, iters / (time.perf_counter() - t0))
    return best


def bench_typed_tile(device, width=64, size=1000, tiles=3, work_dir=None):
    """One typed 1000^2 tile (nr_types=5, bf16, seeded random weights as
    `entry()` builds them) through the same json pipeline: the median
    wall ms of a tile (dispatch, finalize, json) over `tiles` tiles after
    a warm-up, and each device stage's median ms (None on a CPU)."""
    root = tempfile.mkdtemp(prefix="typed_", dir=_work(work_dir))
    try:
        tar = os.path.join(root, "entry.tar")
        net = HoVerNet(HoVerNetConfig(mode="fast", nr_types=5, width=width),
                       generator=torch.Generator().manual_seed(0))
        torch.save({"desc": net.state_dict()}, tar)
        info_path = os.path.join(root, "type_info.json")
        with open(info_path, "w") as f:
            json.dump({str(k): [n, list(c)] for k, (n, c) in TYPE_INFO.items()},
                      f)
        mgr = e2e_manager(tar, nr_types=5, width=width, device=device,
                          type_info_path=info_path)
        out_dir = os.path.join(root, "out")
        os.makedirs(f"{out_dir}/json")
        img, _ = synth_nuclei_image(size, size, seed=42)
        walls, stages, counts = [], [], []
        for i in range(tiles + 1):
            t0 = time.perf_counter()
            dev_out, events = mgr.predict_image_async(img)
            counts.append(_finalize_to_json(mgr, img, out_dir, f"t{i}",
                                            dev_out))
            if i:
                walls.append((time.perf_counter() - t0) * 1e3)
                stages.append(events.ms())
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return {"wall_ms": statistics.median(walls), "n_instances": counts[-1],
            "stage_ms": ({k: statistics.median(s[k] for s in stages)
                          for k in stages[0]} if stages[0] else None)}


def _work(work_dir):
    d = work_dir or os.path.join(BENCH_DIR, "work")
    os.makedirs(d, exist_ok=True)
    return d


def main(argv: Optional[Sequence[str]] = None) -> dict:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_common_args(ap)
    ap.add_argument("--size", type=int, default=1000)
    ap.add_argument("--iters", type=int, default=8,
                    help="tiles a rep of the headline")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--work_dir", default=None,
                    help="scratch for the json outputs (default under "
                         "--ckpt_dir)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    work = args.work_dir or os.path.join(args.ckpt_dir, "work")
    card = card_line(dev)
    print(f"# {card}", flush=True)

    ckpt = resolve_checkpoint(args)
    mgr = e2e_manager(ckpt, width=args.width, device=dev)
    e2e = bench_e2e_real_content(mgr, args.size, args.iters, args.reps, work)
    multi = bench_e2e_multi_image(mgr, args.size, MULTI_ITERS,
                                  reps=MULTI_REPS, work_dir=work)
    dt = bench_device_time(mgr, args.size, DEVICE_TILES)
    del mgr
    proxy = bench_proxy(dev, args.width, args.size, PROXY_ITERS, PROXY_REPS)
    typed = bench_typed_tile(dev, args.width, args.size, work_dir=work)

    out = {
        "metric": "e2e_1kx1k_tiles_per_sec_per_chip",
        "value": e2e["median"],
        "unit": "tiles/s",
        "e2e_real_content_best": e2e["best"],
        "e2e_n_instances": e2e["n_instances"],
        "e2e_counts_in_reps": e2e["counts"],
        "e2e_method": f"json-cli-true/median-of-{args.reps}",
        "e2e_multi_image": multi,
        "proxy_1kx1k_tiles_per_sec": proxy,
        "device_ms_per_tile": dt["device_ms_per_tile"],
        "device_stage_ms": dt["stage_ms"],
        "forward_flops_per_tile": dt["forward_flops_per_tile"],
        "typed_tile": typed,
        "checkpoint": {"path": os.path.relpath(ckpt),
                       "sha256": checkpoint_sha256(ckpt)},
        "width": args.width, "size": args.size, "device": str(dev),
        "card": card,
    }
    if dt["device_ms_per_tile"]:
        ms = dt["device_ms_per_tile"]
        out["device_tiles_per_sec_ceiling"] = 1000.0 / ms
        # the forward's FLOPs over the tile's whole device time
        out["pipeline_mfu_pct"] = (dt["forward_flops_per_tile"] / (ms / 1e3)
                                   / BF16_PEAK_FLOPS * 100.0)
    print(json.dumps(out), flush=True)
    return out


if __name__ == "__main__":
    main()
