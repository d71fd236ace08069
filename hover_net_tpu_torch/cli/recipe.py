"""The recipe checkpoint: trained weights that are the same on every run,
and the helpers the port's probes and correctness sweeps share.

`train_e2e_checkpoint` trains bench.py's `_train_e2e_checkpoint` (the JAX
package's recipe) with the port's train step: width 64, fast mode,
untyped (or `nr_types` with each instance's type drawn from the same
rng), 400 steps at batch 8, Adam at 3e-4, batches drawn from one seeded
rng (their tiles by worker processes while the step runs:
data/synthetic.py), weights from a seeded `torch.Generator`, float32 on
deterministic cuDNN and cuBLAS algorithms (`deterministic_training`), so
that every run on a card gives the same weights. The `.tar` is cached
under build/hover_net_tpu_torch/bench/, keyed by a hash of the recipe's
arguments and of the files whose code trains it (`RECIPE_SOURCES`): the
first run trains it (70-95 s on an NVIDIA H100 80GB HBM3, 700.00 W),
later runs load it.

Its readers: cli/fused_encoder_drift and cli/parity_drift_sweep run it
through the tile manager (`e2e_manager`, with `resolve_checkpoint` and
`add_common_args` for their flags), and chip_smoke.py's evaluation and
measurement phases check its sha256 against their record. The module also
holds `synth_pred_map`, bench.py's synthetic prediction map, and
re-exports `synth_nuclei_image`, its synthetic H&E tile; and `card_line`,
the card's name and power limit that every printed time stands beside.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import hashlib
import json
import os
import subprocess
import time
from typing import Dict, Optional

import numpy as np
import torch

from ..data.synthetic import (  # noqa: F401 (the recipe's data, re-exported)
    pooled_recipe_batches,
    recipe_batches,
    synth_nuclei_image,
)
from ..data.train_pipeline import device_prefetch
from ..infer.base import resolve_device
from ..models.checkpoints import load_torch_tar, save_train_tar
from ..models.hovernet import HoVerNet, HoVerNetConfig
from ..ops.nvcc_build import BUILD_DIR
from ..ops.targets import gen_instance_hv_map
from ..parallel.train_parallel import (
    init_train_state,
    make_optimizer,
    make_train_step,
)

BENCH_DIR = os.path.join(BUILD_DIR, "bench")
RECIPE_LR = 3e-4
# the package's files whose code trains the recipe's checkpoint: a change
# to any of them changes the cache key, so a cached `.tar` is always the
# current code's
RECIPE_SOURCES = ("cli/recipe.py", "parallel/train_parallel.py",
                  "models/hovernet.py", "models/blocks.py", "ops/losses.py",
                  "ops/targets.py", "data/train_pipeline.py",
                  "models/checkpoints.py", "utils/crops.py",
                  "data/synthetic.py")
# worker processes that draw the recipe's tiles while the step runs (its
# host work, ~170 ms a batch of 8 in one process, would hold the step)
RECIPE_WORKERS = 4


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
    version in this process (each CLI prints the cached recipe's; reading
    a trainer `.tar` takes seconds)."""
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


def resolve_checkpoint(args) -> str:
    """`--model_path` when given, else the untyped recipe checkpoint at
    `--width` on `--device`, cached in `--ckpt_dir`."""
    if args.model_path:
        return args.model_path
    return train_e2e_checkpoint(width=args.width, device=args.device,
                                ckpt_dir=args.ckpt_dir)


def add_common_args(ap: argparse.ArgumentParser):
    """--device, --width, --model_path, --ckpt_dir: the flags of the CLIs
    that run the recipe."""
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


def e2e_manager(model_path, width=64, dtype=torch.bfloat16, device="cuda"):
    """The tile manager the untyped recipe runs through: fast mode, batch
    32."""
    from ..infer.tile import TileInferManager

    return TileInferManager(model_path=model_path, mode="fast", width=width,
                            batch_size=32, dtype=dtype, device=device)
