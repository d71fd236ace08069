"""The weights the Cellpose-SAM cell serves: the plain reference
(`reference/cellpose_sam.py`) trained by a frozen recipe on painted
patches, once per configuration and checkout.

Cellpose-SAM trains on 256^2 crops, so the recipe does too: seeded
initialisation (PyTorch's defaults from the recipe's seed; SAM's zero
positions and relative-position tables), Adam with a linear warm-up and
the gradient clipped to norm 1, and Cellpose's loss (`train._loss_fn_seg`):
the mean squared error of the flows against 5x the `masks_to_flows`
targets of the painted nuclei, over 2, plus the binary cross-entropy of
cellprob against the nuclei's mask. Each batch is painted from its step's
seed (`reference/paint.py`) and normalised by `normalize99`, by worker
processes a few steps ahead of the loop. The forward runs under bf16
autocast (Cellpose trains in bf16), the loss in float32, all under
deterministic algorithms, so a card gives the same weights every time.

Then the count check: one painted `check_size`^2 tile at the cell's
density through the trained model (the reference's tile map) and the
reference's dynamics, its masks against the painted nuclei. Where it
finds fewer than `min_found` of them, the recipe trains `more_steps` more
and checks again. The `.tar` ({"desc": state_dict}, every floating tensor
rounded to bf16) is cached under build/benchmark/weights/ in the
checkout, keyed by a hash of this folder's recipe files and the
configuration's architecture and recipe; nothing of the measured program
or of `--seed` enters it.

    python -m benchmark.reference.cellpose_recipe benchmark/configs/<name>.json
"""

from __future__ import annotations

import hashlib
import json
import multiprocessing
import os
import sys
import time
from collections import deque

import numpy as np

from .cellpose_sam import SAM_L
from .cellvit_recipe import _one_thread
from .recipe import HERE, ROOT, WEIGHTS_DIR, WORKERS

RECIPE_FILES = ("cellpose_sam.py", "cellvit.py", "model.py", "paint.py",
                "geometry.py", "recipe.py", "cellvit_recipe.py",
                "cellpose_recipe.py")


def weights_path(cfg: dict) -> str:
    h = hashlib.sha256()
    for name in RECIPE_FILES:
        with open(os.path.join(HERE, name), "rb") as f:
            h.update(name.encode())
            h.update(f.read())
    keys = ("mode", "recipe", "patch_input", *SAM_L)
    h.update(json.dumps({k: cfg.get(k) for k in keys},
                        sort_keys=True).encode())
    return os.path.join(WEIGHTS_DIR, f"{cfg['name']}_{h.hexdigest()[:16]}.tar")


def flow_batch(args):
    """Batch `step`: (normalised images [B, S, S, 3] float32, targets
    [B, 3, S, S] float32: 5x the flows (dY, dX) and the mask)."""
    cfg, step = args
    from .cellpose_sam import masks_to_flows_gpu, normalize99
    from .paint import paint_tile

    r = cfg["recipe"]
    size = cfg["size"]
    lo, hi = r["nuclei_per_tile"]
    rng = np.random.default_rng([r["seed"], step])
    imgs, lbls = [], []
    for _ in range(r["batch"]):
        img, inst, _ = paint_tile(size, size, int(rng.integers(lo, hi + 1)),
                                  int(rng.integers(1 << 62)), None,
                                  with_labels=True)
        flows = masks_to_flows_gpu(inst.astype(np.int64))
        imgs.append(normalize99(img))
        lbls.append(np.concatenate([5.0 * flows, (inst > 0)[None]])
                    .astype(np.float32))
    return np.stack(imgs), np.stack(lbls)


def _batches(pool, pcfg, steps: int, ahead: int = 8):
    """Batches 0..steps-1 of `pcfg` from the pool, at most `ahead` painted
    ahead of the loop."""
    pending = deque(pool.apply_async(flow_batch, ((pcfg, s),))
                    for s in range(min(ahead, steps)))
    for s in range(steps):
        batch = pending.popleft().get()
        if s + ahead < steps:
            pending.append(pool.apply_async(flow_batch,
                                            ((pcfg, s + ahead),)))
        yield batch


def loss_fn(y, lbl):
    """Cellpose's `_loss_fn_seg`."""
    import torch.nn.functional as F

    loss = F.mse_loss(y[:, :2], lbl[:, :2]) / 2.0
    return loss + F.binary_cross_entropy_with_logits(y[:, 2],
                                                     (lbl[:, 2] > 0.5)
                                                     .to(y.dtype))


def _train_steps(model, opt, pcfg, steps, device, r, first, pool, losses,
                 t0, label):
    import torch

    for i, (img, lbl) in enumerate(_batches(pool, pcfg, steps)):
        step = first + i
        for g in opt.param_groups:
            g["lr"] = r["lr"] * min(1.0, (step + 1) / r["warmup"])
        img = torch.from_numpy(img).to(device).permute(0, 3, 1, 2)
        lbl = torch.from_numpy(lbl).to(device)
        with torch.autocast(device, dtype=torch.bfloat16):
            y = model(img)
        loss = loss_fn(y.float(), lbl)
        opt.zero_grad(set_to_none=True)
        loss.backward()
        torch.nn.utils.clip_grad_norm_(model.parameters(), 1.0)
        opt.step()
        if i % 100 == 0 or i == steps - 1:
            losses.append(loss.item())
            print(f"recipe {label} step {step}: loss {losses[-1]:.4f} "
                  f"({time.perf_counter() - t0:.1f} s)", file=sys.stderr,
                  flush=True)
    return first + steps


def train(cfg: dict, path: str, device: str = "cuda", steps=None) -> dict:
    """Train the recipe and write its `.tar` to `path`; returns a report
    (seconds, losses, the count checks)."""
    import torch

    from .cellpose_sam import CellposeRef

    r = cfg["recipe"]
    steps = r["steps"] if steps is None else steps
    if device == "cuda":
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.use_deterministic_algorithms(True)
        torch.utils.deterministic.fill_uninitialized_memory = False
    torch.manual_seed(r["seed"])
    model = CellposeRef(cfg)
    model.strict = False
    model.to(device).train()
    opt = torch.optim.Adam((p for p in model.parameters()
                            if p.requires_grad), lr=r["lr"])
    t0 = time.perf_counter()
    losses, checks = [], []
    pcfg = {"size": r["size"], "recipe": r}
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(WORKERS, initializer=_one_thread) as pool:
        done = _train_steps(model, opt, pcfg, steps, device, r, 0, pool,
                            losses, t0, cfg["name"])
        checks.append(count_check(model, cfg, device))
        if checks[-1]["found_nuclei"] < r["min_found"] * \
                checks[-1]["painted_nuclei"]:
            model.train()
            more = dict(pcfg, recipe=dict(r, seed=r["seed"] + 1))
            _train_steps(model, opt, more, r["more_steps"], device, r, done,
                         pool, losses, t0, f"{cfg['name']} more")
            checks.append(count_check(model, cfg, device))
    seconds = time.perf_counter() - t0
    if not np.all(np.isfinite(losses)):
        raise FloatingPointError(f"recipe losses {losses}")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".part"
    # rounded to bf16, the body dtype of the configuration: the reference
    # computes in float32 on the same values the program reads
    state = {k: v.to(torch.bfloat16) if v.is_floating_point() else v
             for k, v in model.state_dict().items()}
    torch.save({"desc": state}, tmp)
    os.replace(tmp, path)
    return {"train_s": seconds, "steps": steps, "losses": losses,
            "checks": checks}


def count_check(model, cfg: dict, device: str) -> dict:
    """Painted nuclei against the masks the reference's dynamics find in
    the model's map of one painted `check_size`^2 tile."""
    import torch

    from .cellpose_sam import CellposeReference, masks_of_map
    from .paint import paint_tile

    r = cfg["recipe"]
    size = r["check_size"]
    img, inst, _ = paint_tile(size, size, int(r["check_nuclei"]), 12345,
                              None, with_labels=True)
    model.eval()
    ref = CellposeReference.__new__(CellposeReference)
    ref.cfg, ref.device, ref.batch, ref.model = cfg, device, 8, model
    ref.win, ref.step = cfg["patch_input"], cfg["patch_output"]
    deterministic = torch.are_deterministic_algorithms_enabled()
    torch.use_deterministic_algorithms(False)
    try:
        with torch.autocast(device, dtype=torch.bfloat16):
            fmap = ref.tile(img)
        masks, counts = masks_of_map(fmap, device)
    finally:
        torch.use_deterministic_algorithms(deterministic)
    return {"painted_nuclei": int(len(np.unique(inst)) - 1),
            "found_nuclei": int(masks.max()), **counts}


def ensure_weights(cfg: dict, log=sys.stderr) -> str:
    """The cached `.tar` of `cfg`'s recipe, trained first in a child
    process where it is missing."""
    import subprocess

    path = weights_path(cfg)
    if not os.path.exists(path):
        cfg_file = os.path.join(ROOT, "benchmark", "configs",
                                f"{cfg['name']}.json")
        env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
        subprocess.run([sys.executable, "-m",
                        "benchmark.reference.cellpose_recipe", cfg_file],
                       cwd=ROOT, env=env, check=True, stdout=log, stderr=log)
    return path


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    with open(argv[0]) as f:
        cfg = json.load(f)
    path = weights_path(cfg)
    report = train(cfg, path)
    print(f"recipe {cfg['name']}: {json.dumps(report)} -> {path}",
          file=sys.stderr, flush=True)


if __name__ == "__main__":
    main()
