"""The weights the CellViT-SAM-H cell serves: the plain reference
(`reference/cellvit.py`) trained by a frozen recipe on painted patches,
once per configuration and checkout.

CellViT trains on PanNuke's 256^2 patches, so the recipe does too: seeded
initialisation (PyTorch's defaults from the recipe's seed; SAM's zero
positions and relative-position tables), Adam with a linear warm-up and
the gradient clipped to norm 1, HoVer-Net's loss (`reference/losses.py`)
on the branches under HoVer-Net's names, batches of painted patches with
their targets (`recipe.recipe_batch`, each batch seeded by its step)
drawn by worker processes a few steps ahead of the loop. The forward
runs under bf16 autocast (CellViT trains in mixed precision), the loss in
float32, all under deterministic algorithms (the reference's table resize
is a matrix product for that), so a card gives the same weights every
time.

Then the count check: one painted `check_size`^2 patch (the cell's 1024^2
input, `check_nuclei` nuclei at the slides' density) through the trained
model, the oracle's nuclei against the painted ones. Where it finds fewer
than `min_found` of them, the recipe trains `big_steps` more steps on
`check_size`^2 patches (the whole 64^2 grid: every position and table row
the cell uses) and checks again. The `.tar` ({"desc": state_dict}, every
floating tensor rounded to bf16) is cached under build/benchmark/weights/
in the checkout, keyed by a hash of this folder's recipe files and the
configuration's architecture and recipe; nothing of the measured program
or of `--seed` enters it.

    python -m benchmark.reference.cellvit_recipe benchmark/configs/<name>.json
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

from .cellvit import SAM_H
from .recipe import HERE, ROOT, WEIGHTS_DIR, WORKERS, recipe_batch

RECIPE_FILES = ("cellvit.py", "model.py", "losses.py", "paint.py",
                "targets.py", "postproc.py", "recipe.py", "cellvit_recipe.py")


def weights_path(cfg: dict) -> str:
    h = hashlib.sha256()
    for name in RECIPE_FILES:
        with open(os.path.join(HERE, name), "rb") as f:
            h.update(name.encode())
            h.update(f.read())
    keys = ("mode", "nr_types", "recipe", *SAM_H)
    h.update(json.dumps({k: cfg.get(k) for k in keys},
                        sort_keys=True).encode())
    return os.path.join(WEIGHTS_DIR, f"{cfg['name']}_{h.hexdigest()[:16]}.tar")


def phase_cfg(cfg: dict, size: int, batch: int, nuclei, seed: int) -> dict:
    """The configuration `recipe.recipe_batch` paints a phase's batches
    from: `size`^2 patches whose targets cover the whole patch (CellViT's
    maps are the input's size)."""
    return {"patch_input": size, "patch_output": size,
            "nr_types": cfg["nr_types"],
            "recipe": {"seed": seed, "batch": batch,
                       "nuclei_per_tile": list(nuclei)}}


def _batches(pool, pcfg, steps: int, ahead: int = 8):
    """Batches 0..steps-1 of `pcfg` from the pool, at most `ahead` painted
    ahead of the loop: a pool that paints them all at once keeps the
    loop's process busy taking in its results while the loop, bound by
    its kernel launches, needs the host."""
    pending = deque(pool.apply_async(recipe_batch, ((pcfg, s),))
                    for s in range(min(ahead, steps)))
    for s in range(steps):
        batch = pending.popleft().get()
        if s + ahead < steps:
            pending.append(pool.apply_async(recipe_batch,
                                            ((pcfg, s + ahead),)))
        yield batch


def _train_steps(model, opt, pcfg, steps, device, r, first, pool, losses,
                 t0, label):
    import torch

    from .cellvit import branch_logits
    from .losses import hovernet_loss

    for i, (img, np_map, hv, tp) in enumerate(_batches(pool, pcfg, steps)):
        step = first + i
        for g in opt.param_groups:
            g["lr"] = r["lr"] * min(1.0, (step + 1) / r["warmup"])
        img, np_map, hv, tp = (torch.from_numpy(a).to(device)
                               for a in (img, np_map, hv, tp))
        with torch.autocast(device, dtype=torch.bfloat16):
            out = branch_logits(model(img.permute(0, 3, 1, 2)))
        loss, _ = hovernet_loss({k: v.float() for k, v in out.items()},
                                np_map, hv, tp)
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

    from .cellvit import CellViTRef

    r = cfg["recipe"]
    steps = r["steps"] if steps is None else steps
    if device == "cuda":
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = True
        torch.use_deterministic_algorithms(True)
        # deterministic mode fills every new tensor first (half of the
        # step's launches); each op here writes what it allocates
        torch.utils.deterministic.fill_uninitialized_memory = False
    torch.manual_seed(r["seed"])
    model = CellViTRef(cfg, cfg["nr_types"])
    model.strict = False
    model.to(device).train()
    opt = torch.optim.Adam(model.parameters(), lr=r["lr"])
    t0 = time.perf_counter()
    losses, checks = [], []
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(WORKERS, initializer=_one_thread) as pool:
        done = _train_steps(
            model, opt, phase_cfg(cfg, r["size"], r["batch"],
                                  r["nuclei_per_tile"], r["seed"]),
            steps, device, r, 0, pool, losses, t0, cfg["name"])
        checks.append(count_check(model, cfg, device))
        if checks[-1]["found_nuclei"] < r["min_found"] * \
                checks[-1]["painted_nuclei"]:
            model.train()
            _train_steps(
                model, opt, phase_cfg(cfg, r["check_size"], r["big_batch"],
                                      r["big_nuclei_per_tile"],
                                      r["seed"] + 1),
                r["big_steps"], device, r, done, pool, losses, t0,
                f"{cfg['name']} at {r['check_size']}^2")
            checks.append(count_check(model, cfg, device))
    seconds = time.perf_counter() - t0
    if not np.all(np.isfinite(losses)):
        raise FloatingPointError(f"recipe losses {losses}")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".part"
    # rounded to bf16, the body dtype of the configuration: half the file
    # (1.4 GB at the published widths), and the reference computes in
    # float32 on the same values the program reads
    state = {k: v.to(torch.bfloat16) if v.is_floating_point() else v
             for k, v in model.state_dict().items()}
    torch.save({"desc": state}, tmp)
    os.replace(tmp, path)
    return {"train_s": seconds, "steps": steps, "losses": losses,
            "checks": checks}


def _one_thread():
    """A painting worker keeps to one thread, leaving the cores to the
    training loop's kernel launches."""
    import cv2
    import torch

    cv2.setNumThreads(1)
    torch.set_num_threads(1)


def count_check(model, cfg: dict, device: str) -> dict:
    """Painted nuclei against the nuclei the oracle finds in the model's
    maps of one painted `check_size`^2 patch."""
    import torch

    from .cellvit import branch_logits
    from .model import head_maps
    from .paint import paint_tile
    from .postproc import proc_np_hv

    r = cfg["recipe"]
    size = r["check_size"]
    img, inst, _ = paint_tile(size, size, int(r["check_nuclei"]), 12345,
                              cfg["nr_types"], with_labels=True)
    model.eval()
    with torch.no_grad():
        x = torch.from_numpy(img[None]).to(device).permute(0, 3, 1, 2)
        maps = head_maps(branch_logits(model(x)))[0].cpu().numpy()
    found = proc_np_hv(maps[..., 1:4])
    return {"painted_nuclei": int(len(np.unique(inst)) - 1),
            "found_nuclei": int(found.max())}


def ensure_weights(cfg: dict, log=sys.stderr) -> str:
    """The cached `.tar` of `cfg`'s recipe, trained first in a child
    process where it is missing (a process of its own keeps the recipe's
    deterministic settings and memory out of the measured process)."""
    import subprocess

    path = weights_path(cfg)
    if not os.path.exists(path):
        cfg_file = os.path.join(ROOT, "benchmark", "configs",
                                f"{cfg['name']}.json")
        env = dict(os.environ, CUBLAS_WORKSPACE_CONFIG=":4096:8")
        subprocess.run([sys.executable, "-m",
                        "benchmark.reference.cellvit_recipe", cfg_file],
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
