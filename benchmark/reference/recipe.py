"""The weights every inference cell serves: HoVer-Net trained by a frozen
recipe on painted tiles, once per configuration and checkout.

Plain PyTorch on the reference model (`reference/model.py`), the loss of
`reference/losses.py`, Adam, batches of painted tiles (`reference/paint.py`)
with their targets (`reference/targets.py`), each batch seeded by its step,
drawn by worker processes while the step runs. cuDNN and cuBLAS run
deterministic algorithms (convolutions in TF32), so a card gives the same
weights every time. The `.tar` ({"desc": state_dict}, the reference
repository's format) is cached under build/benchmark/weights/ in the
checkout, keyed by a hash of this folder's recipe files and the
configuration's recipe; nothing of the measured program or of `--seed`
enters it.

    python -m benchmark.reference.recipe benchmark/configs/<name>.json
"""

from __future__ import annotations

import hashlib
import json
import multiprocessing
import os
import sys
import time

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
WEIGHTS_DIR = os.path.join(ROOT, "build", "benchmark", "weights")
RECIPE_FILES = ("model.py", "losses.py", "paint.py", "targets.py",
                "postproc.py", "recipe.py")
WORKERS = 4


def weights_path(cfg: dict) -> str:
    h = hashlib.sha256()
    for name in RECIPE_FILES:
        with open(os.path.join(HERE, name), "rb") as f:
            h.update(name.encode())
            h.update(f.read())
    keys = ("mode", "nr_types", "width", "recipe")
    h.update(json.dumps({k: cfg[k] for k in keys}, sort_keys=True).encode())
    return os.path.join(WEIGHTS_DIR, f"{cfg['name']}_{h.hexdigest()[:16]}.tar")


def recipe_batch(args):
    """Batch `step` of the recipe: (img [B, S, S, 3] uint8, np, hv, tp)."""
    cfg, step = args
    from .paint import paint_tile
    from .targets import cropping_center, gen_targets

    r = cfg["recipe"]
    win, out = cfg["patch_input"], cfg["patch_output"]
    lo, hi = r["nuclei_per_tile"]
    rng = np.random.default_rng([r["seed"], step])
    imgs, nps, hvs, tps = [], [], [], []
    for _ in range(r["batch"]):
        img, inst, tp = paint_tile(win, win, int(rng.integers(lo, hi + 1)),
                                   int(rng.integers(1 << 62)),
                                   cfg["nr_types"], with_labels=True)
        t = gen_targets(inst, (out, out))
        imgs.append(img)
        nps.append(t["np_map"])
        hvs.append(t["hv_map"])
        tps.append(cropping_center(tp, (out, out)))
    return (np.stack(imgs), np.stack(nps).astype(np.int64),
            np.stack(hvs).astype(np.float32), np.stack(tps).astype(np.int64))


def train(cfg: dict, path: str, device: str = "cuda", steps=None) -> dict:
    """Train the recipe and write its `.tar` to `path`; returns a report."""
    import torch

    from .losses import hovernet_loss
    from .model import HoVerNetRef

    r = cfg["recipe"]
    steps = steps or r["steps"]
    if device == "cuda":
        torch.backends.cudnn.deterministic = True
        torch.backends.cudnn.benchmark = False
        torch.backends.cudnn.allow_tf32 = True
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.use_deterministic_algorithms(True)
    model = HoVerNetRef(cfg["mode"], cfg["nr_types"], cfg["width"]).to(device)
    model.init_weights(torch.Generator(device=device).manual_seed(r["seed"]))
    model.train()
    opt = torch.optim.Adam(model.parameters(), lr=r["lr"])
    t0 = time.perf_counter()
    losses = []
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(WORKERS) as pool:
        for step, (img, np_map, hv, tp) in enumerate(pool.imap(
                recipe_batch, [(cfg, s) for s in range(steps)])):
            img, np_map, hv, tp = (torch.from_numpy(a).to(device)
                                   for a in (img, np_map, hv, tp))
            out = model(img.permute(0, 3, 1, 2))
            loss, _ = hovernet_loss(out, np_map, hv,
                                    tp if cfg["nr_types"] else None)
            opt.zero_grad(set_to_none=True)
            loss.backward()
            opt.step()
            if step % 100 == 0 or step == steps - 1:
                losses.append(loss.item())
                print(f"recipe {cfg['name']} step {step}: loss "
                      f"{losses[-1]:.4f} ({time.perf_counter() - t0:.1f} s)",
                      file=sys.stderr, flush=True)
    seconds = time.perf_counter() - t0
    if not np.all(np.isfinite(losses)):
        raise FloatingPointError(f"recipe losses {losses}")
    os.makedirs(os.path.dirname(path), exist_ok=True)
    tmp = path + ".part"
    torch.save({"desc": model.state_dict()}, tmp)
    os.replace(tmp, path)
    report = {"train_s": seconds, "steps": steps, "losses": losses}
    report.update(count_check(model, cfg, device))
    return report


def count_check(model, cfg: dict, device: str) -> dict:
    """Painted nuclei against the nuclei the oracle finds in the trained
    model's output on one painted tile of the cells' density."""
    import torch

    from .geometry import prepare_tile_patching
    from .model import head_maps
    from .paint import paint_tile
    from .postproc import proc_np_hv

    win, out = cfg["patch_input"], cfg["patch_output"]
    size = 4 * out
    n = int(cfg["recipe"]["check_nuclei"])
    img, inst, _ = paint_tile(size, size, n, 12345, cfg["nr_types"],
                              with_labels=True)
    pads, coords, grid = prepare_tile_patching((size, size), win, out)
    padded = np.pad(img, ((pads[0], pads[1]), (pads[2], pads[3]), (0, 0)),
                    mode="reflect")
    patches = np.stack([padded[y:y + win, x:x + win] for y, x in coords])
    model.eval()
    with torch.no_grad():
        x = torch.from_numpy(patches).to(device).permute(0, 3, 1, 2)
        maps = head_maps(model(x)).cpu().numpy()
    c = maps.shape[-1]
    full = maps.reshape(grid[0], grid[1], out, out, c).transpose(
        0, 2, 1, 3, 4).reshape(grid[0] * out, grid[1] * out, c)[:size, :size]
    typed = cfg["nr_types"] is not None
    found = proc_np_hv(full[..., 1:4] if typed else full[..., 0:3])
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
        subprocess.run([sys.executable, "-m", "benchmark.reference.recipe",
                        cfg_file], cwd=ROOT, env=env, check=True,
                       stdout=log, stderr=log)
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
