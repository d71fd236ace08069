"""What every traffic module shares: the run's context, its directories and
caches, the card's description, and the weights.

Nothing here imports torch at module level: `run.py` sets the cache
directories before torch is first imported.
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil
import sys
import tempfile
import time
from typing import Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
CACHE = os.path.join(ROOT, "build", "benchmark")


def setup_env():
    """Bytecode, kernel and extension caches at fixed paths inside the
    checkout, so that only a checkout's first run builds anything. The
    program's nvcc builds go to build/hover_net_tpu_torch/ by its own
    rule; torch's extension and Triton caches are pointed here in case a
    library takes them."""
    sys.dont_write_bytecode = False
    sys.pycache_prefix = os.path.join(ROOT, "build", "pycache")
    os.environ.setdefault("TORCH_EXTENSIONS_DIR",
                          os.path.join(CACHE, "torch_extensions"))
    os.environ.setdefault("TRITON_CACHE_DIR", os.path.join(CACHE, "triton"))
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_json(*parts):
    with open(os.path.join(ROOT, *parts)) as f:
        return json.load(f)


def log(*args):
    print(*args, file=sys.stderr, flush=True)


@dataclasses.dataclass
class Context:
    """One run: the parsed arguments, the cell's file, the configuration's
    file, BENCHMARK.json, the run's start on the host clock, its work
    directory and its device."""

    seed: int
    seconds: float
    trace: bool
    cell: dict
    cfg: dict
    bench: dict
    t0: float
    device: str = "cuda"
    work: Optional[str] = None
    # seconds spent training the yardstick's weights, left out of setup_s
    excluded_s: float = 0.0

    def weights(self) -> str:
        """The configuration's cached recipe weights (reference/recipe.py).
        Where the `.tar` is missing, as in a checkout's first run, the
        recipe trains it: that is the benchmark's own work, not the
        program's, so its seconds are left out of `elapsed()` and thus of
        `setup_s`."""
        from .reference import recipe

        t = time.perf_counter()
        path = recipe.ensure_weights(self.cfg)
        spent = time.perf_counter() - t
        self.excluded_s += spent
        if spent > 1:
            log(f"recipe weights trained in {spent:.3f} s, left out of "
                f"setup_s")
        return path

    def workdir(self) -> str:
        """A fixed directory under TMPDIR for this cell's inputs and
        outputs, emptied at the start of the run."""
        if self.work is None:
            self.work = os.path.join(tempfile.gettempdir(), "hnt_benchmark",
                                     self.cell["name"])
            shutil.rmtree(self.work, ignore_errors=True)
            os.makedirs(self.work)
        return self.work

    def cleanup(self):
        if self.work is not None:
            shutil.rmtree(self.work, ignore_errors=True)

    def elapsed(self) -> float:
        """Seconds since the run started, less the recipe's training."""
        return time.perf_counter() - self.t0 - self.excluded_s


def device_info(device: str) -> dict:
    import torch

    if not device.startswith("cuda"):
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(0)),
            "power_limit": power_limit()}


def power_limit() -> Optional[str]:
    """The card's power limit as nvidia-smi reads it, or None."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


def write_type_info(ctx: Context) -> str:
    path = os.path.join(ctx.workdir(), "type_info.json")
    with open(path, "w") as f:
        json.dump(ctx.cfg["type_info"], f)
    return path


def free_cuda():
    import gc

    import torch

    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def stop_children():
    """End and reap every process this run started: multiprocessing's
    forkserver and resource tracker (the training loader's pool starts
    them, and each would live until this process exits), then any other
    child still there."""
    import signal
    from multiprocessing import forkserver, resource_tracker

    forkserver._forkserver._stop()
    resource_tracker._resource_tracker._stop()
    me = str(os.getpid())
    for name in os.listdir("/proc"):
        if not name.isdigit():
            continue
        try:
            with open(f"/proc/{name}/stat") as f:
                ppid = f.read().rsplit(")", 1)[1].split()[1]
        except OSError:
            continue
        if ppid == me:
            try:
                os.kill(int(name), signal.SIGTERM)
                os.waitpid(int(name), 0)
            except (ProcessLookupError, ChildProcessError):
                pass
