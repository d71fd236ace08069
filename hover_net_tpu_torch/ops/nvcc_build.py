"""One nvcc + ctypes builder for the port's hand-written CUDA kernels.

Each kernel is one `.cu` file under hover_net_tpu_torch/csrc/ with a
plain C interface. `build_library(name, bind)` compiles it with nvcc for
sm_90a at first use into build/hover_net_tpu_torch/ at the repository
root, under a name keyed by a hash of the source and the flags, loads it
with ctypes, lets `bind` declare the argument types, and caches the
handle for the process. Each library builds under its own lock, so two
threads never race the same `.so` while two kernels can build at once.
A failed build raises: there is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from typing import Callable, Dict

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "hover_net_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")

_locks_lock = threading.Lock()
_locks: Dict[str, threading.Lock] = {}
_libs: Dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    nvcc = shutil.which("nvcc") or os.path.join(
        os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc")
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: cannot build the CUDA kernels "
                           "of hover_net_tpu_torch")
    return nvcc


def build_library(name: str, bind: Callable[[ctypes.CDLL], None]
                  ) -> ctypes.CDLL:
    """Compile csrc/<name>.cu (if this source has no library yet), load
    it and declare its functions with `bind`. Raises on any failure."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _locks_lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if name not in _libs:
            lib = ctypes.CDLL(_compile(name))
            bind(lib)
            _libs[name] = lib
    return _libs[name]


def _compile(name: str) -> str:
    src = os.path.join(CSRC, f"{name}.cu")
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(NVCC_FLAGS).encode()
                              ).hexdigest()[:12]
    so_path = os.path.join(BUILD_DIR, f"{name}_{digest}.so")
    if not os.path.exists(so_path):
        nvcc = nvcc_path()
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so_path}.tmp{os.getpid()}"
        res = subprocess.run([nvcc, *NVCC_FLAGS, "-o", tmp, src],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{res.stderr}")
        os.replace(tmp, so_path)
    return so_path
