"""One nvcc + ctypes builder for the port's hand-written CUDA kernels.

Each kernel library is one `.cu` file under hover_net_tpu_torch/csrc/
with a plain C interface, plus the `csrc/` headers it includes with
quotes. `build_library(name, bind, flags)` compiles it with nvcc for
sm_90a at first use into build/hover_net_tpu_torch/ at the repository
root, under a name keyed by `source_digest`: a hash of the `.cu`, every
`csrc/` file it includes with quotes (transitively) and the flags, so an
edit to a header or a flag builds anew. nvcc's messages (with
`-Xptxas -v`: registers and spills) are kept beside the library as
`<name>_<digest>.log`. The library is loaded with ctypes, `bind` declares
the argument types, and the handle is cached for the process. Each
library builds under its own lock, so two threads never race the same
`.so` while two kernels can build at once. A failed build raises: there
is no fallback.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from typing import Callable, Dict, List, Sequence

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(os.path.dirname(_PKG), "build", "hover_net_tpu_torch")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC")
_QUOTED_INCLUDE = re.compile(rb'^[ \t]*#[ \t]*include[ \t]*"([^"]+)"', re.M)

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


def source_files(src: str) -> List[str]:
    """`src` and every file it includes with quotes, transitively, each
    looked up beside the file that includes it; includes that are not
    there (system and toolkit headers) are left out."""
    files: List[str] = []
    todo = [os.path.normpath(src)]
    while todo:
        path = todo.pop()
        if path in files:
            continue
        files.append(path)
        with open(path, "rb") as f:
            for inc in _QUOTED_INCLUDE.findall(f.read()):
                cand = os.path.normpath(os.path.join(os.path.dirname(path),
                                                     inc.decode()))
                if os.path.isfile(cand):
                    todo.append(cand)
    return files


def source_digest(src: str, flags: Sequence[str]) -> str:
    """12 hex digits of a hash of `src`, the files it includes with quotes
    (by name and content) and the nvcc flags."""
    h = hashlib.sha1()
    for path in [src] + sorted(source_files(src)[1:]):
        with open(path, "rb") as f:
            h.update(os.path.basename(path).encode() + b"\0" + f.read())
    h.update("\0".join(flags).encode())
    return h.hexdigest()[:12]


def build_library(name: str, bind: Callable[[ctypes.CDLL], None],
                  flags: Sequence[str] = ()) -> ctypes.CDLL:
    """Compile csrc/<name>.cu with NVCC_FLAGS + `flags` (if this source
    and these flags have no library yet), load it and declare its
    functions with `bind`. Raises on any failure."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    with _locks_lock:
        lock = _locks.setdefault(name, threading.Lock())
    with lock:
        if name not in _libs:
            lib = ctypes.CDLL(_compile(name, (*NVCC_FLAGS, *flags)))
            bind(lib)
            _libs[name] = lib
    return _libs[name]


def _compile(name: str, flags: Sequence[str]) -> str:
    src = os.path.join(CSRC, f"{name}.cu")
    stem = os.path.join(BUILD_DIR, f"{name}_{source_digest(src, flags)}")
    so_path = stem + ".so"
    if not os.path.exists(so_path):
        nvcc = nvcc_path()
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{so_path}.tmp{os.getpid()}"
        res = subprocess.run([nvcc, *flags, "-o", tmp, src],
                             capture_output=True, text=True)
        if res.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src}:\n{res.stderr}")
        with open(stem + ".log", "w") as f:
            f.write(res.stdout + res.stderr)
        os.replace(tmp, so_path)
    return so_path
