"""Process-level runtime helpers of the CLIs.

Counterpart of hover_net_tpu/runtime.py: `profile_trace` captures a
trace of a scope with torch.profiler. The JAX package's `setup` (XLA's
compile cache) has no counterpart: ops/nvcc_build.py caches the built
kernels.

`span` names a region of the program at a layer boundary: in a
torch.profiler trace (`profile_trace`, or any profiler a caller runs) as
a `record_function` range, and, when given a dict, as host seconds added
into it. The managers' `timings` are filled this way, so one region
carries one name in both. Span names are `hnt.<layer>.<what>`; spans
open per tile, chunk, window batch, slide or step, never per patch or
nucleus.
"""

from __future__ import annotations

import contextlib
import time
from typing import Optional

import torch
from torch.autograd.profiler import record_function


class span:
    """`with span("hnt.tile.read", times, "read"):` adds the region's host
    seconds (time.perf_counter) into `times[key]` (also when the region
    raises) and, while a profiler records on this thread, opens a
    `record_function(name)` range. With no profiler running the range is
    not opened: a span then costs a flag read and two clock reads."""

    __slots__ = ("name", "times", "key", "_range", "_t0")

    def __init__(self, name: str, times: Optional[dict] = None,
                 key: Optional[str] = None):
        self.name, self.times, self.key = name, times, key
        self._range = None

    def __enter__(self):
        if torch.autograd._profiler_enabled():
            self._range = record_function(self.name)
            self._range.__enter__()
        self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        dt = time.perf_counter() - self._t0
        if self._range is not None:
            self._range.__exit__(*exc)
            self._range = None
        if self.times is not None:
            self.times[self.key] = self.times.get(self.key, 0.0) + dt
        return False


@contextlib.contextmanager
def profile_trace(log_dir: str | None):
    """`with profile_trace("/tmp/trace"):` records the enclosed scope with
    torch.profiler (CPU ops, and CUDA kernels when a card is present) and
    writes `<host>_<pid>.<n>.pt.trace.json` under `log_dir`, which
    TensorBoard's profiler plugin and chrome://tracing open. Does nothing
    when `log_dir` is empty or None."""
    if not log_dir:
        yield
        return
    from torch.profiler import (
        ProfilerActivity,
        profile,
        tensorboard_trace_handler,
    )

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    with profile(activities=activities,
                 on_trace_ready=tensorboard_trace_handler(log_dir)):
        yield
