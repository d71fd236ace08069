"""Process-level runtime helpers of the CLIs.

Counterpart of hover_net_tpu/runtime.py: `profile_trace` captures a
trace of a scope with torch.profiler. The JAX package's `setup` (XLA's
compile cache) has no counterpart: ops/nvcc_build.py caches the built
kernels.
"""

from __future__ import annotations

import contextlib


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
    import torch
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
