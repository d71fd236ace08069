"""The traced stretch of a `--trace 1` run: torch.profiler over a steady
part of the window, reduced to what the per-layer readers and the result
line need.

`Stretch` starts the profiler (CPU ops and CUDA activity) and marks the
stretch with a `record_function` span; `summary()` exports the chrome
trace into the run's work directory and reads from it: the stretch's
length, the seconds in which some kernel, copy or memset ran on the card
(the union of their intervals), the device seconds by kernel name, and
the idle gaps of the card named by the innermost host event under each.
"""

from __future__ import annotations

import json
import os
import time
from collections import defaultdict

import numpy as np

MARK = "benchmark.stretch"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation")
# gaps named one by one: the longest ones (the rest are summed unnamed)
NAMED_GAPS = 4000


def span(name: str, fn):
    """`fn` run inside a `record_function(name)` span: in a traced run the
    traffic modules wrap the program's calls at each layer boundary with these,
    so that the trace names what the host was doing."""
    import functools

    from torch.profiler import record_function

    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with record_function(name):
            return fn(*args, **kwargs)

    return wrapped


class Stretch:
    def __init__(self, work_dir: str):
        self.path = os.path.join(work_dir, "stretch.pt.trace.json")
        self.prof = self.mark = None
        self.host_s = None

    def start(self):
        import torch
        from torch.profiler import ProfilerActivity, profile, record_function

        acts = [ProfilerActivity.CPU]
        if torch.cuda.is_available():
            acts.append(ProfilerActivity.CUDA)
        self.prof = profile(activities=acts)
        self.prof.start()
        self.mark = record_function(MARK)
        self.mark.__enter__()
        self._t = time.perf_counter()

    def stop(self):
        import torch

        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.host_s = time.perf_counter() - self._t
        self.mark.__exit__(None, None, None)
        self.prof.stop()

    def summary(self) -> dict:
        if self.prof is None:
            raise RuntimeError("the window ended before the traced stretch "
                               "began")
        self.prof.export_chrome_trace(self.path)
        with open(self.path) as f:
            events = json.load(f)["traceEvents"]
        os.remove(self.path)
        return summarize(events)


def _union(intervals: np.ndarray) -> np.ndarray:
    """Merged [start, end] rows of sorted-by-start intervals."""
    if len(intervals) == 0:
        return intervals
    out = [list(intervals[0])]
    for s, e in intervals[1:]:
        if s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return np.asarray(out)


def summarize(events) -> dict:
    """Reduce chrome-trace events (microseconds) to the stretch's numbers;
    times in seconds."""
    mark = [e for e in events if e.get("ph") == "X" and e.get("name") == MARK]
    if not mark:
        raise RuntimeError("the trace holds no stretch mark")
    w0 = float(mark[0]["ts"])
    w1 = w0 + float(mark[0]["dur"])
    dev, host = [], []
    by_name = defaultdict(float)
    for e in events:
        if e.get("ph") != "X" or "dur" not in e:
            continue
        s, d = float(e["ts"]), float(e["dur"])
        cat = e.get("cat", "")
        if cat in DEVICE_CATS:
            s0, s1 = max(s, w0), min(s + d, w1)
            if s1 > s0:
                dev.append((s0, s1))
                by_name[e["name"]] += (s1 - s0) * 1e-6
        elif cat in HOST_CATS and e["name"] != MARK:
            host.append((s, s + d, e["name"]))
    dev.sort()
    busy = _union(np.asarray(dev, float).reshape(-1, 2))
    busy_s = float((busy[:, 1] - busy[:, 0]).sum()) * 1e-6 if len(busy) else 0.0
    edges = np.concatenate([[w0], busy.ravel(), [w1]]).reshape(-1, 2)
    gaps = edges[edges[:, 1] > edges[:, 0]]
    return {"window_s": (w1 - w0) * 1e-6, "busy_s": busy_s,
            "device_by_name": dict(by_name),
            "idle_by_host": _name_gaps(gaps, host)}


def _name_gaps(gaps: np.ndarray, host) -> dict:
    """{host event name: idle seconds}: each of the longest gaps is named
    by the latest-starting host event that spans its middle."""
    out = defaultdict(float)
    if len(gaps) == 0:
        return {}
    lens = gaps[:, 1] - gaps[:, 0]
    order = np.argsort(-lens)
    named, rest = order[:NAMED_GAPS], order[NAMED_GAPS:]
    if len(rest):
        out["(short gaps)"] += float(lens[rest].sum()) * 1e-6
    host.sort()
    starts = np.asarray([h[0] for h in host]) if host else np.zeros(0)
    ends = np.asarray([h[1] for h in host]) if host else np.zeros(0)
    for g in named:
        mid = 0.5 * (gaps[g, 0] + gaps[g, 1])
        k = np.searchsorted(starts, mid, side="right")
        name = "(host idle)"
        # the latest-starting event that still covers the middle
        cand = np.flatnonzero(ends[:k] >= mid)
        if len(cand):
            name = host[cand[-1]][2]
        out[name] += float(lens[g]) * 1e-6
    return dict(out)


def breakdown(summary: dict) -> dict:
    top = lambda d: [[k, v] for k, v in sorted(d.items(),
                                               key=lambda kv: -kv[1])[:10]]
    return {"device_ops": top(summary["device_by_name"]),
            "idle_gaps": top(summary["idle_by_host"])}
