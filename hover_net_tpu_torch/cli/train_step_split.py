"""Where a train step's time goes, in each phase's setting of the
reference's two default phases (frozen encoder at its batch, then
everything at its batch):

    python -m hover_net_tpu_torch.cli.train_step_split
    python -m hover_net_tpu_torch.cli.train_step_split --width 8 --size 96 --device cpu

Fast mode, 5 types, weights from a seeded `torch.Generator` and one
seeded batch of `--size`^2 patches, kept on the device. For each
setting it prints:

- the host-clock ms of a step that ends in the loss pull (the trainer's
  own sync), median of `--steps` after 3 warm-up steps, with cuDNN's
  default TF32 and with TF32 off;
- one torch.profiler window of `--steps` more steps: its host-clock ms a
  step (profiling included), the device's busy ms a step (the union of
  kernel, copy and memset intervals) and idle share 1 - busy / window,
  unclipped, and the kernels' summed ms by group.

A device event that carries the name of a host event is a profiler
annotation spanning other kernels (Adam's `Optimizer.step`), not a
kernel, and is left out. The last line is one JSON object with every
number. On `--device cpu` the profiler sees no device events and the
device columns read "not measured".
"""

from __future__ import annotations

import argparse
import json
import re
import statistics
import time
from typing import Dict, Optional, Sequence

import numpy as np
import torch

from ..config import default_phases
from ..infer.base import resolve_device
from ..models.hovernet import HoVerNet, HoVerNetConfig
from ..parallel import train_parallel as tp

KERNEL_GROUPS = (  # first match wins, on the lower-cased kernel name
    ("batch norm", r"batch_norm|batchnorm|welford|bn_"),
    ("convolution", r"conv|cudnn|xmma|gemm|fprop|dgrad|wgrad|cutlass"),
    ("optimizer", r"multi_tensor|adam"),
    ("copy / memset", r"memcpy|memset"),
)


def seeded_batch(n: int, size: int, out: int, nr_types: int, seed: int):
    """One batch in the trainer's layout: img [n, size, size, 3] uint8,
    np_map / tp_map [n, out, out], hv_map [n, out, out, 2]."""
    rng = np.random.default_rng(seed)
    return {
        "img": rng.integers(0, 256, (n, size, size, 3), np.uint8),
        "np_map": (rng.uniform(0, 1, (n, out, out)) > 0.5).astype(np.uint8),
        "hv_map": rng.uniform(-1, 1, (n, out, out, 2)).astype(np.float32),
        "tp_map": rng.integers(0, nr_types, (n, out, out)).astype(np.int32),
    }


def device_split(prof, n_steps: int):
    """(busy ms a step as the union of device intervals, {group: summed
    ms a step}) of a profiler window, or None without device events."""
    events = prof.events()
    host_names = {e.name for e in events
                  if e.device_type == torch.autograd.DeviceType.CPU}
    spans, groups = [], {}
    for e in events:
        if (e.device_type != torch.autograd.DeviceType.CUDA
                or e.name in host_names):
            continue
        spans.append((e.time_range.start, e.time_range.end))
        group = next((g for g, pat in KERNEL_GROUPS
                      if re.search(pat, e.name.lower())),
                     "elementwise, other")
        groups[group] = groups.get(group, 0.0) + e.device_time / 1e3 / n_steps
    if not spans:
        return None
    busy_us, end = 0.0, float("-inf")
    for a, b in sorted(spans):
        if b > end:
            busy_us += b - max(a, end)
            end = b
    return busy_us / 1e3 / n_steps, groups


def split_setting(net, freeze: bool, batch, device, n_steps: int
                  ) -> Dict[str, object]:
    """The numbers of one setting (see the module docstring) as a dict."""
    from torch.profiler import ProfilerActivity, profile

    tx, schedule = tp.make_optimizer()
    state = tp.init_train_state(net, tx, device)
    step = tp.make_train_step(net, schedule, freeze_encoder=freeze)
    cuda = device.type == "cuda"

    def run():
        _, (terms, _) = step(state, batch)
        return float(terms["overall_loss"])

    def step_ms():
        for _ in range(3):
            run()
        times = []
        for _ in range(n_steps):
            t0 = time.perf_counter()
            run()
            times.append(time.perf_counter() - t0)
        return statistics.median(times) * 1e3

    res = {"step_ms": step_ms()}
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        res["step_ms_tf32_off"] = step_ms()
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA]
                                           if cuda else [])
    with profile(activities=activities) as prof:
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n_steps):
            run()
        if cuda:
            torch.cuda.synchronize()
        res["window_ms"] = (time.perf_counter() - t0) * 1e3 / n_steps
    split = device_split(prof, n_steps)
    if split is not None:
        res["busy_ms"], res["groups_ms"] = split
        res["idle_share"] = 1 - res["busy_ms"] / res["window_ms"]
    return res


def main(argv: Optional[Sequence[str]] = None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--width", type=int, default=64)
    ap.add_argument("--size", type=int, default=256,
                    help="patch input size (fast mode: 256 -> 164)")
    ap.add_argument("--steps", type=int, default=5)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    out = args.size - 92  # fast mode's valid crop: 256 -> 164
    cfg = HoVerNetConfig(mode="fast", nr_types=5, width=args.width)
    start = HoVerNet(cfg, generator=torch.Generator().manual_seed(
        args.seed)).state_dict()
    phases = default_phases("fast")
    host = seeded_batch(max(p.batch_size["train"] for p in phases),
                        args.size, out, cfg.nr_types, args.seed)
    results = []
    for phase in phases:
        n = phase.batch_size["train"]
        net = HoVerNet(cfg)
        net.load_state_dict(start)
        batch = {k: torch.from_numpy(v[:n]).to(device)
                 for k, v in host.items()}
        res = split_setting(net, phase.freeze_encoder, batch, device,
                            args.steps)
        res.update(freeze_encoder=phase.freeze_encoder, batch=n)
        results.append(res)
        line = (f"freeze_encoder={phase.freeze_encoder}, batch {n}: "
                f"{res['step_ms']:.3f} ms a step ({res['step_ms_tf32_off']:.3f}"
                f" with TF32 off); profiled window {res['window_ms']:.3f} "
                "ms a step")
        if "busy_ms" in res:
            line += (f", device busy {res['busy_ms']:.3f} ms (idle "
                     f"{100 * res['idle_share']:.1f} %): " + ", ".join(
                         f"{g} {ms:.3f}" for g, ms in sorted(
                             res["groups_ms"].items(), key=lambda kv: -kv[1])))
        else:
            line += ", device time not measured (no device events)"
        print(line, flush=True)
        del net, batch
        if device.type == "cuda":
            torch.cuda.empty_cache()
    print(json.dumps({"width": args.width, "size": args.size,
                      "device": str(device), "settings": results}))
    return results


if __name__ == "__main__":
    main()
