"""Measures the WSI host-finalize pool (infer/wsi.py: each post-proc
window's instance info is extracted by a thread pool while the card works
on the next window batch).

Counterpart of scripts/bench_finalize_pool.py, with the same windows,
measurements and JSON keys:

  (a) the extraction cost of one window (label remap plus the native
      stats and contour passes), the unit the host stage scales with;
  (b) the pool's overhead: a 1-worker pool against a plain loop (about
      1.0x when the pool cannot help), and a 2-worker pool;
  (c) whether the native passes release the GIL: a pure-Python spin
      thread's rate beside a native extraction loop, over its rate
      alone. The ctypes calls drop the GIL, so the spin thread keeps a
      share (about 0.5 on one core, more with spare cores); a pass that
      held the GIL would starve it towards 0. With the GIL released, N
      cores run N extractions at once.

    python -m hover_net_tpu_torch.cli.bench_finalize_pool [--windows 16]
        [--size 512] [--per_win 150]

Prints one JSON line last and returns it as a dict. Host only: no card.
"""

from __future__ import annotations

import argparse
import json
import os
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from ..metrics.stats import remap_label
from ..ops.post_proc_host import extract_instance_info


def paint_windows(n_win, size, per_win, seed=11):
    """`n_win` int32 instance maps of `size`^2, each with `per_win` disc
    nuclei of radius 5..10 (later ones do not overwrite earlier ones)."""
    rng = np.random.default_rng(seed)
    wins = []
    yy, xx = np.mgrid[-12:13, -12:13]
    for _ in range(n_win):
        inst = np.zeros((size, size), np.int32)
        k = 1
        for _ in range(per_win):
            cy = int(rng.integers(14, size - 14))
            cx = int(rng.integers(14, size - 14))
            r = int(rng.integers(5, 11))
            m = (yy ** 2 + xx ** 2) <= r * r
            sub = inst[cy - 12:cy + 13, cx - 12:cx + 13]
            sub[m & (sub == 0)] = k
            k += 1
        wins.append(inst)
    return wins


def extract_all(wins, pool=None):
    """(seconds, instances) of extracting every window, in a loop or
    through `pool`."""
    def one(w):
        return extract_instance_info(remap_label(w))

    t0 = time.perf_counter()
    if pool is None:
        out = [one(w) for w in wins]
    else:
        out = list(pool.map(one, wins))
    dt = time.perf_counter() - t0
    n = sum(len(info) for _, info in out)
    return dt, n


def spin_rate(stop_evt, out):
    c = 0
    t0 = time.perf_counter()
    while not stop_evt.is_set():
        c += 1
    out.append(c / (time.perf_counter() - t0))


def measure_spin(wins, concurrent_native: bool, dur: float = 2.0) -> float:
    """The spin thread's rate over `dur` seconds, alone or beside a loop
    of native extractions."""
    stop = threading.Event()
    rates = []
    th = threading.Thread(target=spin_rate, args=(stop, rates))
    th.start()
    t0 = time.perf_counter()
    if concurrent_native:
        while time.perf_counter() - t0 < dur:
            extract_all(wins[:2])
    else:
        time.sleep(dur)
    stop.set()
    th.join()
    return rates[0]


def main(argv=None):
    ap = argparse.ArgumentParser("hover_net_tpu_torch.bench_finalize_pool")
    ap.add_argument("--windows", type=int, default=16)
    ap.add_argument("--size", type=int, default=512)
    ap.add_argument("--per_win", type=int, default=150)
    args = ap.parse_args(argv)

    wins = paint_windows(args.windows, args.size, args.per_win)
    extract_all(wins[:1])  # builds and loads the native library

    t_seq, n_inst = extract_all(wins)
    t_seq = min(t_seq, extract_all(wins)[0])
    with ThreadPoolExecutor(max_workers=1) as p1:
        t_p1, _ = extract_all(wins, p1)
        t_p1 = min(t_p1, extract_all(wins, p1)[0])
    with ThreadPoolExecutor(max_workers=2) as p2:
        t_p2, _ = extract_all(wins, p2)
        t_p2 = min(t_p2, extract_all(wins, p2)[0])

    solo = measure_spin(wins, False)
    beside = measure_spin(wins, True)

    res = {
        "n_windows": args.windows, "window": args.size,
        "instances": n_inst,
        "ms_per_window_seq": round(t_seq / args.windows * 1000, 2),
        "pool1_overhead_x": round(t_p1 / t_seq, 3),
        "pool2_vs_seq_x": round(t_p2 / t_seq, 3),
        "spin_rate_share_beside_native": round(beside / solo, 3),
        "gil_released": bool(beside / solo > 0.25),
        "host_cores": os.cpu_count(),
    }
    print(json.dumps(res))
    return res


if __name__ == "__main__":
    main()
