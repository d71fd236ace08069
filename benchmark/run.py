"""Run one benchmark cell once and print its result line.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

The cell is `benchmark/workloads/<cell>.json`; its `kind` names the traffic
module `benchmark/traffic/<kind>.py`, its `config` the configuration file
`benchmark/configs/<config>.json`. With `--trace 0` the line's metrics are
the cell's end-to-end metrics of BENCHMARK.json and `setup_s`; with
`--trace 1` they are its per-layer metrics, each read by
`benchmark/metrics/<metric>.py` from what the traffic module gathered in the traced
stretch. The last line of standard output is the result as one JSON
object; the numbers that decided `correct`, each with its limit, come last
in it and as the last lines of standard error.

The run fails, and prints no result, without a CUDA card, and when a
module whose top-level name is jax, jaxlib, flax, optax or hover_net_tpu
(the JAX package this program was ported from) is loaded once the window
has closed.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

from . import common  # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "hover_net_tpu")


def forbidden_modules(names=None) -> list:
    """The top-level names of `names` (default: sys.modules) that are
    forbidden, each compared whole: `hover_net_tpu_torch` is not
    `hover_net_tpu`."""
    names = sys.modules if names is None else names
    return sorted({n.split(".")[0] for n in names} & set(FORBIDDEN))


def parse(argv):
    p = argparse.ArgumentParser("benchmark.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def cell_metrics(bench: dict, cell: str):
    """(end-to-end metric entries, per-layer metric entries) of `cell`."""
    e2e = [m for m in bench["end_to_end"]
           if cell in m.get("workloads", [cell])]
    moved = {m["name"] for m in e2e}
    per_layer = [m for m in bench["per_layer"]
                 if cell in m.get("workloads", [cell]) and m["moves"] in moved]
    return e2e, per_layer


def read_metric(name: str, facts: dict):
    """benchmark/metrics/<name>.py's `read(facts)`: a number, or None where
    it finds nothing to read."""
    path = os.path.join(common.HERE, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        f"benchmark.metrics.{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(facts)


def make_context(args) -> common.Context:
    bench = common.load_json("BENCHMARK.json")
    names = [w["name"] for w in bench["workloads"]]
    if args.workload not in names:
        raise SystemExit(f"unknown workload {args.workload!r}; "
                         f"BENCHMARK.json has {names}")
    cell = common.load_json("benchmark", "workloads", f"{args.workload}.json")
    cfg = common.load_json("benchmark", "configs", f"{cell['config']}.json")
    # numpy's seeds are non-negative: a negative --seed maps to its
    # two's complement
    return common.Context(seed=args.seed % (1 << 64), seconds=args.seconds,
                          trace=bool(args.trace), cell=cell, cfg=cfg,
                          bench=bench, t0=T0)


def check_cuda(chips: int):
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        raise SystemExit(f"this cell needs {chips} CUDA card(s); torch sees "
                         f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")


def judge(checks: dict, failed: int = 0) -> bool:
    """`correct`: nothing failed, something was compared, and every
    number of `checks` ({name: [value, limit]}) is within its limit."""
    return (failed == 0 and bool(checks)
            and all(v <= lim for v, lim in checks.values()))


def assemble(ctx: common.Context, out: dict) -> dict:
    """The result line from a traffic module's output: {"e2e": {name: value},
    "facts": {...} (trace runs), "trace": summary (trace runs),
    "attempted", "failed", "checks": {name: [value, limit]}, "device"}."""
    e2e, per_layer = cell_metrics(ctx.bench, ctx.cell["name"])
    metrics = {}
    if not ctx.trace:
        for m in e2e:
            v = out["e2e"].get(m["name"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        for m in per_layer:
            v = read_metric(m["name"], out["facts"])
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    checks = out["checks"]
    result = {"correct": judge(checks, out["failed"]),
              "attempted": out["attempted"],
              "failed": out["failed"], "metrics": metrics,
              "device": out["device"]}
    if ctx.trace:
        from .trace import breakdown

        result["device"]["busy_s"] = out["trace"]["busy_s"]
        result["device"]["window_s"] = out["trace"]["window_s"]
        result["breakdown"] = breakdown(out["trace"])
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result


def execute(ctx: common.Context) -> dict:
    """Drive the cell of `ctx` once; returns its result (None when a
    forbidden module is loaded)."""
    traffic = importlib.import_module(f"benchmark.traffic.{ctx.cell['kind']}")
    try:
        out = traffic.run(ctx)
    finally:
        ctx.cleanup()
    found = forbidden_modules()
    if found:
        common.log(f"forbidden modules loaded in this process: {found}")
        return None
    return assemble(ctx, out)


def main(argv=None) -> int:
    args = parse(sys.argv[1:] if argv is None else argv)
    common.setup_env()
    ctx = make_context(args)
    check_cuda(int(next(w for w in ctx.bench["workloads"]
                        if w["name"] == args.workload)["chips"]))
    try:
        result = execute(ctx)
    finally:
        common.stop_children()
    if result is None:
        return 3
    for name, c in result["checks"].items():
        common.log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
