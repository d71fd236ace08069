"""Model summary: per-parameter table of an `nn.Module`
(run_utils/utils.py:77-201 `get_model_summary` analog).

The port's counterpart of hover_net_tpu/utils/summary.py: the same table
layout and totals, read from `named_parameters()` and the BatchNorm
running statistics instead of a flax variables tree. `batch-stat
buffers` counts running mean and running var, not `num_batches_tracked`
(flax keeps no such counter), so both totals equal the JAX summary's for
the same config.
"""

from __future__ import annotations

from torch import nn

_BATCH_STATS = ("running_mean", "running_var")


def model_summary(model: nn.Module, max_rows: int = 0) -> str:
    rows = []
    total = 0
    for name, param in sorted(model.named_parameters()):
        n = param.numel()
        total += n
        rows.append((name, str(tuple(param.shape)), n))
    if max_rows and len(rows) > max_rows:
        rows = rows[:max_rows] + [("...", "", 0)]
    name_w = max(len(r[0]) for r in rows)
    shape_w = max(len(r[1]) for r in rows)
    lines = [f"{'name':<{name_w}}  {'shape':<{shape_w}}  params"]
    for name, shape, n in rows:
        lines.append(f"{name:<{name_w}}  {shape:<{shape_w}}  {n:,}")
    lines.append(f"total parameters: {total:,}")
    stats = [b for name, b in model.named_buffers()
             if name.rsplit(".", 1)[-1] in _BATCH_STATS]
    if stats:
        lines.append(f"batch-stat buffers: {sum(b.numel() for b in stats):,}")
    return "\n".join(lines)
