"""Data-parallel train steps on given global batches, and the same steps in
one process: the exactness check of multi-device training.

`rank_steps` runs `make_train_step(..., group=...)` on one rank per
device (`run_ranks`), each rank on its consecutive shard of every global
batch; `one_process_steps` runs the same steps on the whole global
batches in this process. Both start from the same state dict and
return, per case, the loss terms of every step, the gradients of the
first step (averaged over the ranks), the state after the last step and,
across ranks, whether every rank ended bit-identical to rank 0.
`dryrun_and_rank_steps` runs the train-step dryrun of
`train_parallel.dryrun_train_step` and then `rank_steps`' cases in one
spawn of the ranks.
tests/test_torch_train_distributed.py holds them against each other and
against the JAX package's meshed step on the CPU, and chip_smoke.py
phase 14 against each other on the card, both through `misses`.

The steps run with cuDNN's TF32 off: a TF32 convolution rounds at ~1e-3,
where the ranks' partial sums and the one process's whole sums must
agree to float32's ~1e-7 in the heads of a float64 body. On the card at
width 64 the heads and the loss run in float64 too (`head_dtype`): there
float32 roundings leave some gradients near Adam's eps (1e-8), where
Adam turns a rounding into an update of up to ~lr, and three steps carry
that through the model.

A case's `mutation` runs a deliberately wrong design, the negative
controls of those checks: "local_bn" takes BatchNorm's moments per rank
(as a per-device DataParallel does), "sum_grads" sums the ranks'
gradients instead of averaging them.
"""

from __future__ import annotations

import contextlib
from typing import Dict, List, Optional, Sequence, Tuple
from unittest import mock

import numpy as np
import torch

from ..models.hovernet import HoVerNet, HoVerNetConfig
from . import distributed
from . import train_parallel as tp


def _mutated(mutation: Optional[str]):
    if mutation is None:
        return contextlib.nullcontext()
    if mutation == "local_bn":
        return mock.patch.object(
            tp, "global_batch_stats",
            lambda net, reduce: contextlib.nullcontext())
    if mutation == "sum_grads":
        return mock.patch.object(tp, "average_", distributed.sum_)
    raise ValueError(f"unknown mutation {mutation!r}")


def _cpu_state(net) -> Dict[str, torch.Tensor]:
    return {k: v.detach().cpu().clone() for k, v in net.state_dict().items()}


def _steps(cfg, state_dict, batches, freeze, schedule, device, group=None,
           shard=slice(None), ctx=None):
    """Run the steps; returns ({"terms": of every step, "grads": of step 1,
    "state": after the last}, on the CPU; the model). A rank's `ctx` marks
    its first step."""
    net = HoVerNet(cfg)
    net.load_state_dict(state_dict, strict=True)
    tx, sched = tp.make_optimizer(**schedule)
    state = tp.init_train_state(net, tx, device)
    step = tp.make_train_step(net, sched, freeze_encoder=freeze,
                              group=group)
    run = {"terms": []}
    with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
        for batch in batches:
            part = {k: torch.from_numpy(np.ascontiguousarray(v[shard]))
                    .to(device) for k, v in batch.items()}
            state, (out, _) = step(state, part)
            run["terms"].append({k: float(v) for k, v in out.items()})
            if ctx is not None:
                ctx.mark("first step")
            if "grads" not in run:
                run["grads"] = {k: p.grad.detach().cpu().clone()
                                for k, p in net.named_parameters()
                                if p.grad is not None}
    run["state"] = _cpu_state(net)
    return run, net


def _rank(ctx, cfg, state_dict, batches, cases, schedule):
    per = batches[0]["img"].shape[0] // ctx.world_size
    shard = slice(ctx.rank * per, (ctx.rank + 1) * per)
    out = []
    for freeze, mutation in cases:
        with _mutated(mutation):
            run, net = _steps(cfg, state_dict, batches, freeze, schedule,
                              ctx.device, ctx.group, shard, ctx)
        run["equal"] = distributed.replicas_equal(
            distributed.module_tensors(net), ctx.group)
        out.append(run if ctx.rank == 0 else None)
    return out


def rank_steps(devices: Sequence, cfg: HoVerNetConfig,
               state_dict: Dict[str, torch.Tensor], batches: List[dict],
               cases: Sequence[Tuple[bool, Optional[str]]],
               schedule: dict, timeout_s: float = 600.0) -> List[dict]:
    """Per case (freeze_encoder, mutation): rank 0's run after the
    data-parallel steps over `devices` (one rank each; a device may
    repeat) on the global `batches` (numpy dicts whose leading axis the
    ranks split evenly): {"terms" of every step, "grads" of step 1,
    "state" after the last, "equal": whether every
    rank ended with rank 0's parameters and buffers, bit for bit}.
    `schedule`: the keyword arguments of `make_optimizer`."""
    results = distributed.run_ranks(
        _rank, devices, (cfg, state_dict, batches, list(cases), schedule),
        timeout_s=timeout_s)
    return results[0]


def _dryrun_and_rank(ctx, cfg, state_dict, batches, cases, schedule):
    return (tp._dryrun_rank(ctx, ctx.world_size),
            _rank(ctx, cfg, state_dict, batches, cases, schedule))


def dryrun_and_rank_steps(devices: Sequence, cfg: HoVerNetConfig,
                          state_dict: Dict[str, torch.Tensor],
                          batches: List[dict],
                          cases: Sequence[Tuple[bool, Optional[str]]],
                          schedule: dict, timeout_s: float = 600.0
                          ) -> Tuple[float, List[dict]]:
    """`train_parallel.dryrun_train_step(len(devices), devices)` and then
    `rank_steps(devices, ...)` in one spawn of the ranks (a spawn costs
    seconds of imports and device start-up): the dryrun's checks and
    line, then (its loss, `rank_steps`' result)."""
    results = distributed.run_ranks(
        _dryrun_and_rank, devices,
        (cfg, state_dict, batches, list(cases), schedule),
        timeout_s=timeout_s)
    loss = tp.check_dryrun([r[0] for r in results], len(devices))
    return loss, results[0][1]


def one_process_steps(device, cfg: HoVerNetConfig,
                      state_dict: Dict[str, torch.Tensor],
                      batches: List[dict], freeze: bool,
                      schedule: dict) -> dict:
    """The run of the same steps on the whole global batches in this
    process, on `device` (the keys of `rank_steps`' but "equal")."""
    return _steps(cfg, state_dict, batches, freeze, schedule, device)[0]


def misses(got: dict, want: dict, start: Dict[str, torch.Tensor],
           params: Sequence[str], frozen: Sequence[str],
           lr: float) -> Dict[str, float]:
    """{check: worst error / its tolerance} of the run `got` against
    `want` (a ratio above 1 fails the check), with the tolerances of
    tests/test_torch_train_step.py: loss terms 1e-5 relative and
    `grad_norm` 1e-4 relative at every step; each gradient of step 1
    within 1e-4 of its tensor's largest magnitude and each parameter
    within 0.1 * lr after the last step (the `params` not in `frozen`);
    the BN running stats within 1e-5 of their tensor's largest magnitude;
    `frozen` parameters without gradient and bit-identical to `start`
    (else the ratio is inf)."""
    def arr(d, k):
        return d[k].detach().double().cpu().numpy()

    out = {"terms": max(
        abs(g[k] - w[k]) / ((1e-4 if k == "grad_norm" else 1e-5) * abs(w[k]))
        for g, w in zip(got["terms"], want["terms"]) for k in w)}
    out["frozen"] = 0.0 if all(
        k not in got["grads"]
        and torch.equal(got["state"][k].float(), start[k].float())
        for k in frozen) else float("inf")
    trained = [k for k in params if k not in frozen]
    out["grads"] = max(
        np.abs(arr(got["grads"], k) - arr(want["grads"], k)).max()
        / (1e-4 * np.abs(arr(want["grads"], k)).max()) for k in trained)
    out["params"] = max(
        np.abs(arr(got["state"], k) - arr(want["state"], k)).max()
        / (0.1 * lr) for k in trained)
    out["bn_stats"] = max(
        np.abs(arr(got["state"], k) - arr(want["state"], k)).max()
        / (1e-5 * np.abs(arr(want["state"], k)).max())
        for k in want["state"]
        if k.endswith(("running_mean", "running_var")))
    return out
