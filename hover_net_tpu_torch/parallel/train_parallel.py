"""The train and eval steps, on one device or data-parallel across ranks.

Counterpart of hover_net_tpu/parallel/train_parallel.py. Semantics are
the reference's run_desc.py:12-109: forward in train mode, softmaxed
NP/TP heads in the model's `head_dtype` (float32), one-hot targets, the
4/6-term weighted loss, an Adam update. As in the JAX package:

- Adam is optax's `scale_by_adam(0.9, 0.999, 1e-8)` scaled by a
  one-boundary step schedule (lr, then lr * gamma from update
  `step_epochs * steps_per_epoch` on), read per update from the plain
  `schedule(step)` function; `torch.optim.Adam` computes the same update
  and leaves a parameter without gradient (the frozen encoder) exactly as
  it is, as optax's zero update does;
- `grad_norm` is the global norm over every parameter's gradient, a
  frozen one counting as zero;
- loss scalars stay on the device; the caller pulls them.

Across devices (`make_train_step(..., group=...)`, one process a device,
parallel/distributed.py) the step computes what the JAX package's meshed
step computes over the global batch, each rank holding a consecutive
shard of it: the loss terms are ratios of global sums, BatchNorm
normalises by the global batch's moments and folds them into its running
stats, and the gradients are averaged over the ranks, which makes them
the gradient of the global loss (every rank holds that loss, and the
backward of each summing all-reduce adds the ranks' gradients). Every
rank then takes the same Adam update and ends the step with
bit-identical parameters and buffers.

The step runs in float32 (the JAX trainer sets no dtype); on the card,
cuDNN's convolutions keep PyTorch's default TF32 (see PERF.md).
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Callable, Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..models.blocks import global_batch_stats
from ..models.hovernet import HoVerNet, HoVerNetConfig
from ..ops.losses import hovernet_loss
from ..runtime import span
from .distributed import all_reduce_sum, average_
from .mesh import resolve_device


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BN running stats), its optimizer, and the
    count of updates taken."""

    model: HoVerNet
    optimizer: torch.optim.Optimizer
    step: int = 0


@dataclasses.dataclass(frozen=True)
class StepSchedule:
    """`lr` before update `boundary`, `lr * gamma` from it on (a plain
    object, so that a rank can send its trainer's state back)."""

    lr: float
    boundary: int
    gamma: float

    def __call__(self, step: int) -> float:
        return self.lr if step < self.boundary else self.lr * self.gamma


def make_optimizer(lr: float = 1.0e-4, step_epochs: int = 25,
                   steps_per_epoch: int = 1, gamma: float = 0.1):
    """Adam(lr, betas 0.9/0.999) + StepLR(25 epochs, x0.1)
    (opt.py:37-45) as (tx, schedule): `tx(params)` builds the optimizer,
    `schedule(step)` is the learning rate of update `step` (0-based)."""
    schedule = StepSchedule(lr, step_epochs * steps_per_epoch, gamma)
    tx = functools.partial(torch.optim.Adam, lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    return tx, schedule


def init_train_state(model: HoVerNet, tx, device="cuda") -> TrainState:
    """Move `model` (initialised from its torch.Generator) to `device`
    (the card unless the CPU is asked for; a missing GPU raises) and give
    it a fresh optimizer."""
    model.to(resolve_device(device))
    return TrainState(model=model, optimizer=tx(model.parameters()), step=0)


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)


def _one_hot(labels: torch.Tensor, n: int,
             dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[N, h, w] int -> [N, n, h, w] one-hot."""
    return _nchw(F.one_hot(labels.long(), n).to(dtype))


def make_train_step(model: HoVerNet, schedule: Callable[[int], float],
                    freeze_encoder: bool = False,
                    loss_weights: Optional[dict] = None, group=None,
                    autocast_dtype: Optional[torch.dtype] = None):
    """Returns (state, batch) -> (state, (terms, viz)), updating `state`
    in place.

    batch: img [N,H,W,3] (0..255), np_map [N,h,w] int, hv_map [N,h,w,2]
    float, tp_map [N,h,w] int (optional), as tensors on the model's
    device. terms: the loss terms, `overall_loss` and `grad_norm` as
    0-d device tensors. viz: 2-sample prediction snapshots, NHWC.

    group: None on one device; else the process group of data-parallel
    training, `batch` is this rank's consecutive shard of the global
    batch, and terms and `grad_norm` are the global batch's (the viz
    snapshots are the shard's first two samples: on rank 0 the global
    batch's when a shard holds two or more).

    Each step opens four spans (runtime.span), named in a profiler's
    trace: `hnt.train.forward` (targets, the forward, the heads'
    softmax), `hnt.train.loss`, `hnt.train.backward` (with the ranks'
    gradient average) and `hnt.train.optimizer` (grad norm, lr, Adam).

    autocast_dtype: None, or the body's compute dtype under
    `torch.autocast` (bf16: the JAX package's bf16 training, float32
    parameters and Adam state, a bf16 body, the heads and the loss in
    `head_dtype`). The autocast closes inside the step, around the
    forward only: a caller's autocast around the whole step would also
    run the loss's Sobel convolution (`ops/losses.gradient_hv`) in bf16,
    where the JAX step computes the loss in float32
    (tests/test_torch_train_bf16.py).
    """
    nr_types, dtype = model.cfg.nr_types, model.cfg.head_dtype
    reduce = (None if group is None
              else functools.partial(all_reduce_sum, group=group))

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor]):
        net, opt = state.model, state.optimizer
        net.train()
        with span("hnt.train.forward"):
            true_np = _one_hot(batch["np_map"], 2, dtype)
            true = {"np": true_np, "hv": _nchw(batch["hv_map"].to(dtype))}
            if nr_types is not None:
                true["tp"] = _one_hot(batch["tp_map"], nr_types, dtype)

            img = _nchw(batch["img"])
            body = (torch.autocast(img.device.type, dtype=autocast_dtype)
                    if autocast_dtype is not None
                    else contextlib.nullcontext())
            with global_batch_stats(net, reduce), body:
                out = net(img, freeze_encoder=freeze_encoder)
            pred = {"np": F.softmax(out["np"].to(dtype), dim=1),
                    "hv": out["hv"].to(dtype)}
            if nr_types is not None:
                pred["tp"] = F.softmax(out["tp"].to(dtype), dim=1)
        with span("hnt.train.loss"):
            total, terms = hovernet_loss(pred, true, true_np[:, 1],
                                         weights=loss_weights, reduce=reduce)

        with span("hnt.train.backward"):
            opt.zero_grad(set_to_none=True)
            total.backward()
            # the frozen parameters have no gradient, on every rank alike
            grads = [p.grad for p in net.parameters() if p.grad is not None]
            if group is not None:
                average_(grads, group)
        with span("hnt.train.optimizer"):
            terms["grad_norm"] = torch.linalg.vector_norm(
                torch.stack([torch.linalg.vector_norm(g) for g in grads]))
            for param_group in opt.param_groups:
                param_group["lr"] = schedule(state.step)
            opt.step()
        state.step += 1

        # 2-sample prediction snapshots for the epoch viz panel
        # (run_desc.py:87-108)
        viz = {"np": pred["np"][:2, 1].detach(),
               "hv": pred["hv"][:2].detach().permute(0, 2, 3, 1)}
        if "tp" in pred:
            viz["tp"] = torch.argmax(pred["tp"][:2], dim=1)
        terms = {k: v.detach() for k, v in terms.items()}
        return state, (terms, viz)

    return step_fn


def make_eval_step(model: HoVerNet):
    """Validation forward (run_desc.py:113-167 contract): (model, imgs
    [N,H,W,3]) -> prob_np [N,h,w], pred_hv [N,h,w,2], pred_tp [N,h,w]
    (argmax, float32) if typed, on the model's device."""
    nr_types = model.cfg.nr_types

    @torch.no_grad()
    def step_fn(net: HoVerNet, imgs: torch.Tensor):
        net.eval()
        out = net(_nchw(imgs))
        res = {
            "prob_np": F.softmax(out["np"].float(), dim=1)[:, 1],
            "pred_hv": out["hv"].float().permute(0, 2, 3, 1),
        }
        if nr_types is not None:
            res["pred_tp"] = torch.argmax(out["tp"], dim=1).float()
        return res

    return step_fn


# ----------------------------------------------------------------- dryrun

DRYRUN_TIMEOUT_S = 600.0  # the limit of the dryrun's run_ranks call

def _dryrun_batch(n: int) -> Dict[str, np.ndarray]:
    """The JAX dryrun's global batch: n samples of 96^2 -> 4^2, 5 types."""
    rng = np.random.default_rng(0)
    return {
        "img": rng.uniform(0, 255, (n, 96, 96, 3)).astype(np.float32),
        "np_map": (rng.uniform(0, 1, (n, 4, 4)) > 0.5).astype(np.int32),
        "hv_map": rng.uniform(-1, 1, (n, 4, 4, 2)).astype(np.float32),
        "tp_map": rng.integers(0, 5, (n, 4, 4)).astype(np.int32),
    }


def _dryrun_rank(ctx, n: int):
    """One data-parallel step of the width-8 typed model on this rank's
    shard of `_dryrun_batch(n)`: (overall_loss, whether every rank ends
    with the same parameters and buffers, bit for bit)."""
    from .distributed import module_tensors, replicas_equal

    model = HoVerNet(HoVerNetConfig(mode="fast", nr_types=5, width=8),
                     generator=torch.Generator().manual_seed(0))
    tx, schedule = make_optimizer(steps_per_epoch=10)
    state = init_train_state(model, tx, ctx.device)
    per = n // ctx.world_size
    shard = {k: torch.from_numpy(v[ctx.rank * per:(ctx.rank + 1) * per])
             .to(ctx.device) for k, v in _dryrun_batch(n).items()}
    step = make_train_step(model, schedule, group=ctx.group)
    _, (terms, _) = step(state, shard)
    loss = float(terms["overall_loss"])
    ctx.mark("first step")
    return (loss,
            replicas_equal(module_tensors(model), ctx.group))


def dryrun_devices(n_devices: int, devices=None) -> list:
    """The dryrun's devices: `devices` (its first n), by default
    cuda:0..n-1 (fewer cards raise)."""
    if devices is None:
        devices = [torch.device("cuda", i) for i in range(n_devices)]
        if torch.cuda.device_count() < n_devices:
            raise ValueError(f"need {n_devices} CUDA devices, have "
                             f"{torch.cuda.device_count()}")
    devices = list(devices)[:n_devices]
    if len(devices) != n_devices:
        raise ValueError(f"need {n_devices} devices, got {devices}")
    return devices


def check_dryrun(results, n_devices: int) -> float:
    """The dryrun's checks on every rank's `_dryrun_rank` result: a
    finite loss and bit-identical replicas; prints the JAX dryrun's line
    and returns the loss."""
    loss = results[0][0]
    if not np.isfinite(loss):
        raise AssertionError("non-finite loss in dryrun")
    if not all(r == (loss, True) for r in results):
        raise AssertionError(f"the ranks disagree after one step: {results}")
    print(f"dryrun_multichip ok: {n_devices} devices, loss={loss:.4f}")
    return loss


def dryrun_train_step(n_devices: int, devices=None) -> float:
    """One data-parallel train step over `n_devices` ranks (one process
    each, parallel/distributed.py) on tiny shapes: the real step (full
    model graph at width 8, 5 types, 96^2 -> 4^2, the 6-term loss, Adam,
    the BN stats over the global batch of one sample a rank). `devices`
    defaults to cuda:0..n-1 (fewer cards raise) and may repeat a device,
    e.g. ["cpu"] * n. Checks a finite loss and bit-identical replicas,
    prints the JAX dryrun's line, and returns the loss."""
    from .distributed import run_ranks

    devices = dryrun_devices(n_devices, devices)
    results = run_ranks(_dryrun_rank, devices, (n_devices,),
                        timeout_s=DRYRUN_TIMEOUT_S)
    return check_dryrun(results, n_devices)
