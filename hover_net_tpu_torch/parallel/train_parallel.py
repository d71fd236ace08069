"""The train and eval steps on one device.

Counterpart of hover_net_tpu/parallel/train_parallel.py (single device;
its mesh, data parallelism and `dryrun_train_step` are not ported).
Semantics are the reference's run_desc.py:12-109: forward in train mode,
softmaxed NP/TP heads in float32, one-hot targets, the 4/6-term weighted
loss, an Adam update. As in the JAX package:

- Adam is optax's `scale_by_adam(0.9, 0.999, 1e-8)` scaled by a
  one-boundary step schedule (lr, then lr * gamma from update
  `step_epochs * steps_per_epoch` on), read per update from the plain
  `schedule(step)` function; `torch.optim.Adam` computes the same update
  and leaves a parameter without gradient (the frozen encoder) exactly as
  it is, as optax's zero update does;
- `grad_norm` is the global norm over every parameter's gradient, a
  frozen one counting as zero;
- loss scalars stay on the device; the caller pulls them.

The step runs in float32 (the JAX trainer sets no dtype); on the card,
cuDNN's convolutions keep PyTorch's default TF32 (see PERF.md).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Dict, Optional

import torch
import torch.nn.functional as F

from ..infer.base import resolve_device
from ..models.hovernet import HoVerNet
from ..ops.losses import hovernet_loss


@dataclasses.dataclass
class TrainState:
    """The model (parameters and BN running stats), its optimizer, and the
    count of updates taken."""

    model: HoVerNet
    optimizer: torch.optim.Optimizer
    step: int = 0


def make_optimizer(lr: float = 1.0e-4, step_epochs: int = 25,
                   steps_per_epoch: int = 1, gamma: float = 0.1):
    """Adam(lr, betas 0.9/0.999) + StepLR(25 epochs, x0.1)
    (opt.py:37-45) as (tx, schedule): `tx(params)` builds the optimizer,
    `schedule(step)` is the learning rate of update `step` (0-based)."""
    boundary = step_epochs * steps_per_epoch

    def schedule(step: int) -> float:
        return lr if step < boundary else lr * gamma

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


def _one_hot(labels: torch.Tensor, n: int) -> torch.Tensor:
    """[N, h, w] int -> [N, n, h, w] float32 one-hot."""
    return _nchw(F.one_hot(labels.long(), n).float())


def make_train_step(model: HoVerNet, schedule: Callable[[int], float],
                    freeze_encoder: bool = False,
                    loss_weights: Optional[dict] = None):
    """Returns (state, batch) -> (state, (terms, viz)), updating `state`
    in place.

    batch: img [N,H,W,3] (0..255), np_map [N,h,w] int, hv_map [N,h,w,2]
    float, tp_map [N,h,w] int (optional), as tensors on the model's
    device. terms: the loss terms, `overall_loss` and `grad_norm` as
    0-d device tensors. viz: 2-sample prediction snapshots, NHWC.
    """
    nr_types = model.cfg.nr_types

    def step_fn(state: TrainState, batch: Dict[str, torch.Tensor]):
        net, opt = state.model, state.optimizer
        net.train()
        true_np = _one_hot(batch["np_map"], 2)
        true = {"np": true_np, "hv": _nchw(batch["hv_map"].float())}
        if nr_types is not None:
            true["tp"] = _one_hot(batch["tp_map"], nr_types)

        out = net(_nchw(batch["img"]), freeze_encoder=freeze_encoder)
        pred = {"np": F.softmax(out["np"].float(), dim=1),
                "hv": out["hv"].float()}
        if nr_types is not None:
            pred["tp"] = F.softmax(out["tp"].float(), dim=1)
        total, terms = hovernet_loss(pred, true, true_np[:, 1],
                                     weights=loss_weights)

        opt.zero_grad(set_to_none=True)
        total.backward()
        grads = [p.grad for p in net.parameters() if p.grad is not None]
        terms["grad_norm"] = torch.linalg.vector_norm(
            torch.stack([torch.linalg.vector_norm(g) for g in grads]))
        for group in opt.param_groups:
            group["lr"] = schedule(state.step)
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
