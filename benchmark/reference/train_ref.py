"""The reference's training steps, and what decides a training cell's
`correct`.

The reference starts from the benchmark's own initial weights, takes the
batches the program's step consumed (the loader's augmented images and
their targets: the augmentation draws from worker processes seeded by
their process ids, so it cannot be drawn again), and takes the same steps
in plain PyTorch, float32 with TF32 off: the reference model in train
mode, the loss of reference/losses.py, Adam (0.9, 0.999, 1e-8) at the
program's learning rate.

Compared, each against the reference (norms by leaf, a leaf being one
parameter tensor):

- `fwd_err`: step 1's own outputs (the np probabilities and hv maps of
  the first two samples, which the step returns for the engine's
  snapshots) against the reference's first forward: ||P - R|| / ||R||;
- `loss_gap`: the largest relative gap of a step's loss over the steps;
- `grad_gap`: step 1's gradient as the program's optimizer got it, read
  back from Adam's first moment after that step (exp_avg / (1 - beta1)):
  the largest gap between the program's and the reference's norm of a
  leaf, over the larger of the reference's norm of that leaf and of the
  median leaf;
- `change_gap`: the same of each leaf's change over the steps.

Leaves whose reference gradient at step 1 is under a thousandth of the
median leaf's are left out of both gaps: Adam moves them by round-off
alone.
"""

from __future__ import annotations

from typing import Dict, List

import torch

from .losses import hovernet_loss
from .model import HoVerNetRef, strict_fp32

BETA1 = 0.9


def leaf_gaps(prog: Dict[str, torch.Tensor], ref: Dict[str, torch.Tensor],
              keep) -> list:
    """|‖prog‖ - ‖ref‖| / max(‖ref‖, median ‖ref‖) of each kept leaf."""
    rn = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in keep}
    pn = {k: float(torch.linalg.vector_norm(prog[k].double())) for k in keep}
    med = float(torch.tensor(list(rn.values())).median())
    return [abs(pn[k] - rn[k]) / max(rn[k], med) for k in keep]


def follow(cfg: dict, init: Dict[str, torch.Tensor], batches: List[dict],
           lr: float, device: str):
    """The reference's steps over `batches` from `init`: (losses, step 1's
    gradients, the parameters after the last step, step 1's np
    probabilities and hv maps of the first two samples)."""
    model = HoVerNetRef(cfg["mode"], cfg["nr_types"], cfg["width"])
    model.load_state_dict(init)
    model.to(device).train()
    opt = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999),
                           eps=1e-8)
    losses, grads, out1 = [], None, None
    with strict_fp32():
        for b in batches:
            out = model(b["img"].permute(0, 3, 1, 2))
            if out1 is None:
                out1 = {"np": torch.softmax(out["np"], 1)[:2, 1].detach(),
                        "hv": out["hv"][:2].permute(0, 2, 3, 1).detach()}
            loss, _ = hovernet_loss(out, b["np_map"], b["hv_map"],
                                    b.get("tp_map"))
            opt.zero_grad(set_to_none=True)
            loss.backward()
            if grads is None:
                grads = {k: p.grad.detach().clone()
                         for k, p in model.named_parameters()}
            opt.step()
            losses.append(loss.item())
    params = {k: p.detach().clone() for k, p in model.named_parameters()}
    return losses, grads, params, out1


def numbers(cfg, init, batches, lr, device, prog_losses, prog_grad1,
            prog_params, prog_out1) -> dict:
    """The compared numbers of a training cell, and readings beside them."""
    losses, grads, params, out1 = follow(cfg, init, batches, lr, device)
    diff = sum(float(((prog_out1[k].double() - out1[k].double()) ** 2).sum())
               for k in out1)
    norm = sum(float((out1[k].double() ** 2).sum()) for k in out1)
    loss_gaps = [abs(p - r) / abs(r) for p, r in zip(prog_losses, losses)]
    gn = {k: float(torch.linalg.vector_norm(g.double()))
          for k, g in grads.items()}
    med = float(torch.tensor(list(gn.values())).median())
    keep = [k for k, v in gn.items() if v >= 1e-3 * med]
    change_ref = {k: params[k] - init[k].to(device) for k in keep}
    change_prog = {k: prog_params[k] - init[k].to(device) for k in keep}
    grad_gaps = leaf_gaps(prog_grad1, grads, keep)
    change_gaps = leaf_gaps(change_prog, change_ref, keep)
    med = lambda v: float(torch.tensor(v).median())
    return {"fwd_err": (diff / norm) ** 0.5,
            "loss_gap": max(loss_gaps), "grad_gap": max(grad_gaps),
            "change_gap": max(change_gaps), "loss_gap_step1": loss_gaps[0],
            "grad_gap_median_leaf": med(grad_gaps),
            "change_gap_median_leaf": med(change_gaps),
            "left_out": len(gn) - len(keep), "losses": losses}
