"""The port's float32 train and eval steps against the JAX package's, on
the CPU.

The trainer's own dtype. Same geometry, batches and schedule as
tests/test_torch_train_step.py, which checks every gradient and BN
statistic with the model body in float64; here the weights come from the
port's seeded init and reach JAX through `jax_from_state_dict`. In
float32 this random width-8 net is chaotic (a ReLU input or a BN
variance near zero rounds differently), so the checks are what float32
allows: each bound is 4-5x the worst that the two steps differed by over
five seed pairs of weights and batches, in both freeze modes:
- loss terms after step 1: 1e-3 relative (worst 2.2e-4, msge);
- `grad_norm`: 1e-2 relative (worst 2.1e-3);
- all gradients together: relative L2 distance <= 0.1 (worst 2.4e-2);
- frozen parameters: no gradient, bit-identical after 3 steps;
- parameters after 3 steps: within 2.02 * (sum of the step lrs)
  absolute, the most two Adam runs can part by (an update of the first
  three steps is at most 1.004 * lr; worst 0.97 of the bound);
- `make_eval_step` on the start weights: prob_np and pred_hv within 1e-5
  of their scale, and the same type argmax.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hover_net_tpu.models import HoVerNet as JaxHoVerNet
from hover_net_tpu.models import HoVerNetConfig as JaxConfig
from hover_net_tpu.parallel import train_parallel as j_tp
from hover_net_tpu_torch.models.checkpoints import (
    jax_from_state_dict,
    state_dict_from_jax,
)
from hover_net_tpu_torch.models.hovernet import HoVerNet
from hover_net_tpu_torch.parallel import train_parallel as t_tp
from test_torch_train_step import (
    CFG,
    LR,
    batches,
    check_frozen,
    param_keys,
    run_jax,
    run_port,
)


@pytest.fixture(scope="module")
def setup():
    net = HoVerNet(CFG, generator=torch.Generator().manual_seed(3))
    variables = jax_from_state_dict(net.state_dict(), CFG)
    return variables, batches(seed=1)


@pytest.mark.parametrize("freeze", [True, False], ids=["frozen", "full"])
def test_float32_train_step_matches_jax(setup, freeze):
    variables, data = setup
    (j_terms, j_grads), j_final = run_jax(variables, data, freeze)
    (t_terms, t_grads), t_final = run_port(variables, data, freeze)
    j_terms, t_terms = j_terms[0], t_terms[0]

    assert t_terms.keys() == j_terms.keys()
    for k, want in j_terms.items():
        tol = 1e-2 if k == "grad_norm" else 1e-3
        assert abs(t_terms[k] - want) <= tol * abs(want), (k, t_terms[k], want)

    start = state_dict_from_jax(variables, CFG)
    j_grad_sd = state_dict_from_jax(
        {"params": j_grads, "batch_stats": variables["batch_stats"]}, CFG)
    j_sd = state_dict_from_jax(j_final, CFG)
    frozen = check_frozen(freeze, t_grads, j_grad_sd, t_final, j_sd, start)

    live = [k for k in param_keys() if k not in frozen]
    diff = sum(float(((t_grads[k] - j_grad_sd[k]) ** 2).sum()) for k in live)
    norm = sum(float((j_grad_sd[k] ** 2).sum()) for k in live)
    assert np.sqrt(diff / norm) <= 0.1

    lr_sum = LR * 2 + LR * 0.1
    for key in live:
        assert (t_final[key] - j_sd[key]).abs().max() <= 2.02 * lr_sum, key


def test_eval_step_matches_jax(setup):
    variables, data = setup
    imgs = data[0]["img"]
    model = JaxHoVerNet(JaxConfig(mode="fast", nr_types=CFG.nr_types,
                                  width=CFG.width))
    want = j_tp.make_eval_step(model)(
        jax.tree_util.tree_map(jnp.asarray, variables), jnp.asarray(imgs))
    net = HoVerNet(CFG)
    net.load_state_dict(state_dict_from_jax(variables, CFG), strict=True)
    got = t_tp.make_eval_step(net)(net, torch.from_numpy(imgs))
    assert got.keys() == want.keys()
    for k, w in want.items():
        w, g = np.asarray(w), got[k].numpy()
        assert g.shape == w.shape, k
        if k == "pred_tp":
            assert np.array_equal(g, w)
        else:
            assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max(), k
