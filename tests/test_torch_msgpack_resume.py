"""Resuming a phase the JAX trainer began: the next train step of the port
equals the JAX package's, on the CPU.

The JAX package's `make_train_step` (the width-8 typed model and 96^2 ->
4^2 batches of tests/test_torch_train_step.py, its body in float64) takes
K steps from a jitted init; its state, rounded to float32 as the JAX
trainer holds it, is written by the JAX package's `RunInfo.save_checkpoint`
(`net_epoch=1.msgpack` and `.opt`). Then each package resumes from that
pair as its trainer does (the JAX `TrainManager`'s `load_checkpoint`
with the optax target; the port's `load_train_msgpack`) and takes step
K + 1 on the same batch, in both freeze modes, with the tolerances of
`test_train_step_matches_jax`: loss terms 1e-5 and grad_norm 1e-4
relative, each parameter within 0.1 * lr of JAX's after the step. The
schedule halves lr at update K, so the resumed step count sets the lr
as well as Adam's bias corrections. The port's Adam state after the step,
mapped back to optax, is JAX's (count K + 1; the frozen encoder's
moments zero on both sides).

Negative control: the same resume with the `.opt`'s nu dropped (zeroed)
misses the parameter bound on many tensors.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hover_net_tpu.models import HoVerNet as JaxHoVerNet
from hover_net_tpu.models import HoVerNetConfig as JaxConfig
from hover_net_tpu.models import checkpoints as j_ckpt
from hover_net_tpu.parallel import train_parallel as j_tp
from hover_net_tpu.train.manager import RunInfo as JaxRunInfo
from hover_net_tpu_torch.models import checkpoints as t_ckpt
from hover_net_tpu_torch.models.hovernet import HoVerNet, HoVerNetConfig
from hover_net_tpu_torch.parallel import train_parallel as t_tp

from test_torch_train_step import (
    CFG, LR, NR_TYPES, WIDTH, batches, flat, is_frozen, jax_variables,
    param_keys,
)

K = 2  # steps the JAX side takes before it saves
# lr for updates 0 and 1, lr / 2 from update K = 2 on
SCHEDULE = dict(lr=LR, step_epochs=1, steps_per_epoch=K, gamma=0.5)


@pytest.fixture(scope="module")
def setup():
    data = batches()
    assert len(data) >= K + 1
    return jax_variables(), data


def tree_cast(tree, dtype):
    """Floating leaves to `dtype`; integer leaves (optax counts) kept."""
    return jax.tree_util.tree_map(
        lambda v: (jnp.asarray(v, dtype)
                   if jnp.issubdtype(jnp.asarray(v).dtype, jnp.floating)
                   else jnp.asarray(v)), tree)


def jax_resume(variables, data, freeze, path):
    """K JAX steps (float64 body), the float32 state saved at `path`, then
    the JAX trainer's resume of that file and step K + 1. Returns (terms of
    step K + 1, {params, batch_stats} and opt_state after it, as numpy)."""
    model = JaxHoVerNet(JaxConfig(mode="fast", nr_types=NR_TYPES,
                                  width=WIDTH, dtype=jnp.float64))
    tx, schedule = j_tp.make_optimizer(**SCHEDULE)
    with jax.enable_x64(True):
        params = tree_cast(variables["params"], jnp.float64)
        state = j_tp.TrainState(
            params=params,
            batch_stats=tree_cast(variables["batch_stats"], jnp.float64),
            opt_state=tx.init(params), step=jnp.zeros((), jnp.int32))
        step = j_tp.make_train_step(model, tx, freeze_encoder=freeze)
        for batch in data[:K]:
            state, _ = step(state, batch)
        # the JAX trainer's state is float32
        saved = state.replace(params=tree_cast(state.params, jnp.float32),
                              batch_stats=tree_cast(state.batch_stats,
                                                    jnp.float32),
                              opt_state=tree_cast(state.opt_state,
                                                  jnp.float32))
        JaxRunInfo(model, tx, schedule, saved).save_checkpoint(path)

        # TrainManager.run_once's resume
        loaded, extra = j_ckpt.load_checkpoint(path)
        opt_state, _ = j_ckpt.load_checkpoint(path + ".opt",
                                              target=saved.opt_state)
        resumed = state.replace(
            params=tree_cast(loaded["params"], jnp.float64),
            batch_stats=tree_cast(loaded["batch_stats"], jnp.float64),
            opt_state=tree_cast(opt_state, jnp.float64),
            step=jnp.asarray(extra.get("step", 0), jnp.int32))
        state, (terms, _) = step(resumed, data[K])
        final = jax.tree_util.tree_map(np.asarray, {
            "params": state.params, "batch_stats": state.batch_stats})
        return ({k: float(v) for k, v in terms.items()}, final,
                jax.tree_util.tree_map(np.asarray, state.opt_state))


def port_resume(data, freeze, path, drop_nu=False):
    """The port trainer's resume of `path` (`load_train_msgpack`, float64
    body) and step K + 1: (terms, state dict, the Adam state as optax)."""
    net = HoVerNet(HoVerNetConfig(mode="fast", nr_types=NR_TYPES,
                                  width=WIDTH, dtype=torch.float64))
    desc, opt_state, step = t_ckpt.load_train_msgpack(path, net)
    net.load_state_dict(desc, strict=True)
    assert step == K
    if drop_nu:
        for s in opt_state["state"].values():
            s["exp_avg_sq"].zero_()
    tx, schedule = t_tp.make_optimizer(**SCHEDULE)
    state = t_tp.init_train_state(net, tx, "cpu")
    state.optimizer.load_state_dict(opt_state)
    state.step = step
    train_step = t_tp.make_train_step(net, schedule, freeze_encoder=freeze)
    state, (terms, _) = train_step(state, {k: torch.from_numpy(v) for k, v
                                           in data[K].items()})
    assert state.step == K + 1
    opt_tree = t_ckpt.optax_from_adam_state(
        state.optimizer.state_dict(), CFG, net, state.step)
    return ({k: float(v) for k, v in terms.items()}, net.state_dict(),
            opt_tree)


def misses(t_terms, t_final, j_terms, j_final):
    """The checks of `test_train_step_matches_jax` that fail: loss terms
    1e-5 and grad_norm 1e-4 relative, parameters 0.1 * lr absolute."""
    bad = []
    for k, w in j_terms.items():
        tol = 1e-4 if k == "grad_norm" else 1e-5
        if abs(t_terms[k] - w) > tol * abs(w):
            bad.append(k)
    j_sd = t_ckpt.state_dict_from_jax(j_final, CFG)
    for key in param_keys():
        got, want = t_final[key].double().numpy(), j_sd[key].double().numpy()
        if np.abs(got - want).max() > 0.1 * LR:
            bad.append(key)
    return bad


@pytest.fixture(scope="module", params=[True, False],
                ids=["frozen", "full"])
def resumed(request, setup, tmp_path_factory):
    variables, data = setup
    freeze = request.param
    path = str(tmp_path_factory.mktemp("phase") / "net_epoch=1.msgpack")
    return freeze, data, path, jax_resume(variables, data, freeze, path)


def test_resumed_step_matches_jax(resumed):
    freeze, data, path, (j_terms, j_final, j_opt) = resumed
    t_terms, t_final, t_opt = port_resume(data, freeze, path)
    assert misses(t_terms, t_final, j_terms, j_final) == []

    # the updates of the step were taken (lr / 2 of a parameter's scale)
    start, _ = t_ckpt.load_checkpoint(path)
    start = t_ckpt.state_dict_from_jax(start, CFG)
    moved = [k for k in param_keys()
             if not torch.equal(t_final[k].float(), start[k])]
    frozen = [k for k in param_keys() if freeze and is_frozen(k)]
    assert sorted(moved) == sorted(set(param_keys()) - set(frozen))

    # the Adam state after the step, as optax: JAX's
    assert int(t_opt["0"]["count"]) == int(t_opt["1"]["count"]) == K + 1
    assert int(j_opt[0].count) == int(j_opt[1].count) == K + 1
    for part in ("mu", "nu"):
        got = dict(flat(t_opt["0"][part]))
        want = dict(flat(getattr(j_opt[0], part)))
        assert got.keys() == want.keys()
        for k, w in want.items():
            frozen_leaf = freeze and is_frozen(
                next(n for n, p, _ in t_ckpt.name_map(CFG)
                     if p == ("params",) + k))
            if frozen_leaf:
                assert not got[k].any() and not w.any(), k
                continue
            scale = np.abs(w).max()
            assert scale > 0, k
            assert np.abs(got[k] - w).max() <= 1e-4 * scale, (part, k)


def test_resume_without_nu_misses(resumed):
    """Negative control: nu carried as zeros gives another step."""
    freeze, data, path, (j_terms, j_final, _) = resumed
    t_terms, t_final, _ = port_resume(data, freeze, path, drop_nu=True)
    bad = misses(t_terms, t_final, j_terms, j_final)
    assert len(bad) > 20, bad
