"""One train step of the port against the JAX package's, on the CPU.

A width-8 fast-mode typed model at the 96^2 -> 4^2 geometry of
tests/test_train_e2e.py. The JAX variables come from one jitted init
(module scope) and are carried into the port by `state_dict_from_jax`;
both sides then take the same seeded batches through their
`make_train_step`, with and without the frozen encoder, under the same
one-boundary schedule (lr, lr, lr * 0.1). The JAX gradients are read
from the JAX package's own step: its optimizer is `make_optimizer`'s tx
behind a pass-through transform that keeps the last gradients in its
state (one compile per freeze mode gives both).

Here the model body computes in float64 on both sides (the heads and the
loss stay float32, as both steps cast them): in float32 this random
width-8 net is chaotic — a ReLU input or a BN variance near zero rounds
differently, and single gradient entries of both steps move by up to 7 %
of their tensor's scale against a float64 run
(tests/test_torch_train_step_f32.py holds the float32 step to what float32
allows). With the float64 body the two agree to ~4e-7, so the checks
below see any difference in the graph, the freeze cut, the BN update or
the optimizer:
- loss terms of each of the 3 steps: 1e-5 relative; `grad_norm`: 1e-4
  relative (worst 1.8e-7 over the 3 steps and both freeze modes);
- each gradient of step 1: within 1e-4 of its tensor's largest JAX
  magnitude; a frozen parameter has no gradient in the port and an
  all-zero one in JAX;
- frozen parameters: bit-identical to their start after 3 steps;
- BN running mean and var after 3 steps: within 1e-5 of the tensor's
  largest magnitude (the variance folded in biased, as flax does: the
  unbiased n / (n - 1) would be 3e-3 off at the heads' 32 elements);
- parameters after 3 steps: within 0.1 * lr absolute. The worst gap is
  0.017 * lr (one entry of `decoder.np.u3.conva.weight` whose gradient
  is near Adam's eps); a skipped or sign-flipped update is lr or more.
Step 1's Adam update is +-lr whatever the betas are, and 3 steps barely
see them, so `test_optimizer_matches_optax` holds the optimizer alone to
optax over 40 updates across the schedule's boundary.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from hover_net_tpu.models import HoVerNet as JaxHoVerNet
from hover_net_tpu.models import HoVerNetConfig as JaxConfig
from hover_net_tpu.parallel import train_parallel as j_tp
from hover_net_tpu_torch.models.checkpoints import (
    jax_from_state_dict,
    state_dict_from_jax,
)
from hover_net_tpu_torch.models.hovernet import HoVerNet, HoVerNetConfig
from hover_net_tpu_torch.parallel import train_parallel as t_tp

WIDTH, NR_TYPES, SIZE, OUT, BATCH = 8, 5, 96, 4, 2
LR = 1.0e-4
N_STEPS = 3
# boundary after update 2: lrs LR, LR, LR * 0.1
SCHEDULE = dict(lr=LR, step_epochs=1, steps_per_epoch=2, gamma=0.1)
FROZEN_TOPS = ("d1.", "d2.", "d3.")


def is_frozen(key):
    """Parameters the freeze cut leaves alone: d0's unit towers, d1..d3."""
    return key.startswith(FROZEN_TOPS) or key.startswith("d0.units.")


def batches(seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(N_STEPS):
        out.append({
            "img": rng.integers(0, 256, (BATCH, SIZE, SIZE, 3), np.uint8),
            "np_map": (rng.uniform(0, 1, (BATCH, OUT, OUT)) > 0.4
                       ).astype(np.uint8),
            "hv_map": rng.uniform(-1, 1, (BATCH, OUT, OUT, 2)
                                  ).astype(np.float32),
            "tp_map": rng.integers(0, NR_TYPES, (BATCH, OUT, OUT)
                                   ).astype(np.int32),
        })
    return out


def jax_variables():
    """Flax {params, batch_stats} of one jitted init, as numpy dicts."""
    model = JaxHoVerNet(JaxConfig(mode="fast", nr_types=NR_TYPES,
                                  width=WIDTH))
    variables = jax.jit(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, SIZE, SIZE, 3)),
        train=False))()
    variables = jax.tree_util.tree_map(np.asarray, variables)
    return {k: dict(v) for k, v in variables.items()}


@pytest.fixture(scope="module")
def setup():
    return jax_variables(), batches()


def keep_grads():
    """Pass-through transform whose state is the last gradients."""
    return optax.GradientTransformation(
        lambda params: jax.tree_util.tree_map(jnp.zeros_like, params),
        lambda updates, state, params=None: (updates, updates))


def run_jax(variables, data, freeze, body=jnp.float32):
    """N_STEPS JAX train steps, the model body computing in `body` (the
    heads and the loss stay float32). Returns ((terms of every step,
    grads of step 1), final {params, batch_stats}), as numpy."""
    model = JaxHoVerNet(JaxConfig(mode="fast", nr_types=NR_TYPES,
                                  width=WIDTH, dtype=body))
    tx, _ = j_tp.make_optimizer(**SCHEDULE)
    tx = optax.chain(keep_grads(), tx)
    with jax.enable_x64(body == jnp.float64):
        cast = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda v: jnp.asarray(v, body), t)
        params = cast(variables["params"])
        state = j_tp.TrainState(
            params=params, batch_stats=cast(variables["batch_stats"]),
            opt_state=tx.init(params), step=jnp.zeros((), jnp.int32))
        step = j_tp.make_train_step(model, tx, freeze_encoder=freeze)
        all_terms, grads = [], None
        for batch in data:
            state, (terms, _) = step(state, batch)
            all_terms.append({k: float(v) for k, v in terms.items()})
            if grads is None:
                grads = jax.tree_util.tree_map(np.asarray, state.opt_state[0])
        final = {"params": state.params, "batch_stats": state.batch_stats}
        return (all_terms, grads), jax.tree_util.tree_map(np.asarray, final)


def port_model(variables, body=torch.float32):
    cfg = HoVerNetConfig(mode="fast", nr_types=NR_TYPES, width=WIDTH,
                         dtype=body)
    net = HoVerNet(cfg)
    net.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    return net


def run_port(variables, data, freeze, body=torch.float32):
    """The port's counterpart of `run_jax`: ((terms of every step, grads
    of step 1), final state dict)."""
    net = port_model(variables, body)
    tx, schedule = t_tp.make_optimizer(**SCHEDULE)
    state = t_tp.init_train_state(net, tx, "cpu")
    step = t_tp.make_train_step(net, schedule, freeze_encoder=freeze)
    all_terms, grads = [], None
    for batch in data:
        state, (terms, _) = step(state, {k: torch.from_numpy(v)
                                         for k, v in batch.items()})
        all_terms.append({k: float(v) for k, v in terms.items()})
        if grads is None:
            grads = {k: p.grad.clone() for k, p in net.named_parameters()
                     if p.grad is not None}
    assert state.step == N_STEPS
    return (all_terms, grads), net.state_dict()


def flat(tree, prefix=()):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from flat(v, prefix + (k,))
        else:
            yield prefix + (k,), v


CFG = HoVerNetConfig(mode="fast", nr_types=NR_TYPES, width=WIDTH)


def param_keys():
    return [k for k, _ in HoVerNet(CFG).named_parameters()]


def check_frozen(freeze, t_grads, j_grad_sd, t_final, j_final_sd, start):
    """The frozen parameters: no port gradient, zero JAX gradient,
    unchanged after N_STEPS on both sides. Returns the frozen keys."""
    frozen = [k for k in param_keys() if freeze and is_frozen(k)]
    for key in frozen:
        assert key not in t_grads, key
        assert not j_grad_sd[key].numpy().any(), key
        assert torch.equal(t_final[key].float(), start[key]), key
        assert torch.equal(j_final_sd[key], start[key]), key
    assert (len(frozen) > 100) == freeze
    return frozen


@pytest.mark.parametrize("freeze", [True, False], ids=["frozen", "full"])
def test_train_step_matches_jax(setup, freeze):
    variables, data = setup
    (j_terms, j_grads), j_final = run_jax(variables, data, freeze,
                                          jnp.float64)
    (t_terms, t_grads), t_final = run_port(variables, data, freeze,
                                           torch.float64)

    # loss terms and grad_norm of every step
    assert len(t_terms) == len(j_terms) == N_STEPS
    for i, (got, want) in enumerate(zip(t_terms, j_terms)):
        assert got.keys() == want.keys()
        for k, w in want.items():
            tol = 1e-4 if k == "grad_norm" else 1e-5
            assert abs(got[k] - w) <= tol * abs(w), (i, k, got[k], w)

    start = state_dict_from_jax(variables, CFG)
    j_grad_sd = state_dict_from_jax(
        {"params": j_grads, "batch_stats": variables["batch_stats"]}, CFG)
    j_sd = state_dict_from_jax(j_final, CFG)
    frozen = check_frozen(freeze, t_grads, j_grad_sd, t_final, j_sd, start)

    for key in param_keys():
        if key in frozen:
            continue
        # the gradients of step 1
        want = j_grad_sd[key].numpy()
        got = t_grads[key].double().numpy()
        assert np.abs(want).max() > 0, key
        assert np.abs(got - want).max() <= 1e-4 * np.abs(want).max(), key
        # the parameters after N_STEPS
        got, want = t_final[key].double().numpy(), j_sd[key].numpy()
        assert np.abs(got - want).max() <= 0.1 * LR, key

    # BN running stats after N_STEPS: moved, and equal to JAX's
    n_stats = 0
    for key, want in j_sd.items():
        if key.endswith(("running_mean", "running_var")):
            n_stats += 1
            got, want = t_final[key].double().numpy(), want.numpy()
            assert not np.array_equal(want, start[key].numpy()), key
            assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max(), key
    assert n_stats > 100


def test_optimizer_matches_optax():
    """`make_optimizer`'s Adam and schedule against the JAX package's optax
    chain, alone: float64 parameters, 40 updates from seeded gradients
    that span 1e-10..1e2 (so eps matters), the boundary at update 20.
    Both compute the same float64 formula, so the bound is 1e-9 * lr;
    beta1 0.8 or beta2 0.99 in place of 0.9 / 0.999, eps 1e-7, or an lr
    decayed at the wrong update would each miss it by orders of
    magnitude."""
    sched = dict(lr=1e-3, step_epochs=4, steps_per_epoch=5, gamma=0.1)
    rng = np.random.default_rng(0)
    start = rng.normal(0, 1, (64,))
    grads = (rng.normal(0, 1, (40, 64))
             * 10.0 ** rng.uniform(-10, 2, (40, 64)))

    j_tx, _ = j_tp.make_optimizer(**sched)
    with jax.enable_x64(True):
        params = jnp.asarray(start)
        opt_state = j_tx.init(params)
        for g in grads:
            updates, opt_state = j_tx.update(jnp.asarray(g), opt_state,
                                             params)
            params = optax.apply_updates(params, updates)
        want = np.asarray(params)

    t_tx, schedule = t_tp.make_optimizer(**sched)
    p = torch.nn.Parameter(torch.from_numpy(start.copy()))
    opt = t_tx([p])
    for step, g in enumerate(grads):
        p.grad = torch.from_numpy(g)
        for group in opt.param_groups:
            group["lr"] = schedule(step)
        opt.step()
    got = p.detach().numpy()
    assert np.abs(got - start).max() > 1e-3
    assert np.abs(got - want).max() <= 1e-9 * sched["lr"]


def test_grads_map_back_to_jax_paths(setup):
    """`jax_from_state_dict` inverts `state_dict_from_jax`: every JAX
    variable comes back at its path, bit for bit."""
    variables, _ = setup
    back = jax_from_state_dict(state_dict_from_jax(variables, CFG), CFG)
    want = dict(flat(variables))
    got = dict(flat(back))
    assert got.keys() == want.keys()
    for k, v in want.items():
        assert np.array_equal(got[k], v), k


def test_schedule_has_one_boundary():
    """lr before update `step_epochs * steps_per_epoch`, lr * gamma from
    it on, never decayed again (optax's piecewise_constant_schedule)."""
    _, j_sched = j_tp.make_optimizer(lr=1e-3, step_epochs=2,
                                     steps_per_epoch=3, gamma=0.5)
    _, t_sched = t_tp.make_optimizer(lr=1e-3, step_epochs=2,
                                     steps_per_epoch=3, gamma=0.5)
    for step in range(20):
        assert t_sched(step) == pytest.approx(float(j_sched(step)),
                                              rel=1e-7), step
    assert t_sched(5) == 1e-3 and t_sched(6) == t_sched(19) == 5e-4
