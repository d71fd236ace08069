"""The port's bf16 train step (cli/bench_train.py's `bf16_trainer`:
float32 parameters, a bf16 `torch.autocast` body, float32 heads and loss)
against the JAX package's bf16 step (`HoVerNetConfig(dtype=bfloat16)`,
as scripts/bench_train.py configures it), on the CPU.

Width 8, fast mode, untyped, one recipe batch of cli/recipe.py (two 256^2
`synth_nuclei_image`s, 164^2 targets); the port's seeded start weights
reach JAX through `jax_from_state_dict`.

One step's gradients cannot tell a bf16 body from a float32 one here. In
bf16 the train-mode BatchNorms of this random width-8 net amplify
rounding from layer to layer: the JAX package's own bf16 and float32
steps give gradients 124 % apart (relative L2 over all parameters), and
the port's bf16 step is 205 % from JAX's bf16 one. The float32 step is
124 % from it. So the checks hold each stage where the two bodies are
not yet separated by that noise, each with a negative control that
fails the same bound:
- activations of the step's train-mode forward against the JAX bf16
  forward on the same weights and batch. The dtype of each stage output
  is the same on both sides. conv0 (the input cast, a bf16 convolution,
  BatchNorm with float32 statistics, a bf16 output): >= 99 % of the
  entries bit-equal and 2e-3 relative L2 (measured: 99.8 %, 4.7e-4). The
  port's float32 step gives 53 % and 6.9e-3. For d0..d2 the bf16 step
  is at most half as far from JAX's bf16 forward as the float32 step
  (ratios 0.32, 0.34, 0.37);
- the head: the port's u0 inside the autocast body, fed the JAX bf16
  decoder's u1 output, gives JAX's float32 head output to 2e-4
  relative L2 (measured 1.9e-5). The same head's convolution left in
  the autocast body (bf16) is 2.6e-3 away;
- the loss: the step's loss terms equal the JAX `hovernet_loss` on the
  step's own head outputs to 2e-5 relative (measured <= 1.4e-6). The
  port's loss computed inside the autocast body misses that bound on
  the msge term (its Sobel convolution runs in bf16: 2.9e-4);
- the whole step against the JAX package's jitted bf16 step: loss terms
  within 5 % relative (measured <= 3.2 %; this bound does not separate
  the float32 step, 0.9 %). Parameters and Adam moments stay float32.
  Each parameter entry moves by at most lr * (1 + 1e-6) on both sides,
  Adam's first update being +-lr, plus the float32 rounding of the sum
  (one epsilon of the entry).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hover_net_tpu.models import HoVerNet as JaxHoVerNet
from hover_net_tpu.models import HoVerNetConfig as JaxConfig
from hover_net_tpu.ops.losses import hovernet_loss as jax_hovernet_loss
from hover_net_tpu.parallel import train_parallel as j_tp
from hover_net_tpu_torch.cli import bench_train, recipe
from hover_net_tpu_torch.models.checkpoints import (
    jax_from_state_dict,
    state_dict_from_jax,
)
from hover_net_tpu_torch.models.hovernet import HoVerNet, HoVerNetConfig
from hover_net_tpu_torch.ops.losses import hovernet_loss
from hover_net_tpu_torch.parallel import train_parallel as t_tp

WIDTH = 8
CFG = HoVerNetConfig(mode="fast", nr_types=None, width=WIDTH)
STAGES = ("conv0", "d0", "d1", "d2", "d3")
# bench_train's optimizer: Adam 1e-4, 25 epochs of 100 steps, then x0.1
SCHEDULE = dict(lr=1e-4, step_epochs=25, steps_per_epoch=100)


def rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def to_nhwc(t):
    return t.detach().float().permute(0, 2, 3, 1).numpy()


def port_step(net, step, state, batch):
    """One step of the port; (stage outputs NCHW, head outputs, terms)."""
    seen = {}
    mods = {name: getattr(net, name) for name in STAGES}
    mods.update(u1=net.decoder["np"].u1, u0=net.decoder["np"].u0, out=net)
    hooks = [m.register_forward_hook(
        lambda _m, _i, o, name=name: seen.setdefault(name, o))
        for name, m in mods.items()]
    _, (terms, _) = step(state, {k: torch.from_numpy(v)
                                 for k, v in batch.items()})
    for h in hooks:
        h.remove()
    out = {k: v.detach() for k, v in seen.pop("out").items()}
    return seen, out, {k: float(v) for k, v in terms.items()}


def jax_forward(variables, batch):
    """The JAX bf16 model's train-mode forward: {stage: output} (NHWC, as
    captured by flax)."""
    model = JaxHoVerNet(JaxConfig(mode="fast", nr_types=None, width=WIDTH,
                                  dtype=jnp.bfloat16))
    _, col = model.apply(variables, batch["img"], train=True,
                         mutable=["batch_stats", "intermediates"],
                         capture_intermediates=True)
    it = col["intermediates"]
    got = {name: it[name]["__call__"][0] for name in STAGES}
    got["u1"] = it["decoder_np"]["u1_conva"]["__call__"][0]
    got["u0"] = it["decoder_np"]["u0_conv"]["__call__"][0]
    return got


def jax_step(variables, batch):
    """One jitted step of the JAX package's bf16 trainer: (terms, final
    state dict in the port's names, whether the state stayed float32)."""
    model = JaxHoVerNet(JaxConfig(mode="fast", nr_types=None, width=WIDTH,
                                  dtype=jnp.bfloat16))
    tx, _ = j_tp.make_optimizer(**SCHEDULE)
    params = jax.tree_util.tree_map(jnp.asarray, variables["params"])
    state = j_tp.TrainState(
        params=params,
        batch_stats=jax.tree_util.tree_map(jnp.asarray,
                                           variables["batch_stats"]),
        opt_state=tx.init(params), step=jnp.zeros((), jnp.int32))
    state, (terms, _) = j_tp.make_train_step(model, tx)(state, batch)
    f32 = {x.dtype for x in jax.tree_util.tree_leaves(
        (state.params, state.opt_state)) if x.ndim} == {np.dtype(np.float32)}
    final = jax.tree_util.tree_map(
        np.asarray, {"params": state.params,
                     "batch_stats": state.batch_stats})
    return ({k: float(v) for k, v in terms.items()},
            state_dict_from_jax(final, CFG), f32)


@pytest.fixture(scope="module")
def runs():
    batch = next(recipe.recipe_batches(np.random.default_rng(0), 2))
    state, step = bench_train.bf16_trainer(WIDTH, torch.device("cpu"))
    start = {k: v.clone() for k, v in state.model.state_dict().items()}
    variables = jax_from_state_dict(start, CFG)
    bf16 = port_step(state.model, step, state, batch)

    # the negative control: the same weights through the float32 step
    net = HoVerNet(CFG)
    net.load_state_dict(start)
    tx, schedule = t_tp.make_optimizer(**SCHEDULE)
    f32 = port_step(net, t_tp.make_train_step(net, schedule),
                    t_tp.init_train_state(net, tx, "cpu"), batch)
    return dict(batch=batch, start=start, variables=variables, state=state,
                bf16=bf16, f32=f32, jax=jax_forward(variables, batch))


def test_bf16_step_stage_dtypes_match_jax(runs):
    acts, _, _ = runs["bf16"]
    want = {k: str(v.dtype) for k, v in runs["jax"].items()}
    got = {k: str(v.dtype).replace("torch.", "") for k, v in acts.items()}
    assert got == want
    assert want["conv0"] == "bfloat16" and want["u0"] == "float32"


@pytest.mark.parametrize("stage", ["conv0", "d0", "d1", "d2"])
def test_bf16_step_activations_match_jax_bf16(runs, stage):
    want = np.asarray(runs["jax"][stage].astype(jnp.float32))
    got = to_nhwc(runs["bf16"][0][stage])
    control = to_nhwc(runs["f32"][0][stage])
    err, err_control = rel(got, want), rel(control, want)
    if stage == "conv0":
        assert np.mean(got == want) >= 0.99 and err <= 2e-3, err
        assert np.mean(control == want) < 0.99 and err_control > 2e-3
    else:
        assert err <= 0.5 * err_control, (err, err_control)


def test_bf16_step_head_runs_in_float32(runs):
    """The port's u0 inside the autocast body, fed JAX's bf16 u1 output."""
    net = HoVerNet(CFG)
    net.load_state_dict(runs["start"])
    u0 = net.train().decoder["np"].u0
    x = torch.from_numpy(np.array(runs["jax"]["u1"].astype(jnp.float32))
                         ).permute(0, 3, 1, 2).to(torch.bfloat16)
    want = np.asarray(runs["jax"]["u0"])
    with torch.no_grad(), torch.autocast("cpu", dtype=torch.bfloat16):
        got = to_nhwc(u0(x))
        control = to_nhwc(u0.conv(torch.relu(u0.bn(x))))  # a bf16 head
    assert rel(got, want) <= 2e-4
    assert rel(control, want) > 2e-4


def test_bf16_step_loss_is_float32(runs):
    """The step's loss terms against the JAX loss on its own outputs."""
    _, out, terms = runs["bf16"]
    batch = runs["batch"]
    onehot = jax.nn.one_hot(batch["np_map"], 2)
    pred = {"np": jax.nn.softmax(jnp.asarray(to_nhwc(out["np"])), -1),
            "hv": jnp.asarray(to_nhwc(out["hv"]))}
    _, want = jax_hovernet_loss(
        pred, {"np": onehot, "hv": jnp.asarray(batch["hv_map"])},
        onehot[..., 1])
    for k, w in want.items():
        assert abs(terms[k] - float(w)) <= 2e-5 * abs(float(w)), k

    true_np = torch.from_numpy(np.asarray(onehot)).permute(0, 3, 1, 2)
    true = {"np": true_np,
            "hv": torch.from_numpy(batch["hv_map"]).permute(0, 3, 1, 2)}
    pred = {"np": torch.softmax(out["np"], 1), "hv": out["hv"]}
    with torch.autocast("cpu", dtype=torch.bfloat16):
        _, control = hovernet_loss(pred, true, true_np[:, 1])
    w = float(want["loss_hv_msge"])
    assert abs(float(control["loss_hv_msge"]) - w) > 2e-5 * abs(w)


def test_bf16_step_matches_jax_bf16_step(runs):
    j_terms, j_final, j_f32 = jax_step(runs["variables"], runs["batch"])
    _, _, terms = runs["bf16"]
    assert terms.keys() == j_terms.keys()
    for k in ("overall_loss", "loss_np_bce", "loss_np_dice", "loss_hv_mse",
              "loss_hv_msge"):
        assert abs(terms[k] - j_terms[k]) <= 0.05 * abs(j_terms[k]), k

    state, start = runs["state"], runs["start"]
    assert j_f32
    assert {p.dtype for p in state.model.parameters()} == {torch.float32}
    moments = [s[m] for s in state.optimizer.state.values()
               for m in ("exp_avg", "exp_avg_sq")]
    assert moments and {m.dtype for m in moments} == {torch.float32}
    lr = SCHEDULE["lr"]
    final = state.model.state_dict()
    eps = torch.finfo(torch.float32).eps
    for key, _ in state.model.named_parameters():
        p0 = start[key].double()
        for sd in (final, j_final):
            moved = (sd[key].double() - p0).abs()
            # +-lr, and the float32 rounding of the sum
            assert moved.max() > 0, key
            assert (moved <= lr * (1 + 1e-6) + eps * p0.abs()).all(), key
