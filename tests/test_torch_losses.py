"""The port's training losses against hover_net_tpu.ops.losses, on the CPU.

The same seeded NHWC inputs go through the JAX losses and, transposed to
NCHW, through the port's; every term and the weighted total must agree
to 1e-6 relative (float32 sums over a few thousand elements). The JAX
functions run under `jax.jit`, as they do inside the JAX train step
(op-by-op, XLA's CPU reductions sum serially, ~1e-6 off here).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hover_net_tpu.ops import losses as j_losses
from hover_net_tpu_torch.ops import losses as t_losses

REL_TOL = 1e-6


def inputs(seed=0, n=3, h=20, w=18, nr_types=5):
    """Post-softmax np/tp probabilities, raw hv, one-hot targets (NHWC)."""
    rng = np.random.default_rng(seed)

    def probs(c):
        x = rng.normal(0, 2, (n, h, w, c))
        e = np.exp(x - x.max(-1, keepdims=True))
        return (e / e.sum(-1, keepdims=True)).astype(np.float32)

    def one_hot(c):
        return np.eye(c, dtype=np.float32)[rng.integers(0, c, (n, h, w))]

    pred = {"np": probs(2), "tp": probs(nr_types),
            "hv": rng.uniform(-1.5, 1.5, (n, h, w, 2)).astype(np.float32)}
    true = {"np": one_hot(2), "tp": one_hot(nr_types),
            "hv": rng.uniform(-1, 1, (n, h, w, 2)).astype(np.float32)}
    return pred, true


def nchw(x):
    return torch.from_numpy(np.ascontiguousarray(x.transpose(0, 3, 1, 2)))


def close(got, want):
    got, want = float(got), float(want)
    assert abs(got - want) <= REL_TOL * max(abs(want), 1e-12), (got, want)


@pytest.mark.parametrize("name,branch", [
    ("xentropy_loss", "np"), ("xentropy_loss", "tp"),
    ("dice_loss", "np"), ("dice_loss", "tp"), ("mse_loss", "hv")])
def test_loss_term(name, branch):
    pred, true = inputs()
    want = jax.jit(getattr(j_losses, name))(jnp.asarray(true[branch]),
                                            jnp.asarray(pred[branch]))
    got = getattr(t_losses, name)(nchw(true[branch]), nchw(pred[branch]))
    close(got, want)


def test_xentropy_sum_reduction():
    pred, true = inputs(seed=1)
    want = jax.jit(lambda t, p: j_losses.xentropy_loss(t, p, "sum"))(
        jnp.asarray(true["np"]), jnp.asarray(pred["np"]))
    got = t_losses.xentropy_loss(nchw(true["np"]), nchw(pred["np"]),
                                 reduction="sum")
    close(got, want)


def test_gradient_hv_keeps_the_channel_quirk():
    """kernel_h on channel 0, kernel_v on channel 1, 'SAME' zero pad."""
    _, true = inputs(seed=2)
    want = np.asarray(jax.jit(j_losses.gradient_hv)(jnp.asarray(true["hv"])))
    got = t_losses.gradient_hv(nchw(true["hv"])).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


def test_msge_loss():
    pred, true = inputs(seed=3)
    focus = true["np"][..., 1]
    want = jax.jit(j_losses.msge_loss)(
        jnp.asarray(true["hv"]), jnp.asarray(pred["hv"]), jnp.asarray(focus))
    got = t_losses.msge_loss(nchw(true["hv"]), nchw(pred["hv"]),
                             torch.from_numpy(focus))
    close(got, want)


@pytest.mark.parametrize("typed", [False, True])
@pytest.mark.parametrize("weights", [None, {"np": {"bce": 2.0, "dice": 0.5},
                                            "hv": {"mse": 1.5, "msge": 3.0},
                                            "tp": {"bce": 0.3}}])
def test_hovernet_loss(typed, weights):
    pred, true = inputs(seed=4)
    if not typed:
        pred.pop("tp")
        true.pop("tp")
    focus = true["np"][..., 1]
    want_total, want = jax.jit(
        lambda p, t, f: j_losses.hovernet_loss(p, t, f, weights=weights))(
        {k: jnp.asarray(v) for k, v in pred.items()},
        {k: jnp.asarray(v) for k, v in true.items()}, jnp.asarray(focus))
    got_total, got = t_losses.hovernet_loss(
        {k: nchw(v) for k, v in pred.items()},
        {k: nchw(v) for k, v in true.items()}, torch.from_numpy(focus),
        weights=weights)
    assert got.keys() == want.keys()
    for k in want:
        close(got[k], want[k])
    close(got_total, want_total)
    assert t_losses.DEFAULT_LOSS_WEIGHTS == j_losses.DEFAULT_LOSS_WEIGHTS
