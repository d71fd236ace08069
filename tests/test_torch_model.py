"""The port's HoVerNet against the JAX model, on the CPU.

The same Flax variables (with randomised BN statistics and affines, so BN
arithmetic and the name map are exercised) go through
`hover_net_tpu.models` and, carried by `state_dict_from_jax`, through
`hover_net_tpu_torch.models`; every head must agree to 2e-4 relative max
|delta| in float32 (the bound of tests/test_torch_parity.py).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hover_net_tpu.models import HoVerNet as JaxHoVerNet
from hover_net_tpu.models import HoVerNetConfig as JaxConfig
from hover_net_tpu_torch.models.checkpoints import (
    load_torch_tar,
    state_dict_from_jax,
)
from hover_net_tpu_torch.models.hovernet import HoVerNet, HoVerNetConfig

WIDTH = 8
REL_TOL = 2e-4


def jax_variables(mode, nr_types, seed=0):
    """Flax {params, batch_stats} as nested numpy dicts, BN randomised."""
    model = JaxHoVerNet(JaxConfig(mode=mode, nr_types=nr_types, width=WIDTH))
    size = model.cfg.patch_input_shape
    variables = jax.jit(lambda: model.init(
        jax.random.PRNGKey(seed), jnp.zeros((1, size, size, 3)),
        train=False))()
    variables = jax.tree_util.tree_map(np.asarray, variables)
    rng = np.random.default_rng(seed + 1)

    def randomise(tree, kind):
        for k, v in tree.items():
            if isinstance(v, dict):
                randomise(v, kind)
            elif kind == "batch_stats":
                tree[k] = (rng.normal(0, 0.1, v.shape) if k == "mean"
                           else rng.uniform(0.5, 1.5, v.shape)
                           ).astype(np.float32)
            elif k == "scale":
                tree[k] = rng.uniform(0.5, 1.5, v.shape).astype(np.float32)
            elif k == "bias":
                tree[k] = rng.normal(0, 0.1, v.shape).astype(np.float32)

    variables = {k: dict(v) for k, v in variables.items()}
    for kind in variables:
        randomise(variables[kind], kind)
    return model, variables


def port_model(mode, nr_types, variables):
    cfg = HoVerNetConfig(mode=mode, nr_types=nr_types, width=WIDTH)
    net = HoVerNet(cfg).eval()
    net.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    return net


@pytest.mark.parametrize("mode,nr_types", [
    ("fast", None), ("fast", 5), ("original", None), ("original", 5)])
def test_heads_match_jax(mode, nr_types):
    model, variables = jax_variables(mode, nr_types)
    size = model.cfg.patch_input_shape
    img = np.random.default_rng(3).uniform(
        0, 255, (1, size, size, 3)).astype(np.float32)

    want = model.apply(variables, jnp.asarray(img), train=False)
    with torch.no_grad():
        got = port_model(mode, nr_types, variables)(
            torch.from_numpy(img).permute(0, 3, 1, 2))

    assert set(got) == set(want)
    for name, ref in want.items():
        ref = np.asarray(ref)
        out = got[name].permute(0, 2, 3, 1).numpy()
        assert out.dtype == np.float32 and out.shape == ref.shape, name
        rel = np.abs(out - ref).max() / max(1.0, float(np.abs(ref).max()))
        assert rel < REL_TOL, f"{name}: relative max |delta| {rel}"


def test_reference_tar_loads_strict(tmp_path):
    """A `.tar` written by the JAX package's save_torch_tar loads into the
    port with strict=True and carries the same tensors."""
    from hover_net_tpu.models.checkpoints import save_torch_tar

    _, variables = jax_variables("fast", 5)
    path = str(tmp_path / "m.tar")
    save_torch_tar(path, variables, JaxConfig(mode="fast", nr_types=5,
                                              width=WIDTH))
    cfg = HoVerNetConfig(mode="fast", nr_types=5, width=WIDTH)
    state = load_torch_tar(path)
    net = HoVerNet(cfg)
    net.load_state_dict(state, strict=True)
    carried = state_dict_from_jax(variables, cfg)
    assert set(carried) == set(state)
    for k, v in carried.items():
        torch.testing.assert_close(state[k], v, rtol=0, atol=0)


def test_bf16_body_keeps_f32_heads():
    """A bf16 body keeps its heads, and its BatchNorms, in float32."""
    cfg = HoVerNetConfig(mode="fast", nr_types=5, width=WIDTH,
                         dtype=torch.bfloat16)
    net = HoVerNet(cfg, generator=torch.Generator().manual_seed(0)).eval()
    assert net.conv0.bn.weight.dtype == torch.float32
    assert net.conv0._modules["/"].weight.dtype == torch.bfloat16
    for branch in net.decoder.values():
        assert branch.u0.conv.weight.dtype == torch.float32
    with torch.no_grad():
        out = net(torch.zeros(1, 3, 256, 256, dtype=torch.uint8))
    assert {k: v.dtype for k, v in out.items()} == dict.fromkeys(
        ("tp", "np", "hv"), torch.float32)
    assert out["np"].shape == (1, 2, 164, 164)


def _bn_tensors(bn):
    return (bn.weight, bn.bias, bn.running_mean, bn.running_var)


@pytest.mark.parametrize("body,bn", [
    (torch.bfloat16, torch.float32), (torch.float32, torch.float32),
    (torch.float64, torch.float64)])
def test_construction_dtypes_and_state_round_trip(tmp_path, body, bn):
    """Every BN's four tensors hold `bn` (float32 under a narrower body,
    as flax's param_dtype), the convolutions the body's dtype, the heads
    float32; the output of each stage has the body's dtype; a state dict
    goes through save_train_tar and load_torch_tar unchanged, and a
    float32 checkpoint loads into the BNs without rounding."""
    from hover_net_tpu_torch.models.blocks import BatchNorm2d
    from hover_net_tpu_torch.models.checkpoints import save_train_tar

    cfg = HoVerNetConfig(mode="fast", nr_types=5, width=WIDTH, dtype=body)
    net = HoVerNet(cfg, generator=torch.Generator().manual_seed(0)).eval()
    bns = [m for m in net.modules() if isinstance(m, BatchNorm2d)]
    # conv0, d0..d3 (units' preact/conv1/conv2 BNs and the closing BN),
    # and per branch u3/u2's dense units and closing BN and u0's BN
    units = 3 + 4 + 6 + 3
    assert len(bns) == 1 + (3 * units - 4) + 4 + 3 * (2 * 8 + 2 * 4 + 2 + 1)
    for m in bns:
        assert {t.dtype for t in _bn_tensors(m)} == {bn}
    heads = {b.u0.conv for b in net.decoder.values()}
    for m in net.modules():
        if isinstance(m, torch.nn.Conv2d):
            assert m.weight.dtype == (torch.float32 if m in heads else body)

    _, variables = jax_variables("fast", 5)
    state = state_dict_from_jax(variables, cfg)
    net.load_state_dict(state, strict=True)
    for key, m in (("conv0.bn", net.conv0.bn), ("d2.units.4.preact/bn",
                   net.d2.units[4]._modules["preact/bn"])):
        for name, t in zip(("weight", "bias", "running_mean", "running_var"),
                           _bn_tensors(m)):
            want = state[f"{key}.{name}"].to(bn)
            assert torch.equal(t, want), (key, name)

    seen = {}
    hooks = [getattr(net, n).register_forward_hook(
        lambda _m, _i, o, n=n: seen.__setitem__(n, o.dtype))
        for n in ("conv0", "d0", "d1", "d2", "d3", "conv_bot")]
    hooks.append(net.decoder["np"].u1.register_forward_hook(
        lambda _m, _i, o: seen.__setitem__("u1", o.dtype)))
    with torch.no_grad():
        out = net(torch.zeros(1, 3, 256, 256, dtype=torch.uint8))
    for h in hooks:
        h.remove()
    assert set(seen.values()) == {body}
    assert {v.dtype for v in out.values()} == {torch.float32}

    path = str(tmp_path / "m.tar")
    save_train_tar(path, net, torch.optim.Adam(net.parameters()), 3)
    loaded = load_torch_tar(path)
    own = net.state_dict()
    assert set(loaded) == set(own)
    for k, v in own.items():
        assert loaded[k].dtype == v.dtype and torch.equal(loaded[k], v), k
    again = HoVerNet(cfg).eval()
    again.load_state_dict(loaded, strict=True)
    for k, v in again.state_dict().items():
        assert v.dtype == own[k].dtype and torch.equal(v, own[k]), k
