"""The port's fused-block encoder (models/encoder_fused.py and the plain
version of kernel K3, ops/fused_block_cuda.py) against the JAX package's
Pallas encoder (hover_net_tpu/models/encoder_pallas.py), on the CPU.

The JAX kernel runs in interpret mode. Both sides take the same width-8
Flax variables (BN statistics and affines randomised) and the same
inputs, made with numpy.

Bounds:
- `pack_block`, from a float32-body model and from the bf16-body model
  K3 runs on (whose BatchNorms hold the float32 values, as flax keeps
  them): weights identical (both cast the same f32 values to bf16); the
  folded BN scale/offset within 1e-6 (f32 `1/sqrt` of two libraries,
  measured <= 1.2e-7).
- one block call, the plain version given the BN affines in bf16: then
  it and the interpret-mode kernel round at the same points (bf16 after
  each f32-accumulated product, after the BN multiply, after the BN add
  and after the residual add), so they can
  differ only where the f32 sums of a product run in another order and
  the bf16 rounding then lands on the other side. The bound is half a
  bf16 ulp at the output scale (2^-9 of it), far below the 3% of
  tests/test_encoder_pallas.py; measured: identical on both shapes.
- the whole forward, from the float32 variables as a user loads them,
  the port's packs given bf16 affines: the encoder blocks agree as
  above, and the stem, d3 and the decoders
  are each package's bf16 modules, which agree to a bf16 ulp on all but
  a small share of each stage's elements (tests/test_torch_infer_bf16.py)
  that the random net then amplifies. The heads agree within 4% of their
  scale (measured 2.6% np, 3.1% hv; with the port's BN rounded to bf16,
  as before it kept them in float32, 6.0% / 13.2%); the JAX package's
  own standard-vs-fused drift on the same input is 6.2% / 8.5%.
- with its own float32 affines (one rounding after the BN's f32 multiply
  and add, as the port's float32 BatchNorm computes) the port's fused
  forward drifts less from the port's standard bf16 forward than the
  JAX fused forward does from the JAX standard one.
"""

import copy
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hover_net_tpu.models.encoder_pallas import fused_block_apply as jax_apply
from hover_net_tpu.models.encoder_pallas import fused_forward as jax_forward
from hover_net_tpu.models.encoder_pallas import pack_block as jax_pack
from hover_net_tpu_torch.infer import steps
from hover_net_tpu_torch.models.checkpoints import state_dict_from_jax
from hover_net_tpu_torch.models import encoder_fused
from hover_net_tpu_torch.models.encoder_fused import (
    fused_forward,
    pack_block,
    pack_encoder,
)
from hover_net_tpu_torch.models.hovernet import HoVerNet, HoVerNetConfig
from hover_net_tpu_torch.ops.fused_block_cuda import (
    fused_block_apply,
    fused_block_reference,
)

from test_torch_model import jax_variables, port_model

# the suite runs in several worker processes on one host: torch's default
# of one CPU thread per core in each of them oversubscribes the cores
# many times over and slows these tests by an order of magnitude
torch.set_num_threads(1)

BF16 = torch.bfloat16
# (name, block, pack kwargs): the four block calls of the fused encoder
CALLS = [("d0", "d0", dict(count=3)),
         ("d1", "d1", dict(count=4)),
         ("d2a", "d2", dict(count=3, final_bn=False)),
         ("d2b", "d2", dict(count=3, has_u0=False, unit_base=3))]


@pytest.fixture(scope="module")
def carried():
    """JAX variables (randomised BN) and the port model that carries them
    (float32 body)."""
    _, variables = jax_variables("fast", None, seed=4)
    return variables, port_model("fast", None, variables)


@pytest.fixture(scope="module")
def carried_bf16(carried):
    """The same variables in a bf16-body model, the one K3 runs on: its
    BatchNorms hold the float32 values, so the fold starts from them."""
    variables, _ = carried
    cfg = HoVerNetConfig(mode="fast", nr_types=None, width=8, dtype=BF16)
    net = HoVerNet(cfg).eval()
    net.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    return variables, net


@pytest.mark.parametrize("body", ["float32", "bfloat16"])
@pytest.mark.parametrize("name,block,kw", CALLS, ids=[c[0] for c in CALLS])
def test_pack_block_matches_jax(request, body, name, block, kw):
    variables, net = request.getfixturevalue(
        "carried" if body == "float32" else "carried_bf16")
    want = jax_pack(variables["params"][block],
                    variables["batch_stats"][block], **kw)
    got = pack_block(getattr(net, block), **kw)
    assert set(got) == set(want)
    for key, w in want.items():
        w = np.asarray(w, np.float32)
        g = got[key].detach().float().numpy()
        assert g.shape == w.shape, key
        if got[key].dtype == BF16:
            np.testing.assert_array_equal(g, w, err_msg=key)
        else:
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=key)


@pytest.mark.parametrize("block,count,stride", [("d0", 3, 1), ("d1", 4, 2)])
def test_block_reference_matches_jax_interpret(carried, block, count, stride):
    """d0 class (stride 1, shortcut conv, 3 units) and d1 class (stride 2,
    4 units) at S = 32 on the same packed weights."""
    variables, _ = carried
    pk = jax_pack(variables["params"][block],
                  variables["batch_stats"][block], count)
    cin = pk["w1_0"].shape[0]
    x = np.random.default_rng(count).normal(0, 1, (2, 32, 32, cin))
    xb = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jax_apply(xb, pk, count=count, stride=stride,
                                interpret=True), np.float32)
    # all in bf16, the BN affines too: the plain version then rounds them
    # where the TPU kernel does (it applies them in bf16)
    got = fused_block_reference(
        torch.from_numpy(np.array(xb.astype(jnp.float32))).to(BF16),
        {k: torch.from_numpy(np.array(v, np.float32)).to(BF16)
         for k, v in pk.items()},
        count=count, stride=stride)
    assert got.dtype == BF16 and got.shape == want.shape
    scale = np.abs(want).max()
    assert scale > 1.0
    err = np.abs(got.float().numpy() - want).max()
    assert err <= scale * 2.0**-9, (err, scale)


def test_split_chain_equals_unsplit_block(carried):
    """d2 as 3 + 3 units (rolling shortcut across the cut) == d2 as one
    6-unit call, bit for bit."""
    _, net = carried
    x = torch.from_numpy(np.random.default_rng(7).normal(
        0, 1, (2, 16, 16, 64)).astype(np.float32)).to(BF16)
    whole = fused_block_apply(x, pack_block(net.d2, 6), count=6, stride=2)
    half = fused_block_apply(x, pack_block(net.d2, 3, final_bn=False),
                             count=3, stride=2, final_bn=False)
    out = fused_block_apply(half, pack_block(net.d2, 3, has_u0=False,
                                             unit_base=3),
                            count=3, stride=1, has_u0=False)
    assert whole.shape == (2, 8, 8, 128)
    assert torch.equal(whole, out)


@pytest.fixture(scope="module")
def fast_forwards():
    """Width 8, one 256^2 patch, bf16 body: the port model, the input, and
    the JAX fused_forward(interpret=True) and standard forwards of it."""
    from hover_net_tpu.models import HoVerNet as JaxHoVerNet
    from hover_net_tpu.models import HoVerNetConfig as JaxConfig

    _, variables = jax_variables("fast", None, seed=0)
    cfg = HoVerNetConfig(mode="fast", nr_types=None, width=8, dtype=BF16)
    net = HoVerNet(cfg).eval()
    net.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    x = np.random.default_rng(3).uniform(0, 255, (1, 256, 256, 3)).astype(
        np.float32)
    jcfg = JaxConfig(mode="fast", nr_types=None, width=8, dtype=jnp.bfloat16)
    fused = jax_forward(jcfg, variables, jnp.asarray(x), interpret=True)
    standard = JaxHoVerNet(jcfg).apply(variables, jnp.asarray(x),
                                       train=False)
    return net, x, fused, standard


def _rel(got, ref):
    """max |got - ref| / max |ref| of NHWC arrays."""
    return np.abs(got - ref).max() / np.abs(ref).max()


def _nhwc(t: torch.Tensor) -> np.ndarray:
    return t.float().permute(0, 2, 3, 1).numpy()


def test_fused_forward_matches_jax(fast_forwards, monkeypatch):
    """The port's fused forward (plain K3) against JAX
    fused_forward(interpret=True), with the packs' BN affines in bf16 as
    the TPU kernel applies them."""
    net, x, want, _ = fast_forwards
    packs = {name: ({k: v.to(BF16) for k, v in packed.items()}, units)
             for name, (packed, units) in pack_encoder(net).items()}
    monkeypatch.setattr(encoder_fused, "pack_encoder", lambda model: packs)
    with torch.no_grad():
        got = fused_forward(net, torch.from_numpy(x))
    assert set(got) == set(want) == {"np", "hv"}
    for name, ref in want.items():
        ref = np.asarray(ref, np.float32)
        out = got[name].permute(0, 2, 3, 1).numpy()
        assert out.dtype == np.float32 and out.shape == ref.shape == (
            1, 164, 164, 2)
        rel = _rel(out, ref)
        assert rel < 0.04, (name, rel)


def test_fused_forward_nearer_the_standard_forward(fast_forwards):
    """With its own float32 BN affines, the port's fused forward drifts
    from the port's standard bf16 forward (float32 BatchNorm) less than
    the JAX fused forward (bf16 BN affines) drifts from the JAX standard
    one, on every head (measured 3.7% / 4.8% against 5.7% / 8.5%)."""
    net, x, jax_fused, jax_std = fast_forwards
    with torch.no_grad():
        got = fused_forward(net, torch.from_numpy(x))
        std = net(torch.from_numpy(x).permute(0, 3, 1, 2))
    for name in ("np", "hv"):
        port = _rel(_nhwc(got[name]), _nhwc(std[name]))
        tpu = _rel(np.asarray(jax_fused[name], np.float32),
                   np.asarray(jax_std[name], np.float32))
        assert port < tpu, (name, port, tpu)


def test_pack_encoder_repacks_after_load(carried):
    """The packs are cached per set of weights and rebuilt after
    load_state_dict."""
    variables, net = carried
    first = pack_encoder(net)
    assert pack_encoder(net) is first
    state = {k: v.clone() for k, v in net.state_dict().items()}
    state["d0.shortcut.weight"] *= 2
    net.load_state_dict(state)
    again = pack_encoder(net)
    assert again is not first
    torch.testing.assert_close(again["d0"][0]["wsc"].float(),
                               2 * first["d0"][0]["wsc"].float())
    # the kernel's layout is rebuilt with the packs: [N][K] weights
    torch.testing.assert_close(again["d0"][1][0]["wsct"],
                               again["d0"][0]["wsc"].t())
    net.load_state_dict(state_dict_from_jax(variables, net.cfg))


def test_pack_encoder_follows_a_copy(carried_bf16):
    """A bf16 model copied after its first pack (as `model_on` copies the
    manager's model for a second card) copies, and the copy's packs
    follow the copy's own tensors."""
    _, net = carried_bf16
    first = pack_encoder(net)
    twin = copy.deepcopy(net)
    assert pack_encoder(twin) is not first  # the copy's cached packs
    assert pack_encoder(twin) is pack_encoder(twin)
    with torch.no_grad():
        twin.d1.shortcut.weight.mul_(2)
    again = pack_encoder(twin)
    torch.testing.assert_close(again["d1"][0]["wsc"].float(),
                               2 * first["d1"][0]["wsc"].float())
    assert pack_encoder(net) is first


GATE = [  # (mode, width, dtype, device, train mode, grad enabled, expected)
    ("original", 32, BF16, "cuda", False, False, False),
    ("fast", 32, BF16, "cpu", False, False, False),
    ("fast", 32, torch.float32, "cuda", False, False, False),
    ("fast", 8, BF16, "cuda", False, False, False),
    ("fast", 32, BF16, "cuda", True, False, False),
    ("fast", 32, BF16, "cuda", False, True, False),
    ("fast", 32, BF16, "cuda", False, False, True),
]


@pytest.mark.parametrize("mode,width,dtype,device,train,grad,expected", GATE)
def test_fused_gate(mode, width, dtype, device, train, grad, expected):
    """K3 takes the forward from what the code sees alone: fast mode,
    4 * width a multiple of 128, a bf16 body, a CUDA device, eval mode
    (K3 folds the running statistics) and autograd off (no backward)."""
    net = SimpleNamespace(cfg=HoVerNetConfig(mode=mode, width=width,
                                             dtype=dtype), training=train)
    with torch.set_grad_enabled(grad):
        assert steps._use_fused_enc(net, torch.device(device)) is expected


def test_infer_output_on_cpu_takes_standard_path():
    """A model K3 would take on a card runs the standard forward on the
    CPU."""
    cfg = HoVerNetConfig(mode="fast", width=32, dtype=BF16)
    net = HoVerNet(cfg, generator=torch.Generator().manual_seed(0)).eval()
    x = torch.from_numpy(np.random.default_rng(0).integers(
        0, 255, (1, 256, 256, 3), dtype=np.uint8))
    before = fused_block_apply.launches
    with torch.no_grad():
        got = steps.infer_output(net, x)
        out = net(x.permute(0, 3, 1, 2))
    want = torch.cat([torch.softmax(out["np"], 1)[:, 1:2], out["hv"]],
                     1).permute(0, 2, 3, 1)
    assert torch.equal(got, want)
    assert fused_block_apply.launches == before
