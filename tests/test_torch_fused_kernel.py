"""Kernel K3 (csrc/fused_block.cu) against its plain version, on the card.
Every test here needs a CUDA device and skips without one.

This file imports no jax, so it runs on a machine without it:
  python -m pytest --noconftest -m gpu tests/test_torch_fused_kernel.py

Bound: the kernel rounds at the plain version's points and differs only
in the order of its f32 sums, so a bf16 rounding lands elsewhere on a
few elements and the difference spreads through the following units; it
must stay within the 3%-of-scale bf16 bound of
tests/test_encoder_pallas.py. Tile size and the 3 + 3 split of d2 change
nothing: those are bit-exact.

Two widths: w32 (the narrowest, d0 with c1 = 32) at S = 32/16/8, and the
model's own w64 channel counts (K up to 2304 = 9 x 256, N up to 1024) at
S = 16/8 on a batch of 3, where an 8 x 16 output tile overhangs the map
and stride 2 reads past its bottom and right edge.
"""

import numpy as np
import pytest
import torch
from torch import nn

from hover_net_tpu_torch.infer import steps
from hover_net_tpu_torch.models.blocks import ResidualBlock
from hover_net_tpu_torch.models.encoder_fused import fused_forward, pack_block
from hover_net_tpu_torch.models.hovernet import HoVerNet, HoVerNetConfig
from hover_net_tpu_torch.ops.fused_block_cuda import (
    fused_block_apply,
    fused_block_reference,
    kernel_units,
)

pytestmark = pytest.mark.gpu
BF16 = torch.bfloat16
W = 32  # the narrowest width the kernel takes (channels multiple of 32)
# name: (cin, c1, cout, units in the module, stride, S, pack kwargs)
BLOCKS = {
    "d0": (W, W, 4 * W, 3, 1, 32, dict(count=3)),
    "d1": (4 * W, 2 * W, 8 * W, 4, 2, 32, dict(count=4)),
    "d2a": (8 * W, 4 * W, 16 * W, 6, 2, 16, dict(count=3, final_bn=False)),
    "d2b": (8 * W, 4 * W, 16 * W, 6, 2, 8,
            dict(count=3, has_u0=False, unit_base=3)),
}
W64 = 64  # the model's width: the channel counts of models/encoder_fused.CALLS
BLOCKS_W64 = {
    "d0": (W64, W64, 4 * W64, 3, 1, 16, dict(count=3)),
    "d1": (4 * W64, 2 * W64, 8 * W64, 4, 2, 16, dict(count=4)),
    "d2a": (8 * W64, 4 * W64, 16 * W64, 6, 2, 16,
            dict(count=3, final_bn=False)),
    "d2b": (8 * W64, 4 * W64, 16 * W64, 6, 2, 8,
            dict(count=3, has_u0=False, unit_base=3)),
}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@torch.no_grad()
def make_block(cin, c1, cout, count, stride, seed=0):
    """A ResidualBlock with seeded random weights and BN statistics."""
    g = torch.Generator().manual_seed(seed)
    blk = ResidualBlock(cin, (c1, c1, cout), count, stride)
    for m in blk.modules():
        if isinstance(m, nn.Conv2d):
            fan_out = m.weight.shape[0] * m.weight[0, 0].numel()
            m.weight.normal_(0.0, (2.0 / fan_out) ** 0.5, generator=g)
        elif isinstance(m, nn.BatchNorm2d):
            m.weight.uniform_(0.5, 1.5, generator=g)
            m.bias.normal_(0.0, 0.1, generator=g)
            m.running_mean.normal_(0.0, 0.1, generator=g)
            m.running_var.uniform_(0.5, 1.5, generator=g)
    return blk.eval()


def case(name, cuda, seed=0, blocks=BLOCKS, batch=2):
    """(x, packed, call kwargs) of one block class on the card."""
    cin, c1, cout, units, stride, s, kw = blocks[name]
    blk = make_block(cin, c1, cout, units, stride, seed)
    packed = {k: v.to(cuda) for k, v in pack_block(blk, **kw).items()}
    has_u0 = kw.get("has_u0", True)
    ch = cin if has_u0 else cout
    x = torch.randn((batch, s, s, ch), generator=torch.Generator(
        ).manual_seed(seed + 1)).to(cuda, BF16)
    call = dict(count=kw["count"], stride=stride if has_u0 else 1,
                has_u0=has_u0, final_bn=kw.get("final_bn", True))
    return x, packed, call


def check_matches_plain(x, packed, call):
    before = fused_block_apply.launches
    got = fused_block_apply(x, packed, **call)
    torch.cuda.synchronize()
    assert fused_block_apply.launches == before + 1
    want = fused_block_reference(x, packed, **call)
    assert got.dtype == BF16 and got.shape == want.shape
    assert torch.isfinite(got.float()).all()
    scale = want.float().abs().max().item()
    err = (got.float() - want.float()).abs().max().item()
    assert scale > 0 and err <= 0.03 * scale, (err, scale)


@pytest.mark.parametrize("name", list(BLOCKS))
def test_kernel_matches_plain(cuda, name):
    check_matches_plain(*case(name, cuda))


@pytest.mark.parametrize("name", list(BLOCKS_W64))
def test_kernel_matches_plain_w64(cuda, name):
    check_matches_plain(*case(name, cuda, blocks=BLOCKS_W64, batch=3))


@pytest.mark.parametrize("name", ["d0", "d1"])
def test_tile_size_does_not_change_output(cuda, name):
    x, packed, call = case(name, cuda, seed=3)
    outs = [fused_block_apply(x, packed, th=th, **call) for th in (0, 2, 4)]
    assert torch.equal(outs[0], outs[1]) and torch.equal(outs[0], outs[2])


@pytest.mark.parametrize("name", list(BLOCKS_W64))
def test_tile_size_does_not_change_output_w64(cuda, name):
    x, packed, call = case(name, cuda, seed=4, blocks=BLOCKS_W64, batch=3)
    want = fused_block_apply(x, packed, **call)
    for th in (1, 4, 32, 128):
        assert torch.equal(fused_block_apply(x, packed, th=th, **call), want)


def check_split_chain(cuda, blocks):
    cin, c1, cout, units, stride, s, _ = blocks["d2a"]
    blk = make_block(cin, c1, cout, units, stride, seed=5)
    x = torch.randn((2, s, s, cin), generator=torch.Generator().manual_seed(
        6)).to(cuda, BF16)
    whole = fused_block_apply(x, pack_block(blk, 6), count=6, stride=2)
    half = fused_block_apply(x, pack_block(blk, 3, final_bn=False), count=3,
                             stride=2, final_bn=False)
    out = fused_block_apply(half, pack_block(blk, 3, has_u0=False,
                                             unit_base=3),
                            count=3, stride=1, has_u0=False)
    assert torch.equal(whole, out)


def test_split_chain_equals_unsplit_block(cuda):
    check_split_chain(cuda, BLOCKS)


def test_split_chain_equals_unsplit_block_w64(cuda):
    check_split_chain(cuda, BLOCKS_W64)


def test_wrapper_checks_inputs(cuda):
    x, packed, call = case("d0", cuda)
    with pytest.raises(TypeError):
        fused_block_apply(x.float(), packed, **call)
    with pytest.raises(ValueError):  # not contiguous
        fused_block_apply(x.transpose(1, 2), packed, **call)
    with pytest.raises(ValueError):  # wrong channel count
        fused_block_apply(x[..., :16].contiguous(), packed, **call)
    with pytest.raises(ValueError):  # odd size at stride 2
        fused_block_apply(x[:, :31, :31].contiguous(), packed,
                          **dict(call, stride=2))
    narrow = pack_block(make_block(8, 8, 32, 3, 1), count=3)
    with pytest.raises(ValueError):  # channels not multiples of 32
        fused_block_apply(torch.zeros((1, 8, 8, 8), dtype=BF16, device=cuda),
                          narrow, count=3, stride=1)
    on_cpu = kernel_units(packed, "cpu", count=3)
    with pytest.raises(ValueError):  # kept layout on another device
        fused_block_apply(x, packed, units=on_cpu, **call)
    with pytest.raises(ValueError):  # kept layout of another unit count
        fused_block_apply(x, packed, units=kernel_units(
            packed, cuda, count=2), **dict(call, count=3))
    x1, packed1, call1 = case("d1", cuda)
    with pytest.raises(RuntimeError):  # the kernel refuses an oversize tile
        fused_block_apply(x1, packed1, th=256, **call1)
    with pytest.raises(RuntimeError):  # and a th that is not a power of 2
        fused_block_apply(x1, packed1, th=3, **call1)


@pytest.mark.parametrize("name", list(BLOCKS))
def test_kept_layout_equals_per_call_layout(cuda, name):
    x, packed, call = case(name, cuda, seed=7)
    units = kernel_units(packed, cuda, count=call["count"],
                         has_u0=call["has_u0"], final_bn=call["final_bn"])
    assert torch.equal(fused_block_apply(x, packed, units=units, **call),
                       fused_block_apply(x, packed, **call))


def test_launch_counter_counts_block_calls(cuda):
    x, packed, call = case("d1", cuda)
    before = fused_block_apply.launches
    for _ in range(3):
        fused_block_apply(x, packed, **call)
    fused_block_reference(x, packed, **call)
    assert fused_block_apply.launches == before + 3


def test_fused_forward_on_card(cuda):
    """Width 32, bf16: the fused forward runs K3 four times and stays
    within 15% of the standard forward's head scale (bf16 drift through
    ~100 layers of a random network)."""
    cfg = HoVerNetConfig(mode="fast", nr_types=None, width=W, dtype=BF16)
    net = HoVerNet(cfg, generator=torch.Generator().manual_seed(0))
    net = net.to(cuda).eval()
    x = torch.from_numpy(np.random.default_rng(0).integers(
        0, 255, (2, 256, 256, 3), dtype=np.uint8)).to(cuda)
    before = fused_block_apply.launches
    with torch.no_grad():
        got = fused_forward(net, x)
        want = net(x.permute(0, 3, 1, 2))
    assert fused_block_apply.launches == before + 4
    for name, w in want.items():
        g = got[name]
        assert g.shape == w.shape == (2, 2, 164, 164)
        assert torch.isfinite(g).all()
        rel = ((g - w).abs().max() / w.abs().max()).item()
        assert rel < 0.15, (name, rel)


def test_inference_forward_takes_k3_by_default(cuda):
    """Width 32, bf16, eval mode, autograd off: `steps.infer_output` runs
    d0..d2 as K3 (4 launches) and gives the heads of `fused_forward`
    exactly; in train mode, with autograd on, or inside
    `steps.standard_encoder()` it runs the standard encoder (no
    launch)."""
    cfg = HoVerNetConfig(mode="fast", nr_types=None, width=W, dtype=BF16)
    net = HoVerNet(cfg, generator=torch.Generator().manual_seed(0))
    net = net.to(cuda).eval()
    x = torch.from_numpy(np.random.default_rng(0).integers(
        0, 255, (2, 256, 256, 3), dtype=np.uint8)).to(cuda)
    before = fused_block_apply.launches
    with torch.no_grad():
        got = steps.infer_output(net, x)
        assert fused_block_apply.launches == before + 4
        out = fused_forward(net, x)
    want = torch.cat([torch.softmax(out["np"], 1)[:, 1:2], out["hv"]],
                     1).permute(0, 2, 3, 1)
    assert torch.equal(got, want)
    before = fused_block_apply.launches
    with torch.no_grad(), steps.standard_encoder():
        steps.infer_output(net, x)
    steps.infer_output(net, x)
    with torch.no_grad():
        steps.infer_output(net.train(), x)
    assert fused_block_apply.launches == before
