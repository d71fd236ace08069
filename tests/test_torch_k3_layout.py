"""K3's weight layout (ops/fused_block_cuda.kernel_units) and its count
of launches, FLOPs and bytes (launch_plan), on the CPU.

The kernel reads every convolution's weights K-major as [cout][taps][k]
(a 1x1 weight [K, N] as [N, K], the 3x3 taps [9, K, N] as [N, 9, K]) and
its tap (dy, dx) at input pixel stride * q + d - (stride == 1), zero
outside the map. Here the layout is taken back to `packed`, and a 3x3
product in the kernel's terms equals the plain version's 'SAME' conv.
"""

import numpy as np
import pytest
import torch
from torch import nn

from hover_net_tpu_torch.models.blocks import ResidualBlock
from hover_net_tpu_torch.models.encoder_fused import pack_block
from hover_net_tpu_torch.ops.fused_block_cuda import (
    BF16,
    _conv3x3,
    kernel_units,
    launch_plan,
)

# (cin, c1, cout, units in the module, stride, pack kwargs): w32 blocks
BLOCKS = {
    "d0": (32, 32, 128, 3, 1, dict(count=3)),
    "d1": (128, 64, 256, 4, 2, dict(count=4)),
    "d2a": (256, 128, 512, 6, 2, dict(count=3, final_bn=False)),
    "d2b": (256, 128, 512, 6, 2, dict(count=3, has_u0=False, unit_base=3)),
}

# the units' BN scale and offset keys
AFFINES = ("pre_s", "pre_o", "s1", "o1", "s2", "o2", "sb", "ob")


@torch.no_grad()
def make_block(cin, c1, cout, count, stride, seed=0):
    g = torch.Generator().manual_seed(seed)
    blk = ResidualBlock(cin, (c1, c1, cout), count, stride)
    for m in blk.modules():
        if isinstance(m, nn.Conv2d):
            m.weight.normal_(0.0, 0.05, generator=g)
        elif isinstance(m, nn.BatchNorm2d):
            m.weight.uniform_(0.5, 1.5, generator=g)
            m.bias.normal_(0.0, 0.1, generator=g)
            m.running_mean.normal_(0.0, 0.1, generator=g)
            m.running_var.uniform_(0.5, 1.5, generator=g)
    return blk.eval()


@pytest.mark.parametrize("name", list(BLOCKS))
def test_kernel_units_round_trip_to_packed(name):
    cin, c1, cout, n_units, stride, kw = BLOCKS[name]
    packed = pack_block(make_block(cin, c1, cout, n_units, stride), **kw)
    has_u0, final_bn = kw.get("has_u0", True), kw.get("final_bn", True)
    units = kernel_units(packed, "cpu", count=kw["count"], has_u0=has_u0,
                         final_bn=final_bn)
    assert len(units) == kw["count"]
    for u in units:  # bf16 weights, float32 BN affines
        assert all(t.dtype == (torch.float32 if k in AFFINES else BF16)
                   and t.is_contiguous() for k, t in u.items())
        assert u["w1t"].shape[0] == u["w2t"].shape[0] == c1
        assert u["w2t"].shape[1:] == (9, c1) and u["w3t"].shape == (cout, c1)

    def same(kernel_t, packed_t):
        assert torch.equal(kernel_t, packed_t.to(kernel_t.dtype))

    rest = units[1:] if has_u0 else units
    if has_u0:
        u0 = units[0]
        assert "pre_s" not in u0 and u0["wsct"].shape == (cout, cin)
        same(u0["wsct"].t(), packed["wsc"])
        same(u0["w1t"].t(), packed["w1_0"])
        same(u0["w2t"].permute(1, 2, 0), packed["w2_0"])
        same(u0["w3t"].t(), packed["w3_0"])
        for k in ("s1", "o1", "s2", "o2"):
            same(u0[k], packed[f"{k}_0"])
    for i, u in enumerate(rest):
        assert "wsct" not in u
        same(u["w1t"].t(), packed["w1r"][i])
        same(u["w2t"].permute(1, 2, 0), packed["w2r"][9 * i:9 * i + 9])
        same(u["w3t"].t(), packed["w3r"][i])
        for k, pk in (("pre_s", "ps"), ("pre_o", "po"), ("s1", "s1r"),
                      ("o1", "o1r"), ("s2", "s2r"), ("o2", "o2r")):
            same(u[k], packed[pk][i])
    assert ("sb" in units[-1]) == final_bn
    assert not any("sb" in u for u in units[:-1])
    if final_bn:
        same(units[-1]["sb"], packed["sb"])
        same(units[-1]["ob"], packed["ob"])


@pytest.mark.parametrize("stride,size", [(1, 9), (2, 12)])
def test_kernel_taps_equal_the_plain_same_conv(stride, size):
    """The kernel's 3x3 product, tap by tap from the [N, 9, K] weights at
    the kernel's input offsets (zero outside the map), gives the plain
    version's 'SAME' conv bit for bit."""
    rng = np.random.default_rng(stride)
    c = 32
    t = torch.from_numpy(rng.normal(size=(2, size, size, c))).to(BF16)
    w2 = torch.from_numpy(rng.normal(0, 0.1, (9, c, c))).to(BF16)
    w2t = kernel_units({"wsc": w2[0], "w1_0": w2[0], "s1_0": w2[0, 0],
                        "o1_0": w2[0, 0], "w2_0": w2, "s2_0": w2[0, 0],
                        "o2_0": w2[0, 0], "w3_0": w2[0]},
                       "cpu", count=1, final_bn=False)[0]["w2t"]
    s_out = size // stride
    q = torch.arange(s_out)
    acc = None
    pad = int(stride == 1)
    for tap in range(9):
        dy, dx = divmod(tap, 3)
        iy = stride * q + dy - pad
        ix = stride * q + dx - pad
        ok = ((iy >= 0) & (iy < size))[:, None] & ((ix >= 0) & (ix < size))
        a = t[:, iy.clamp(0, size - 1)][:, :, ix.clamp(0, size - 1)]
        a = a * ok[None, :, :, None].to(BF16)
        v = torch.matmul(a.float(), w2t[:, tap, :].t().float())
        acc = v if acc is None else acc + v
    assert torch.equal(acc.to(BF16), _conv3x3(t, w2, stride))


def test_launch_plan_counts_each_launch():
    """A hand count at [1, 4, 4, 32], c1 32, cout 64, two units, stride 2:
    conv1 at the input's 16 pixels, then 4 output pixels; unit 0's conv3
    reads the 4 sampled input pixels and the shortcut weights in place of
    a residual."""
    plan = launch_plan((1, 4, 4, 32), 32, 64, count=2, stride=2)
    assert plan == [
        ("u0.conv1", 2 * 16 * 32 * 32, 2 * (16 * 32 + 32 * 32 + 16 * 32)),
        ("u0.conv2", 2 * 4 * 9 * 32 * 32, 2 * (16 * 32 + 9 * 32 * 32 + 4 * 32)),
        ("u0.conv3+shortcut", 2 * 4 * 32 * 64 * 2,
         2 * (4 * 32 + 32 * 64 + 4 * 64 + 4 * 32 + 32 * 64)),
        ("u1.conv1", 2 * 4 * 64 * 32, 2 * (4 * 64 + 64 * 32 + 4 * 32)),
        ("u1.conv2", 2 * 4 * 9 * 32 * 32, 2 * (4 * 32 + 9 * 32 * 32 + 4 * 32)),
        ("u1.conv3", 2 * 4 * 32 * 64, 2 * (4 * 32 + 32 * 64 + 2 * 4 * 64)),
    ]


def test_launch_plan_counts_a_continuation_unit():
    """A hand count at [1, 4, 4, 64], c1 32, cout 64, one unit of a
    continuation call (no unit 0, stride 1): every launch at the 16
    pixels, conv3 reads its input back as the residual."""
    plan = launch_plan((1, 4, 4, 64), 32, 64, count=1, stride=1,
                       has_u0=False)
    assert plan == [
        ("u0.conv1", 2 * 16 * 64 * 32, 2 * (16 * 64 + 64 * 32 + 16 * 32)),
        ("u0.conv2", 2 * 16 * 9 * 32 * 32,
         2 * (16 * 32 + 9 * 32 * 32 + 16 * 32)),
        ("u0.conv3", 2 * 16 * 32 * 64, 2 * (16 * 32 + 32 * 64 + 2 * 16 * 64)),
    ]


@pytest.mark.parametrize("name", list(BLOCKS))
def test_launch_plan_flops_equal_the_weights_products(name):
    """The plan's FLOPs are 2 x every weight x the pixels it sees (unit
    0's conv1 at the input's size, the rest at the output's): the count
    chip_smoke.py takes for K3's bound comes from the plan alone."""
    cin, c1, cout, n_units, stride, kw = BLOCKS[name]
    packed = pack_block(make_block(cin, c1, cout, n_units, stride), **kw)
    has_u0 = kw.get("has_u0", True)
    n, s = 3, 16
    s_in_ch = cin if has_u0 else cout
    conv_stride = stride if has_u0 else 1
    p_in, p_out = n * s * s, n * (s // conv_stride) ** 2
    want = sum(2 * w.numel() * (p_in if k == "w1_0" else p_out)
               for k, w in packed.items() if k[0] == "w")
    plan = launch_plan((n, s, s, s_in_ch), c1, cout, count=kw["count"],
                       stride=conv_stride, has_u0=has_u0)
    assert len(plan) == 3 * kw["count"]
    assert sum(f for _, f, _ in plan) == want
