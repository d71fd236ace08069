"""Kernel K2, the standalone marker watershed (ops/watershed_cuda.py).

On the CPU the port's `watershed` (its plain version there) is held
against the JAX package's TPU kernel `watershed_pallas` in interpret mode
and against JAX `watershed_flood`, and `watershed_blocked` against
`watershed_pallas_blocked`, element for element, on the maps of
tests/test_watershed_pallas.py. The `gpu` tests hold the CUDA kernel
against the plain version on the card; they import no jax:
  python -m pytest --noconftest -m gpu tests/test_torch_watershed.py
"""

import numpy as np
import pytest
import torch

from hover_net_tpu_torch.ops import post_proc_device as tpp
from hover_net_tpu_torch.ops.watershed_cuda import (
    watershed,
    watershed_blocked,
    watershed_reference,
)

torch.set_num_threads(1)


def make_case(rng, shape=(128, 128), n=10):
    """tests/test_watershed_pallas.py's make_case with the port's CCL:
    (energy int32, markers int32, mask bool) [H, W]."""
    inst = np.zeros(shape, np.int32)
    yy, xx = np.mgrid[-10:11, -10:11]
    for k in range(1, n + 1):
        cy = rng.integers(12, shape[0] - 12)
        cx = rng.integers(12, shape[1] - 12)
        r = rng.integers(5, 9)
        sub = inst[cy - 10:cy + 11, cx - 10:cx + 11]
        sub[((yy**2 + xx**2) <= r * r) & (sub == 0)] = k
    core = inst.copy()
    core[:-1][np.diff(inst, axis=0) != 0] = 0
    core[:, :-1][np.diff(inst, axis=1) != 0] = 0
    markers = tpp.connected_components(torch.from_numpy(core[None] > 0))[0]
    energy = (rng.uniform(0, 1, shape) * 200).astype(np.int32)
    return energy, markers.numpy(), inst > 0


def stacked(cases):
    return [np.stack(x) for x in zip(*cases)]


CASES = {
    "seed0": lambda: stacked([make_case(np.random.default_rng(0))]),
    "seed1": lambda: stacked([make_case(np.random.default_rng(1))]),
    "batch3": lambda: stacked([make_case(r) for r in
                               [np.random.default_rng(2)] * 3]),
}


# ------------------------------------------------------------ on the CPU

@pytest.mark.parametrize("seed", [0, 1])
def test_make_case_is_the_jax_tests(seed):
    import test_watershed_pallas as jt

    for got, want in zip(make_case(np.random.default_rng(seed)),
                         jt.make_case(np.random.default_rng(seed))):
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", sorted(CASES))
def test_watershed_equals_jax(case):
    """== watershed_pallas(interpret=True) == JAX watershed_flood."""
    import jax.numpy as jnp

    from hover_net_tpu.ops.post_proc_device import watershed_flood
    from hover_net_tpu.ops.watershed_pallas import watershed_pallas

    e, m, b = CASES[case]()
    got = watershed(*(torch.from_numpy(x) for x in (e, m, b)))
    assert got.dtype == torch.int32 and got.shape == e.shape
    ej, mj, bj = (jnp.asarray(x) for x in (e, m, b))
    np.testing.assert_array_equal(
        got.numpy(), np.asarray(watershed_pallas(ej, mj, bj, interpret=True)))
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(watershed_flood(ej, mj, bj)))
    assert len(np.unique(got.numpy())) > 8 * e.shape[0]


def test_blocked_equals_pallas_blocked():
    """A 200x180 map cut into 64-px cores with 24-px halos: the port's
    window gather, per-window solve and reassembly give the JAX blocked
    entry's labels element for element."""
    import jax.numpy as jnp

    from hover_net_tpu.ops.watershed_pallas import watershed_pallas_blocked

    e, m, b = stacked([make_case(np.random.default_rng(5), (200, 180), 30)])
    got = watershed_blocked(*(torch.from_numpy(x) for x in (e, m, b)),
                            core=64, halo=24)
    want = watershed_pallas_blocked(*(jnp.asarray(x) for x in (e, m, b)),
                                    core=64, halo=24, interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert len(np.unique(want)) > 20


def test_arbitrary_positive_labels():
    """Markers are any positive int32 labels, not seed indices: markers
    relabelled in the same order, up to INT_MAX, give the relabelled
    watershed (ties go to the least label either way)."""
    e, m, b = (torch.from_numpy(x) for x in CASES["seed0"]())
    big = torch.where(m > 0, m + (2**31 - 1 - int(m.max())),
                      torch.zeros_like(m))
    got = watershed(e, big, b)
    want = watershed(e, m, b)
    lut = {int(a): int(c) for a, c in zip(m[m > 0], big[m > 0])}
    lut[0] = 0
    remapped = want.clone().apply_(lambda v: lut[v])
    assert torch.equal(got, remapped)


def test_watershed_rejects_other_devices():
    e = torch.zeros((1, 8, 8), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError):
        watershed(e, e, e.bool())


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def canvas_case(cuda):
    """The 1148^2 probe canvas' energy, markers and flood mask (the tail's
    stages before its watershed)."""
    from hover_net_tpu_torch.cli.probe_pp_stages import canvas_inputs
    from hover_net_tpu_torch.ops.post_proc_cuda import watershed_inputs

    return watershed_inputs(*canvas_inputs(1000, cuda))


# maps that stress the kernel's 32x32 tiles (tests/test_torch_pp_tiles.py):
# a serpentine flooded from one marker at either end, sides that are no
# multiples of 32, a batch of 3 with components on the map edges
TILING_CASES = ["serpentine", "serpentine_up", "ragged_97x45",
                "batch3_edges"]


@pytest.mark.gpu
@pytest.mark.parametrize("order", [0, 1, 2])
@pytest.mark.parametrize("case", sorted(CASES) + ["canvas_1148"]
                         + TILING_CASES)
def test_kernel_equals_plain(cuda, case, order):
    if case == "canvas_1148":
        e, m, b = canvas_case(cuda)
    elif case in TILING_CASES:
        from test_torch_pp_tiles import case as tiling_case

        e, m, b = (torch.from_numpy(x).to(cuda) for x in tiling_case(case))
    else:
        e, m, b = (torch.from_numpy(x).to(cuda) for x in CASES[case]())
    before = watershed.launches
    got = watershed(e, m, b, sweep_order=order)
    torch.cuda.synchronize()
    assert watershed.launches == before + 1
    want = watershed_reference(e, m, b)
    assert got.dtype == torch.int32 and got.shape == e.shape
    assert torch.equal(got, want), f"{(got != want).sum().item()} differ"


@pytest.mark.gpu
def test_kernel_on_the_tails_stages_gives_k1(cuda):
    from hover_net_tpu_torch.cli.probe_pp_stages import canvas_inputs
    from hover_net_tpu_torch.ops.post_proc_cuda import (
        proc_tail,
        watershed_inputs,
    )

    blb, sob = canvas_inputs(1000, cuda)
    assert torch.equal(watershed(*watershed_inputs(blb, sob)),
                       proc_tail(blb, sob))


@pytest.mark.gpu
def test_blocked_on_the_card(cuda):
    """800x700, 160 nuclei: the blocked entry equals its plain version
    (the same entry on the CPU, whose [9, 512, 512] window batch goes to
    watershed_reference) element for element, and the whole-map kernel
    at instance level (tests/test_watershed_pallas.py's contract: the
    same instances, labels equal on all but a sliver of pixels)."""
    e, m, b = stacked([make_case(np.random.default_rng(5), (800, 700), 160)])
    args = [torch.from_numpy(x).to(cuda) for x in (e, m, b)]
    got = watershed_blocked(*args)
    plain = watershed_blocked(*(torch.from_numpy(x) for x in (e, m, b)))
    assert torch.equal(got.cpu(), plain), \
        f"{(got.cpu() != plain).sum().item()} differ"
    whole = watershed(*args)
    assert len(torch.unique(got)) == len(torch.unique(whole)) > 100
    assert (got != whole).float().mean() < 1e-3


@pytest.mark.gpu
def test_wrapper_checks_inputs(cuda):
    e = torch.zeros((1, 32, 32), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        watershed(e, e[:, :16], e.bool())
    with pytest.raises(ValueError):
        watershed(e, e, e.bool(), sweep_order=3)
    with pytest.raises(ValueError):
        watershed(e, e.cpu(), e.bool())
    assert watershed(e[:0], e[:0], e[:0].bool()).shape == (0, 32, 32)
