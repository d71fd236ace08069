"""Kernel K1 (csrc/post_proc_tail.cu) against its plain version, on the
card. Every test here needs a CUDA device and skips without one.

This file imports no jax, so it runs on a machine without it:
  python -m pytest --noconftest -m gpu tests/test_torch_kernels.py
(tests/conftest.py configures jax for the CPU suites).
"""

import functools

import numpy as np
import pytest
import torch

from hover_net_tpu_torch.ops.targets import gen_instance_hv_map
from hover_net_tpu_torch.ops import post_proc_device as tpp
from hover_net_tpu_torch.ops.post_proc_cuda import (
    STAGES,
    proc_tail,
    proc_tail_reference,
)

pytestmark = pytest.mark.gpu


def nuclei_pred(shape, rng, n, edge_touching=False):
    """Synthetic (np prob, hv x, hv y) map of `n` disc nuclei, the recipe
    of tests/test_post_proc_pallas.py."""
    inst = np.zeros(shape, np.int32)
    yy, xx = np.mgrid[-12:13, -12:13]
    lo = 3 if edge_touching else 14
    for k in range(1, n + 1):
        cy = int(rng.integers(lo, shape[0] - lo))
        cx = int(rng.integers(lo, shape[1] - lo))
        r = int(rng.integers(4, 11))
        m = (yy**2 + xx**2) <= r * r
        y0, y1 = max(cy - 12, 0), min(cy + 13, shape[0])
        x0, x1 = max(cx - 12, 0), min(cx + 13, shape[1])
        sub = inst[y0:y1, x0:x1]
        mm = m[(y0 - (cy - 12)):(y1 - (cy - 12)),
               (x0 - (cx - 12)):(x1 - (cx - 12))]
        sub[mm & (sub == 0)] = k
    hv = gen_instance_hv_map(inst, shape)
    return np.dstack([(inst > 0).astype(np.float32),
                      hv[..., 0], hv[..., 1]]).astype(np.float32)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


def energy(pred, cuda, valid=None):
    p = torch.from_numpy(pred).to(cuda)
    v = None if valid is None else torch.from_numpy(valid).to(cuda)
    return tpp.energy_inputs(p, v)


def maps():
    """(name, [N, H, W, 3] pred, valid or None)."""
    rng = np.random.default_rng(0)
    out = [("nuclei", nuclei_pred((256, 256), rng, 120)[None], None),
           ("edge", nuclei_pred((200, 180), rng, 80, True)[None], None)]
    noisy = nuclei_pred((240, 232), rng, 100, True)
    noisy = noisy + rng.normal(0, 0.08, noisy.shape).astype(np.float32)
    out.append(("noisy", noisy[None], None))
    out.append(("empty", np.zeros((1, 96, 96, 3), np.float32), None))
    batch = np.stack([nuclei_pred((128, 128), rng, 30) for _ in range(3)])
    out.append(("batch", batch, None))
    src, size = 150, 192
    rr = np.arange(size)
    idx = np.where(rr < src, rr, np.clip(2 * src - 2 - rr, 0, None))
    mirrored = nuclei_pred((src, src), rng, 50, True)[idx][:, idx]
    valid = ((rr < src)[:, None] & (rr < src)[None, :])[None]
    out.append(("mirrored", mirrored[None], valid))
    return out


@pytest.mark.parametrize("case", range(6))
def test_kernel_equals_plain(cuda, case):
    name, pred, valid = maps()[case]
    blb, sob = energy(pred, cuda, valid)
    before = proc_tail.launches
    got = proc_tail(blb, sob)
    torch.cuda.synchronize()
    assert proc_tail.launches == before + 1
    want = proc_tail_reference(blb, sob)
    assert got.dtype == torch.int32 and got.shape == blb.shape
    assert torch.equal(got, want), (
        f"{name}: {(got != want).sum().item()} labels differ")
    if name != "empty":
        assert len(torch.unique(want)) > 10


@functools.lru_cache(maxsize=None)
def tiling_map(name):
    """(blb, sob, plain labels) on the card of maps that stress the
    kernel's 32x32 tiles: a serpentine blob flooded from one marker at
    its start (the front crosses many tiles, so the watershed takes many
    sweeps), sides that are no multiples of 32, and a batch of 3 with
    nuclei on the map edges."""
    from test_torch_pp_tiles import serpentine

    cuda = torch.device("cuda")
    rng = np.random.default_rng(7)
    if name == "serpentine":
        blb = serpentine(160, 150, width=6, gap=3)
        sob = np.full(blb.shape, 0.5, np.float32)
        sob[:8, :16] = 0.1  # the only marker: overall < 0.4 there
        blb, sob = (torch.from_numpy(x[None]).to(cuda) for x in (blb, sob))
    else:
        if name == "ragged":
            pred = nuclei_pred((97, 45), rng, 12, True)[None]
        else:
            pred = np.stack([nuclei_pred((100, 70), rng, 25, True)
                             for _ in range(3)])
        blb, sob = energy(pred, cuda)
    return blb, sob, proc_tail_reference(blb, sob)


@pytest.mark.parametrize("order", [0, 1, 2])
@pytest.mark.parametrize("name", ["serpentine", "ragged", "batch3_edges"])
def test_tiling_maps_equal_plain(cuda, name, order):
    blb, sob, want = tiling_map(name)
    stats = {}
    got = proc_tail(blb, sob, sweep_order=order, stats=stats)
    assert torch.equal(got, want), f"{(got != want).sum().item()} differ"
    if name == "serpentine":  # one instance, flooded end to end
        assert torch.equal(want > 0, blb) and len(torch.unique(want)) == 2
        assert stats["sweeps"]["ws_phase1"] > 3
    else:
        assert len(torch.unique(want)) > 5


def test_sweep_order_does_not_change_labels(cuda):
    """The in-place relaxations reach the same fixpoint in every order."""
    rng = np.random.default_rng(4)
    pred = nuclei_pred((512, 500), rng, 700)
    pred = pred + rng.normal(0, 0.05, pred.shape).astype(np.float32)
    blb, sob = energy(pred[None], cuda)
    runs = [proc_tail(blb, sob, sweep_order=o) for o in (0, 1, 2)]
    assert torch.equal(runs[0], runs[1]) and torch.equal(runs[0], runs[2])
    assert torch.equal(runs[0], proc_tail_reference(blb, sob))


def test_device_path_equals_cpu_path(cuda):
    """The port's proc_np_hv_batch gives the same labels on the card
    (Sobel energy + kernel) as on the CPU (Sobel energy + plain tail)."""
    pred = nuclei_pred((256, 256), np.random.default_rng(9), 150, True)[None]
    got = tpp.proc_np_hv_batch(torch.from_numpy(pred).to(cuda))
    want = tpp.proc_np_hv_batch(torch.from_numpy(pred))
    assert torch.equal(got.cpu(), want)


def test_stage_split(cuda):
    """`stats` receives the call's split: a time for every stage, whose
    sum lies within the whole call's time (CUDA events around it), and a
    positive sweep count for each watershed phase; the labels are the
    same as without it."""
    rng = np.random.default_rng(6)
    blb, sob = energy(nuclei_pred((300, 260), rng, 150)[None], cuda)
    want = proc_tail(blb, sob)
    proc_tail(blb, sob, stats={})  # warm-up
    stats = {}
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    got = proc_tail(blb, sob, stats=stats)
    end.record()
    end.synchronize()
    assert torch.equal(got, want)
    assert set(stats["stage_ms"]) == set(STAGES)
    assert all(v >= 0 for v in stats["stage_ms"].values())
    total = sum(stats["stage_ms"].values())
    assert 0 < total <= start.elapsed_time(end) + 0.01
    assert stats["sweeps"]["ws_phase1"] > 0
    assert stats["sweeps"]["ws_phase2"] > 0


def test_wrapper_checks_inputs(cuda):
    blb = torch.zeros((1, 32, 32), dtype=torch.bool, device=cuda)
    sob = torch.zeros((1, 32, 32), device=cuda)
    with pytest.raises(TypeError):
        proc_tail(blb, sob.double())
    with pytest.raises(ValueError):
        proc_tail(blb, sob[:, :16])
    with pytest.raises(ValueError):
        proc_tail(blb, sob, sweep_order=3)
