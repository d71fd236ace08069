"""The tile steps of K1's CCL and watershed sweeps
(hover_net_tpu_torch/csrc/post_proc_tiles.cuh), on the CPU.

The header compiles as plain C++. tests/pp_tiles_harness.cpp runs each
tiled kernel of csrc/post_proc_tail.cu with its blocks and threads as
serial loops over the header's steps (one valid interleaving of the
card's, two interleavings in all: `MODES`), and is built here with g++
into a temporary directory. Its block-based union-find must give the
plain version's `connected_components` and `fill_holes`, and its tiled
watershed sweeps `watershed_reference` (and, on the tail's own stages,
`proc_tail_reference`), element for element, in every sweep order, on
maps that stress the tiling: one map-sized background component, a
serpentine that crosses many tiles, sides that are not multiples of the
tile, a batch of 3 whose components touch the map edges, an empty map
and the 164^2 tile map.
"""

import ctypes
import functools
import os
import shutil
import subprocess

import numpy as np
import pytest
import torch

from hover_net_tpu_torch.cli.probe_pp_stages import canvas_inputs
from hover_net_tpu_torch.ops import post_proc_device as tpp
from hover_net_tpu_torch.ops.nvcc_build import CSRC
from hover_net_tpu_torch.ops.post_proc_cuda import (
    SWEEP_ORDERS,
    check_sweep_order,
    proc_tail,
    proc_tail_reference,
    watershed_inputs,
)
from hover_net_tpu_torch.ops.watershed_cuda import watershed, watershed_reference

torch.set_num_threads(1)

HARNESS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                       "pp_tiles_harness.cpp")
MODES = (0, 1)  # the harness' interleavings (pp_tiles_harness.cpp)
I32P = ctypes.POINTER(ctypes.c_int32)
U8P = ctypes.POINTER(ctypes.c_uint8)


@pytest.fixture(scope="module")
def lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("needs g++ to build the harness")
    so = str(tmp_path_factory.mktemp("pp_tiles") / "pp_tiles.so")
    subprocess.run([gxx, "-std=c++17", "-O2", "-Wall", "-Wextra", "-Werror",
                    "-shared", "-fPIC", "-I", CSRC, "-o", so, HARNESS],
                   check=True, capture_output=True, text=True)
    h = ctypes.CDLL(so)
    h.ppt_ccl.argtypes = [U8P, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                          ctypes.c_int, ctypes.c_int, I32P]
    h.ppt_fill_holes.argtypes = [U8P, ctypes.c_int, ctypes.c_int,
                                 ctypes.c_int, ctypes.c_int, U8P]
    h.ppt_watershed.restype = ctypes.c_int
    h.ppt_watershed.argtypes = [I32P, I32P, U8P, ctypes.c_int, ctypes.c_int,
                                ctypes.c_int, ctypes.c_int, ctypes.c_int,
                                I32P, ctypes.POINTER(ctypes.c_int64)]
    return h


def ptr(a, kind):
    return a.ctypes.data_as(kind)


def harness_ccl(lib, mask, pol, mode):
    m = np.ascontiguousarray(mask, np.uint8)
    out = np.zeros(m.shape, np.int32)
    lib.ppt_ccl(ptr(m, U8P), pol, *m.shape, mode, ptr(out, I32P))
    return out


def harness_fill(lib, mask, mode):
    m = np.ascontiguousarray(mask, np.uint8)
    out = np.zeros(m.shape, np.uint8)
    lib.ppt_fill_holes(ptr(m, U8P), *m.shape, mode, ptr(out, U8P))
    return out.astype(bool)


def harness_watershed(lib, energy_q, markers, mask, order, mode):
    e = np.ascontiguousarray(energy_q, np.int32)
    m = np.ascontiguousarray(markers, np.int32)
    b = np.ascontiguousarray(mask, np.uint8)
    out = np.zeros(e.shape, np.int32)
    sweeps = np.zeros(2, np.int64)
    rc = lib.ppt_watershed(ptr(e, I32P), ptr(m, I32P), ptr(b, U8P), *e.shape,
                           order, mode, ptr(out, I32P),
                           sweeps.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)))
    assert rc == 0, "a phase exceeded the kernel's bound of sweeps"
    return out, sweeps


# ------------------------------------------------------------------ maps

def discs(shape, rng, n, r_lo=3, r_hi=9, margin=0):
    mask = np.zeros(shape, bool)
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    for _ in range(n):
        cy = rng.integers(margin, shape[0] - margin)
        cx = rng.integers(margin, shape[1] - margin)
        r = rng.integers(r_lo, r_hi)
        ring = rng.random() < 0.3  # some discs are rings: holes to fill
        d2 = (yy - cy) ** 2 + (xx - cx) ** 2
        mask |= (d2 <= r * r) & ~(ring & (d2 <= (r - 2) ** 2))
    return mask


def serpentine(h, w, width=2, gap=2):
    """A corridor `width` px wide that runs right, down, left, down, ...
    with `gap` px between its runs: one component whose path crosses
    every tile of the map, most of them many times."""
    mask = np.zeros((h, w), bool)
    rows = list(range(1, h - width, width + gap))
    for k, r in enumerate(rows):
        mask[r:r + width, 1:w - 1] = True
        if k + 1 < len(rows):
            c = (slice(w - 1 - width, w - 1) if k % 2 == 0
                 else slice(1, 1 + width))
            mask[r:rows[k + 1] + width, c] = True
    return mask


def core_markers(mask):
    """Markers from the mask: CCL of its pixels whose 4 neighbours are
    all in the mask (make_case's recipe)."""
    m = torch.from_numpy(mask)
    core = m.clone()
    core[:, 1:] &= m[:, :-1]
    core[:, :-1] &= m[:, 1:]
    core[:, 1:, :] &= m[:, :-1, :]
    core[:, :-1, :] &= m[:, 1:, :]
    return tpp.connected_components(core).numpy()


@functools.lru_cache(maxsize=None)
def case(name):
    """(energy_q int32, markers int32, mask bool), each [N, H, W]."""
    rng = np.random.default_rng(sum(map(ord, name)))
    if name == "tile_164":
        e, m, b = watershed_inputs(*canvas_inputs(164, "cpu"))
        return e.numpy(), m.numpy(), b.numpy()
    if name == "background":  # the background is one map-sized component
        mask = discs((100, 90), rng, 12, margin=10)[None]
    elif name.startswith("serpentine"):
        mask = serpentine(98, 100)[None]
    elif name == "ragged_97x45":
        mask = discs((97, 45), rng, 25)[None]
    elif name == "ragged_33x70":
        mask = discs((33, 70), rng, 12)[None]
    elif name == "batch3_edges":  # components run along every map edge
        mask = np.stack([discs((40, 70), rng, 14) for _ in range(3)])
        mask[:, 0, :] |= rng.random((3, 70)) < 0.7
        mask[:, -1, :] |= rng.random((3, 70)) < 0.7
        mask[:, :, 0] |= rng.random((3, 40)) < 0.7
    elif name == "empty":
        mask = np.zeros((1, 50, 60), bool)
    elif name == "tile_corners":  # 3-px components across two tile edges
        mask = np.zeros((1, 100, 130), bool)
        for y in range(32, 100, 32):
            for x in range(31, 129, 32):
                mask[0, y - 1:y + 1, x] = mask[0, y, x:x + 2] = True
    energy = rng.integers(0, 200, mask.shape).astype(np.int32)
    if name == "serpentine_up":  # one marker at the corridor's far end:
        markers = np.zeros(mask.shape, np.int32)  # the front runs up
        last = np.nonzero(mask[0].any(1))[0][-1]
        cols = np.nonzero(mask[0, last])[0]
        end = cols[0] if mask[0, last - 1, cols[-1]] else cols[-1]
        markers[0, last, end] = 5
        return energy, markers, mask
    if name == "serpentine":  # one marker at the corridor's start: the
        markers = np.zeros(mask.shape, np.int32)  # front runs down the tiles
        markers[0, 1, 1] = 2
    else:
        markers = core_markers(mask)
    return energy, markers, mask


MAPS = ("background", "serpentine", "ragged_97x45", "ragged_33x70",
        "batch3_edges", "empty", "tile_corners", "tile_164")
# the serpentine's mask with the marker at its other end, for the watershed
WS_MAPS = MAPS + ("serpentine_up",)


@functools.lru_cache(maxsize=None)
def plain_watershed(name):
    return watershed_reference(*(torch.from_numpy(x) for x in case(name))
                               ).numpy()


# ----------------------------------------------------------------- tests

@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", MAPS)
def test_ccl_equals_plain(lib, name, mode):
    """Both polarities: the mask's components and the background's."""
    mask = case(name)[2]
    for pol, m in ((1, mask), (0, ~mask)):
        want = tpp.connected_components(torch.from_numpy(m)).numpy()
        np.testing.assert_array_equal(harness_ccl(lib, mask, pol, mode), want)
    if name == "background":  # one component holds most of the map
        assert (want == 1).mean() > 0.8
    if name == "serpentine":
        assert len(np.unique(harness_ccl(lib, mask, 1, mode))) == 2
    if name == "tile_corners":  # none split where it crosses two tiles
        sizes = np.bincount(harness_ccl(lib, mask, 1, mode).ravel())[1:]
        assert set(sizes[sizes > 0]) == {3}


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("name", MAPS)
def test_fill_holes_equals_plain(lib, name, mode):
    mask = case(name)[2]
    want = tpp.fill_holes(torch.from_numpy(mask)).numpy()
    np.testing.assert_array_equal(harness_fill(lib, mask, mode), want)
    if name in ("background", "ragged_97x45"):
        assert want.sum() > mask.sum()  # the rings' holes were filled


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("order", SWEEP_ORDERS)
@pytest.mark.parametrize("name", WS_MAPS)
def test_watershed_equals_plain(lib, name, order, mode):
    got, sweeps = harness_watershed(lib, *case(name), order, mode)
    want = plain_watershed(name)
    np.testing.assert_array_equal(got, want)
    assert sweeps.min() >= 1
    if name.startswith("serpentine"):  # one instance, flooded end to end
        assert (want > 0).sum() == case(name)[2].sum()
        assert len(np.unique(want)) == 2
        if mode == 1:  # a front crosses one tile border per sweep
            assert sweeps.min() > 6
    elif name not in ("empty", "tile_corners"):  # (the latter: no markers)
        assert len(np.unique(want)) > 5


@pytest.mark.parametrize("order", SWEEP_ORDERS)
def test_tail_watershed_gives_k1(lib, order):
    """On the 164^2 tile map, the tiled watershed of the tail's own
    stages gives the plain K1's labels."""
    blb, sob = canvas_inputs(164, "cpu")
    got, _ = harness_watershed(lib, *case("tile_164"), order, 0)
    np.testing.assert_array_equal(got, proc_tail_reference(blb, sob).numpy())


def test_sweep_order_checks_the_tile_count():
    """Order 2 permutes the tiles with a prime stride: a batch of
    7919 tiles (a multiple of the stride) is refused, others pass."""
    check_sweep_order(2, 1, 1148, 1148)
    check_sweep_order(1, 7919, 32, 32)
    with pytest.raises(ValueError):
        check_sweep_order(2, 7919, 32, 32)
    with pytest.raises(ValueError):
        check_sweep_order(3, 1, 64, 64)


def test_stats_need_the_kernel():
    """The split is the kernel's: the plain path refuses `stats`."""
    e, m, b = (torch.from_numpy(x) for x in case("ragged_33x70"))
    with pytest.raises(ValueError):
        watershed(e, m, b, stats={})
    blb, sob = canvas_inputs(164, "cpu")
    with pytest.raises(ValueError):
        proc_tail(blb, sob, stats={})
