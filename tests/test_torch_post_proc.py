"""The port's post-processing against the JAX package's, on the CPU.

The same numpy inputs go through hover_net_tpu.ops and
hover_net_tpu_torch.ops. Labels must be equal element for element to the
JAX exact path, `proc_np_hv_batch(exact=True)`; filters agree to 1e-5 on
normalised values; label compaction and instance tables are identical.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from hover_net_tpu.ops import filters as jf
from hover_net_tpu.ops import post_proc_device as jpp
from hover_net_tpu.ops.cc_np import ellipse_structuring_element
from hover_net_tpu_torch.ops import filters as tf
from hover_net_tpu_torch.ops import post_proc_device as tpp
from hover_net_tpu_torch.ops.post_proc_cuda import (
    proc_tail,
    proc_tail_reference,
)

from test_torch_kernels import nuclei_pred


def make_map(kind):
    """[1, H, W, 3] test maps: nuclei, nuclei touching the edge, the same
    with noise, and an empty map."""
    if kind == "empty":
        return np.zeros((1, 96, 96, 3), np.float32)
    rng = np.random.default_rng({"nuclei": 0, "edge": 3, "noisy": 5,
                                 "noisy_edge": 7}[kind])
    shape = (120, 100) if kind == "noisy" else (128, 128)
    pred = nuclei_pred(shape, rng, 25, edge_touching="edge" in kind)
    if "noisy" in kind:
        pred = pred + rng.normal(0, 0.05, pred.shape).astype(np.float32)
    return pred[None]


def jax_energy(pred, valid=None):
    """(blb, sob) as the JAX package computes them before its tail."""
    p = jnp.asarray(pred)
    v = None if valid is None else jnp.asarray(valid)
    blb = p[..., 0] >= 0.5
    if v is not None:
        blb = blb & v
    sh = 1.0 - jf.minmax_norm(jf.sobel_h(jf.minmax_norm(p[..., 1], where=v),
                                         21), where=v)
    sv = 1.0 - jf.minmax_norm(jf.sobel_v(jf.minmax_norm(p[..., 2], where=v),
                                         21), where=v)
    return np.asarray(blb), np.asarray(jnp.maximum(sh, sv))


MAPS = ["nuclei", "edge", "noisy", "noisy_edge", "empty"]


@pytest.mark.parametrize("kind", MAPS)
def test_tail_reference_equals_jax_exact(kind):
    pred = make_map(kind)
    want = np.asarray(jpp.proc_np_hv_batch(jnp.asarray(pred), exact=True))
    blb, sob = jax_energy(pred)
    got = proc_tail_reference(torch.from_numpy(blb), torch.from_numpy(sob))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    if kind != "empty":
        assert len(np.unique(want)) > 10


@pytest.mark.parametrize("kind", MAPS)
def test_proc_np_hv_batch_equals_jax_exact(kind):
    pred = make_map(kind)
    want = np.asarray(jpp.proc_np_hv_batch(jnp.asarray(pred), exact=True))
    got = tpp.proc_np_hv_batch(torch.from_numpy(pred))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kind", ["nuclei", "noisy_edge"])
def test_tail_equals_tpu_kernel_interpreted(kind):
    """At <= 256^2 the TPU kernel (interpret mode, one window, no halo)
    gives the same labels."""
    from hover_net_tpu.ops.post_proc_pallas import proc_tail_blocked

    blb, sob = jax_energy(make_map(kind))
    want = np.asarray(proc_tail_blocked(jnp.asarray(blb), jnp.asarray(sob),
                                        core=256, halo=0, interpret=True))
    got = proc_tail(torch.from_numpy(blb), torch.from_numpy(sob))
    np.testing.assert_array_equal(got.numpy(), want)


def test_mirrored_canvas_with_valid_mask():
    """A source mirrored reflect-101 over a larger canvas, instances
    confined to the valid region (tests/test_post_proc_device.py)."""
    rng = np.random.default_rng(11)
    src, size = 96, 128
    pred = nuclei_pred((src, src), rng, 30)
    rr = np.arange(size)
    idx = np.where(rr < src, rr, np.clip(2 * src - 2 - rr, 0, None))
    full = pred[idx][:, idx][None]
    valid = ((rr < src)[:, None] & (rr < src)[None, :])[None]
    want = np.asarray(jpp.proc_np_hv_batch(jnp.asarray(full),
                                           jnp.asarray(valid), exact=True))
    got = tpp.proc_np_hv_batch(torch.from_numpy(full),
                               torch.from_numpy(valid))
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[0, src:].max() == 0 and want[0, :, src:].max() == 0
    assert len(np.unique(want)) > 10


def test_filters_match_jax():
    rng = np.random.default_rng(1)
    x = rng.uniform(-1, 1, (2, 48, 40)).astype(np.float32)
    where = np.zeros(x.shape, bool)
    where[:, :40, :33] = True
    xt, wt = torch.from_numpy(x), torch.from_numpy(where)
    xj, wj = jnp.asarray(x), jnp.asarray(where)
    for name in ("sobel_h", "sobel_v"):
        want = np.asarray(jf.minmax_norm(getattr(jf, name)(xj, 21)))
        got = tf.minmax_norm(getattr(tf, name)(xt, 21)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-5,
                                   err_msg=name)
    np.testing.assert_allclose(tf.gaussian_blur_3x3(xt).numpy(),
                               np.asarray(jf.gaussian_blur_3x3(xj)),
                               rtol=0, atol=1e-5)
    np.testing.assert_allclose(tf.minmax_norm(xt, where=wt).numpy(),
                               np.asarray(jf.minmax_norm(xj, where=wj)),
                               rtol=0, atol=1e-5)
    const = np.full((1, 8, 8), 3.0, np.float32)
    assert tf.minmax_norm(torch.from_numpy(const)).abs().max() == 0

    selem = ellipse_structuring_element(5, 5)
    mask = rng.uniform(size=(2, 40, 36)) > 0.4
    np.testing.assert_array_equal(
        tf.dilate(tf.erode(torch.from_numpy(mask), selem), selem).numpy(),
        np.asarray(jf.dilate(jf.erode(jnp.asarray(mask), selem), selem)))


def test_building_blocks_match_jax():
    rng = np.random.default_rng(2)
    mask = rng.uniform(size=(2, 48, 44)) > 0.55
    lab_j = np.asarray(jpp.connected_components(jnp.asarray(mask)))
    lab_t = tpp.connected_components(torch.from_numpy(mask))
    np.testing.assert_array_equal(lab_t.numpy(), lab_j)
    np.testing.assert_array_equal(
        tpp.remove_small(lab_t, 4).numpy(),
        np.asarray(jpp.remove_small(jnp.asarray(lab_j), 4, 48 * 44 + 1)))
    np.testing.assert_array_equal(
        tpp.fill_holes(torch.from_numpy(mask)).numpy(),
        np.asarray(jpp.fill_holes(jnp.asarray(mask))))

    energy = rng.integers(0, 64, (2, 48, 44)).astype(np.int32)
    markers = np.where(rng.uniform(size=energy.shape) > 0.98,
                       rng.integers(1, 50, energy.shape), 0).astype(np.int32)
    flood = rng.uniform(size=energy.shape) > 0.1
    want = np.asarray(jpp.watershed_flood(
        jnp.asarray(energy), jnp.asarray(markers), jnp.asarray(flood)))
    got = tpp.watershed_flood(torch.from_numpy(energy),
                              torch.from_numpy(markers),
                              torch.from_numpy(flood))
    np.testing.assert_array_equal(got.numpy(), want)

    q = np.array([0, 5, (3 << 15) | 7, (3 << 15) | 0x7FFF, 2**31 - 1],
                 np.int32)
    e = np.array([1 << 15, 0, 2 << 15, 3 << 15, 65535 << 15], np.int32)
    np.testing.assert_array_equal(
        tpp.cross_cost(torch.from_numpy(q), torch.from_numpy(e)).numpy(),
        np.asarray(jpp.cross_cost(jnp.asarray(q), jnp.asarray(e))))


@pytest.mark.parametrize("nr_types", [None, 5])
@pytest.mark.parametrize("caps", [(4096, 1 << 14), (8, 256)],
                         ids=["fits", "overflows"])
def test_window_tables_equal_instance_tables(nr_types, caps):
    """The WSI's batched window tables (no host read) against the tile's
    `instance_tables` of each window alone: crops of ragged sizes,
    renumbered as the manager renumbers them, at the top left of a zero
    canvas. The same `coo[:coo_n]`, `coo_n`, sizes, sums and type
    histograms (rows 1..stat_cap) and the bbox of every present id, also
    where the ids pass `stat_cap` and the boundary passes `coo_cap`."""
    stat_cap, coo_cap = caps
    pred = np.concatenate([make_map("nuclei"), make_map("edge")])
    inst = tpp.proc_np_hv_batch(torch.from_numpy(pred))
    lab = tpp.compact_labels_u16(inst)[0].to(torch.int32)
    tp = torch.from_numpy(np.random.default_rng(4).integers(
        0, 7, lab.shape).astype(np.uint8))
    boxes = ((0, 128, 0, 128), (17, 120, 3, 77), (40, 41, 60, 90),
             (5, 128, 64, 128))
    src = (0, 1, 1, 0)
    h, w = lab.shape[1:]
    canvas = torch.zeros((len(boxes), h, w), dtype=torch.int32)
    tp_canvas = torch.zeros((len(boxes), h, w), dtype=torch.uint8)
    crops = []
    for k, (b, (y0, y1, x0, x1)) in enumerate(zip(src, boxes)):
        crop = tpp.remap_labels_u16(lab[b, y0:y1, x0:x1])
        crops.append((crop, tp[b, y0:y1, x0:x1]))
        canvas[k, :y1 - y0, :x1 - x0] = crop
        tp_canvas[k, :y1 - y0, :x1 - x0] = crops[-1][1]
    got = tpp.window_tables(canvas, tp_canvas, nr_types, stat_cap, coo_cap)
    assert set(got) == {"coo", "coo_n", "bbox", "sum_yx", "size", "n"} | (
        {"type_hist"} if nr_types else set())
    if stat_cap == 8:  # the ids pass one cap and the boundary the other
        assert int(got["n"].max()) > stat_cap
        assert int(got["coo_n"].max()) > coo_cap
    for k, (crop, tp_crop) in enumerate(crops):
        want = tpp.instance_tables(crop, tp_crop, coo_cap=coo_cap,
                                   stat_cap=stat_cap, nr_types=nr_types)
        n = int(crop.max())
        assert int(got["n"][k]) == n
        assert int(got["coo_n"][k]) == int(want["coo_n"])
        np.testing.assert_array_equal(got["coo"][k].numpy(),
                                      want["coo"].numpy())
        for key in ("size", "sum_yx") + (("type_hist",) if nr_types else ()):
            np.testing.assert_array_equal(got[key][k, 1:].numpy(),
                                          want[key][1:].numpy(), err_msg=key)
        top = min(n, stat_cap) + 1
        np.testing.assert_array_equal(got["bbox"][k, 1:top].numpy(),
                                      want["bbox"][1:top].numpy())


@pytest.mark.parametrize("nr_types", [None, 5])
def test_compaction_and_tables_match_jax(nr_types):
    """Same seed-index label map -> identical uint16 ids, label counts
    and tables, including capacity overflow (coo_cap, stat_cap)."""
    pred = np.concatenate([make_map("nuclei"), make_map("edge")])
    inst = np.asarray(jpp.proc_np_hv_batch(jnp.asarray(pred), exact=True))
    cj, nj = jpp.compact_labels_u16(jnp.asarray(inst))
    ct, nt = tpp.compact_labels_u16(torch.from_numpy(inst))
    assert ct.dtype == torch.uint16
    np.testing.assert_array_equal(ct.numpy(), np.asarray(cj))
    np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))

    lab = np.asarray(cj)[1].astype(np.int32)
    tp = np.random.default_rng(4).integers(0, 7, lab.shape).astype(np.uint8)
    for coo_cap, stat_cap in ((1 << 14, 4096), (256, 8)):
        want = jpp.instance_tables(jnp.asarray(lab), jnp.asarray(tp),
                                   coo_cap=coo_cap, stat_cap=stat_cap,
                                   nr_types=nr_types,
                                   with_sums=nr_types is not None)
        got = tpp.instance_tables(torch.from_numpy(lab), torch.from_numpy(tp),
                                  coo_cap=coo_cap, stat_cap=stat_cap,
                                  nr_types=nr_types,
                                  with_sums=nr_types is not None)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                          err_msg=f"{k} cap {coo_cap}")
