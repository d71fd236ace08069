"""Kernel K4, the post-processing tail's stage-ablation variants
(`proc_tail(skip=...)`), and the stage probe (cli/probe_pp_stages.py).

On the CPU every variant of the plain version is held against a JAX
composition of the same stages, in the order of scripts/probe_pp_stages.py
(with the JAX exact path's reflect-101 blur, as K4 blurs): skip="none"
against `proc_np_hv_batch(exact=True)`, the rest against the JAX
package's post_proc_device functions, and "ws_phase2" against
post_proc_pallas._ws_cost_sweep run to its fixpoint outside any kernel.
The `gpu` tests hold the kernel against the plain version on the card;
they import no jax:
  python -m pytest --noconftest -m gpu tests/test_torch_pp_stages.py
"""

import functools

import numpy as np
import pytest
import torch

from hover_net_tpu_torch.cli import probe_pp_stages
from hover_net_tpu_torch.ops.post_proc_cuda import (
    SKIPS,
    proc_tail,
    proc_tail_reference,
    watershed_inputs,
)
from hover_net_tpu_torch.ops.targets import gen_instance_hv_map

torch.set_num_threads(1)


def nuclei_map(shape, seed, n):
    """[1, H, W, 3] (np prob, hv x, hv y) of n disc nuclei with noise."""
    rng = np.random.default_rng(seed)
    inst = np.zeros(shape, np.int32)
    yy, xx = np.mgrid[-12:13, -12:13]
    for k in range(1, n + 1):
        cy = rng.integers(14, shape[0] - 14)
        cx = rng.integers(14, shape[1] - 14)
        r = rng.integers(4, 11)
        sub = inst[cy - 12:cy + 13, cx - 12:cx + 13]
        sub[((yy**2 + xx**2) <= r * r) & (sub == 0)] = k
    hv = gen_instance_hv_map(inst, shape)
    pred = np.dstack([(inst > 0).astype(np.float32), hv[..., 0], hv[..., 1]])
    return (pred + rng.normal(0, 0.04, pred.shape)).astype(np.float32)[None]


MAPS = {"164": ((164, 164), 0, 30), "256x200": ((256, 200), 1, 45)}
# proc_np_hv_batch(exact=True) takes ~10 s to compile for each shape, so it
# is held at one map; at the other skip="none" meets the stage composition
EXACT_MAP = "164"


@functools.lru_cache(maxsize=None)
def jax_variants(name):
    """{skip: labels} of K1 with stage `skip` left out, composed of the
    JAX package's functions in the TPU probe's order
    (scripts/probe_pp_stages.py), plus "exact": proc_np_hv_batch(
    exact=True) (for EXACT_MAP only), and the JAX (blb, sob) they start
    from. Each stage is jitted once, so a shape compiles each once."""
    import jax
    import jax.numpy as jnp

    from hover_net_tpu.ops import filters as jf
    from hover_net_tpu.ops import post_proc_device as jpp
    from hover_net_tpu.ops import post_proc_pallas as ppp
    from hover_net_tpu.ops.cc_np import ellipse_structuring_element
    from test_torch_post_proc import jax_energy

    ccl = jax.jit(jpp.connected_components)
    fill = jax.jit(jpp.fill_holes)
    flood = jax.jit(jpp.watershed_flood)
    sweep = jax.jit(ppp._ws_cost_sweep)
    selem = ellipse_structuring_element(5, 5)

    @jax.jit
    def remove_small(lab):
        return jpp.remove_small(lab, 10, lab.shape[1] * lab.shape[2] + 1)

    @functools.partial(jax.jit, static_argnames="rm")
    def energy(lab, sob, rm):
        """(blb, energy_q, marker before fill-holes) of the blob labels."""
        blb = (remove_small(lab) if rm else lab) > 0
        blb_f = blb.astype(jnp.float32)
        overall = jnp.maximum(sob - (1.0 - blb_f), 0.0)
        dist = -jf.gaussian_blur_3x3((1.0 - overall) * blb_f)
        energy_q = jnp.round((dist + 1.0) * (jpp.NUM_LEVELS - 1)).astype(
            jnp.int32)
        marker = (blb_f - (overall >= 0.4).astype(jnp.float32)) > 0.5
        return blb, energy_q, marker

    opening = jax.jit(lambda m: jf.dilate(jf.erode(m, selem), selem))

    pred = nuclei_map(*MAPS[name])
    blb_raw, sob_np = jax_energy(pred)
    sob = jnp.asarray(sob_np)
    lab = ccl(jnp.asarray(blb_raw))
    out = {"inputs": (blb_raw, sob_np)}
    if name == EXACT_MAP:
        out["exact"] = np.asarray(jpp.proc_np_hv_batch(jnp.asarray(pred),
                                                       exact=True))
    for skip in SKIPS:
        rm = skip != "rmsmall"
        blb, energy_q, marker = energy(lab, sob, rm=rm)
        if skip != "fill":
            marker = fill(marker)
        if skip != "open":
            marker = opening(marker)
        mk = ccl(marker)
        if rm:
            mk = remove_small(mk)
        if skip == "ws":
            out[skip] = np.asarray(mk)
        elif skip == "ws_phase2":
            seeded = (mk > 0) & blb
            esh = energy_q << jpp.HOP_BITS
            cost = []
            for c, e, b in zip(jnp.where(seeded, esh, jpp.INT_MAX), esh, blb):
                while True:  # the sweep of the TPU kernel, to its fixpoint
                    nc = sweep(c, e, b.astype(jnp.int32))
                    if bool(jnp.all(nc == c)):
                        break
                    c = nc
                cost.append(c)
            cost = jnp.stack(cost)
            out[skip] = np.asarray(jnp.where(
                (cost != jpp.INT_MAX) & blb,
                jnp.where(seeded, mk, 0) + (cost & 0xFF), 0))
        else:
            out[skip] = np.asarray(flood(energy_q, mk, blb))
    return out


# ------------------------------------------------------------ on the CPU

@pytest.mark.parametrize("skip", SKIPS)
@pytest.mark.parametrize("name", sorted(MAPS))
def test_variant_equals_jax_composition(name, skip):
    jax = jax_variants(name)
    blb, sob = (torch.from_numpy(x.copy()) for x in jax["inputs"])
    got = proc_tail_reference(blb, sob, skip=skip).numpy()
    np.testing.assert_array_equal(got, jax[skip])
    if skip == "none" and name == EXACT_MAP:
        np.testing.assert_array_equal(got, jax["exact"])
    assert len(np.unique(got)) > 15


def test_each_variant_skips_its_stage():
    """A nucleus whose marker is a ring around an island (fill-holes
    merges them), beside a 2x2 speck (the blob removal drops it): each
    stage left out changes what it should."""
    yy, xx = np.mgrid[:64, :64]
    r2 = (yy - 32) ** 2 + (xx - 32) ** 2
    blb = torch.from_numpy((r2 <= 14 ** 2)[None].copy())
    blb[0, 2:4, 60:62] = True
    ridge = (r2 >= 4 ** 2) & (r2 < 6 ** 2)
    sob = torch.from_numpy(np.where(ridge, 0.9, 0.1).astype(np.float32)[None])
    stages = {s: watershed_inputs(blb, sob, skip=s) for s in SKIPS}
    e0, m0, b0 = stages["none"]
    assert len(torch.unique(m0)) == 2  # background + one merged marker
    assert not torch.equal(stages["rmsmall"][2], b0)
    assert len(torch.unique(stages["fill"][1])) == 3  # ring and island
    assert not torch.equal(stages["open"][1], m0)
    full = proc_tail(blb, sob)
    assert torch.equal(proc_tail(blb, sob, skip="none"), full)
    # the speck and the opened ring carry no other marker, so those two
    # skips leave the labels as they are; these three change them
    for skip in ("ws", "ws_phase2", "fill"):
        assert not torch.equal(proc_tail(blb, sob, skip=skip), full), skip
    with pytest.raises(ValueError):
        proc_tail(blb, sob, skip="blur")


def test_probe_on_the_cpu(capsys, monkeypatch):
    """The probe entry point as a user runs it, at 164^2 on the CPU (one
    timed call per variant, to keep the test short)."""
    monkeypatch.setattr(probe_pp_stages, "REPS", 1)
    res = probe_pp_stages.main(["--size", "164", "--device", "cpu"])
    assert set(res) == set(SKIPS) and all(v > 0 for v in res.values())
    out = capsys.readouterr().out.splitlines()
    assert out[0] == "# map 164^2, whole map on the CPU, plain version"
    assert [ln.split(":")[0] for ln in out[1:7]] == [
        f"variant[{s}]" for s in SKIPS]
    assert [ln.split(":")[0].strip("- ").strip() for ln in out[7:]] == [
        "watershed total", "ws phase1 (cost)", "ws phase2 (ties)",
        "remove_small (2x)", "fill_holes", "5x5 opening", "full kernel"]


def test_probe_canvas_is_the_jax_probes():
    """1000^2 sources give the 1148^2 canonical canvas, with the valid
    mask over the source; 164^2 gives one patch."""
    blb, sob = probe_pp_stages.canvas_inputs(164, "cpu")
    assert blb.shape == sob.shape == (1, 164, 164)
    _, _, grid = probe_pp_stages.prepare_tile_patching((1000, 1000), 256,
                                                       164)
    assert probe_pp_stages.bucket_grid_dim(grid[0]) * 164 == 1148


# ------------------------------------------------------------ on the card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel has no CPU mode)")
    return torch.device("cuda")


@pytest.mark.gpu
@pytest.mark.parametrize("skip", SKIPS)
def test_kernel_equals_plain(cuda, skip):
    """Each variant on the 1148^2 probe canvas, in all sweep orders."""
    blb, sob = probe_pp_stages.canvas_inputs(1000, cuda)
    want = proc_tail_reference(blb, sob, skip=skip)
    for order in (0, 1, 2):
        before = (proc_tail.launches, proc_tail.skip_launches)
        got = proc_tail(blb, sob, sweep_order=order, skip=skip)
        torch.cuda.synchronize()
        k1 = int(skip == "none")
        assert (proc_tail.launches, proc_tail.skip_launches) == (
            before[0] + k1, before[1] + 1 - k1)
        assert torch.equal(got, want), (
            f"{skip}: {(got != want).sum().item()} labels differ")


@pytest.mark.gpu
def test_probe_on_the_card(cuda, capsys):
    before = proc_tail.skip_launches
    res = probe_pp_stages.main(["--size", "164"])
    assert proc_tail.skip_launches == before + (
        probe_pp_stages.REPS + 1) * (len(SKIPS) - 1)
    assert all(v > 0 for v in res.values())
    assert "whole map on" in capsys.readouterr().out
