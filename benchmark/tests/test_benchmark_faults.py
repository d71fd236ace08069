"""A run of each cell at test size on the CPU, whole but for the look for a
card: its result line has every key, and with the answer altered where it is
produced (the forward's hv maps flipped), `correct` comes out false under
limits that pass the sound run."""

import tempfile

import pytest
import torch

from benchmark import run

import hover_net_tpu_torch.infer.steps as steps
import hover_net_tpu_torch.infer.wsi as wsi


def _flip_hv(monkeypatch):
    real = steps.infer_output

    def altered(model, imgs):
        out = real(model, imgs).clone()
        out[..., -2:] *= -1
        return out

    monkeypatch.setattr(steps, "infer_output", altered)
    monkeypatch.setattr(wsi, "infer_output", altered)


@pytest.mark.parametrize("cell", ["tile_fast_pannuke", "tile_original_consep",
                                  "wsi_fast_pannuke_job",
                                  "wsi_fast_pannuke"])
def test_altered_answer_is_not_correct(cell, small_cell, monkeypatch):
    tempfile.tempdir = None
    sound = run.execute(small_cell(cell, seed=11))
    assert set(sound) == {"correct", "attempted", "failed", "metrics",
                          "device", "checks"}
    assert list(sound)[-1] == "checks" and sound["failed"] == 0
    limits = {k: 1.5 * v["value"] + 1e-3 for k, v in sound["checks"].items()}
    ctx = small_cell(cell, seed=11)
    ctx.cell["limits"] = limits
    assert run.execute(ctx)["correct"]
    _flip_hv(monkeypatch)
    ctx = small_cell(cell, seed=11)
    ctx.cell["limits"] = limits
    broken = run.execute(ctx)
    assert not broken["correct"]
    assert broken["checks"]["map_err"]["value"] > 10 * sound["checks"][
        "map_err"]["value"]


@pytest.mark.parametrize("fault", ["half_batch", "unchanged_state"])
def test_training_fault_is_not_correct(fault, small_cell, monkeypatch):
    """The training cell with its step broken underneath: half of each
    batch left out (the mean over the rest), or a step that returns its
    state unchanged."""
    from hover_net_tpu_torch.parallel import train_parallel

    tempfile.tempdir = None
    sound = run.execute(small_cell("train_original_consep", seed=4))
    assert sound["correct"] and sound["attempted"] > 0
    limits = {k: 1.5 * v["value"] + 1e-3 for k, v in sound["checks"].items()}
    make = train_parallel.make_train_step

    def broken(*args, **kwargs):
        step = make(*args, **kwargs)
        if fault == "half_batch":
            return lambda state, batch: step(
                state, {k: v[:v.shape[0] // 2] for k, v in batch.items()})

        def unchanged(state, batch):
            keep = {k: v.detach().clone()
                    for k, v in state.model.state_dict().items()}
            state, out = step(state, batch)
            state.model.load_state_dict(keep)
            return state, out

        return unchanged

    monkeypatch.setattr(train_parallel, "make_train_step", broken)
    ctx = small_cell("train_original_consep", seed=4)
    ctx.cell["limits"] = limits
    assert not run.execute(ctx)["correct"]


def test_trace_run_line(small_cell):
    tempfile.tempdir = None
    res = run.execute(small_cell("tile_fast_pannuke", seed=3, seconds=3,
                                trace=True))
    assert {"busy_s", "window_s"} <= set(res["device"])
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert "finalize_ms.tile" in res["metrics"]


@pytest.mark.parametrize("cell", ["tile_fast_pannuke", "tile_original_consep",
                                  "wsi_fast_pannuke_job"])
def test_control_reads_worse_than_reference(cell, small_cell):
    """The fp8 control, judged as a run is by the cell's committed limits,
    is not correct; the bf16 witness reads a smaller map gap than it."""
    from benchmark.control import control_checks

    tempfile.tempdir = None
    ctx = small_cell(cell, seed=5)
    checks = control_checks(ctx, ctx.weights())
    assert set(checks) <= set(ctx.cell["limits"])
    assert all(lim == ctx.cell["limits"][k] for k, (_, lim) in checks.items())
    assert not run.judge(checks)
    ctx = small_cell(cell, seed=5)
    witness = control_checks(ctx, ctx.weights(), "bf16")
    assert 0 < witness["map_err"][0] < checks["map_err"][0]


def test_recipe_training_left_out_of_setup(small_cell, monkeypatch):
    """The seconds the recipe takes to train missing weights do not count
    in `setup_s`."""
    import time

    from benchmark.reference import recipe

    ctx = small_cell("tile_fast_pannuke")
    cached = recipe.ensure_weights

    def training(cfg, log=None):
        time.sleep(1.5)
        return cached(cfg)

    monkeypatch.setattr(recipe, "ensure_weights", training)
    before = ctx.elapsed()
    assert ctx.weights() == cached(ctx.cfg)
    assert ctx.elapsed() - before < 0.5 and ctx.excluded_s >= 1.5


@pytest.mark.gpu
def test_cell_on_card():
    """One short run of the fastest cell on a card (skips without one)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import argparse

    from benchmark import common

    common.setup_env()
    ctx = run.make_context(argparse.Namespace(
        workload="tile_fast_pannuke", seed=2**31 + 5, seconds=4, trace=0))
    res = run.execute(ctx)
    assert res["attempted"] > 0 and res["failed"] == 0
