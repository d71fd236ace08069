"""Small CPU versions of the cells: width 8, tiny tiles and slides, weights
from a few recipe steps on the CPU."""

import time

import pytest

from benchmark import common
from benchmark.reference import recipe

SMALL = {
    "tile": {"tiles": 4, "tile_size": 300, "nuclei_per_tile": [40, 60],
             "tiles_per_call": 2, "max_calls": 20, "warm_tiles": 1,
             "check_tiles": 2, "check_within": 2, "trace_from_call": 1,
             "trace_calls": 1},
    "wsi": {"slides": 2, "slide_size": 1200, "chunk_shape": 1000,
            "tile_shape": 512, "ambiguous_size": 32, "warm_size": 600, "check_regions": 2,
            "check_region": 256, "margin": 16, "trace_slide": 1},
    "train": {"patches": 8, "patch_size": 300, "nuclei_per_patch": [20, 30],
              "nr_procs_train": 0, "warm_steps": 1, "trace_from_step": 0,
              "trace_steps": 1},
}


@pytest.fixture(scope="session")
def small_cell(tmp_path_factory, monkeypatch_session):
    """small_cell(name, seed, seconds, trace) -> a CPU Context of the cell
    at test size, its weights trained here for a few steps."""
    root = tmp_path_factory.mktemp("weights")
    weights = {}

    def ensure(cfg, log=None):
        return weights[cfg["name"]]

    monkeypatch_session.setattr(recipe, "ensure_weights", ensure)
    monkeypatch_session.setenv("TMPDIR", str(tmp_path_factory.mktemp("tmp")))

    def make(name, seed=7, seconds=0.5, trace=False):
        bench = common.load_json("BENCHMARK.json")
        cell = common.load_json("benchmark", "workloads", f"{name}.json")
        cfg = common.load_json("benchmark", "configs", f"{cell['config']}.json")
        cfg.update(width=8, batch_size=4)
        cfg["recipe"]["batch"] = 2
        cell.update(SMALL[cell["kind"]])
        if cfg["name"] not in weights:
            path = str(root / f"{cfg['name']}.tar")
            recipe.train(cfg, path, device="cpu", steps=2)
            weights[cfg["name"]] = path
        return common.Context(seed=seed, seconds=seconds, trace=trace,
                              cell=cell, cfg=cfg, bench=bench,
                              t0=time.perf_counter(), device="cpu")

    return make


@pytest.fixture(scope="session")
def monkeypatch_session():
    mp = pytest.MonkeyPatch()
    yield mp
    mp.undo()
