"""BENCHMARK.json against the benchmark's own files: every cell, config and
per-layer metric has its file, every file loads, and each per-layer metric
moves an end-to-end metric that each of its cells reports."""

import importlib.util
import json
import os
import re

import pytest

from benchmark import common, run

BENCH = common.load_json("BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert os.path.getsize(os.path.join(common.ROOT, "BENCHMARK.json")) < 64 << 10


@pytest.mark.parametrize("cfg", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(cfg):
    assert set(cfg) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(cfg["name"])
    with open(os.path.join(common.ROOT, cfg["file"])) as f:
        data = json.load(f)
    assert data["name"] == cfg["name"]
    assert data["reduced"] == cfg["reduced"] == []
    assert data["width"] == 64
    assert any(w["config"] == cfg["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("cell", BENCH["workloads"], ids=lambda c: c["name"])
def test_cell_file(cell):
    assert set(cell) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(cell["name"]) and NAME.match(cell["traffic"])
    assert cell["chips"] == 1 and len(cell["why"]) <= 200
    data = common.load_json("benchmark", "workloads", f"{cell['name']}.json")
    assert data["name"] == cell["name"] and data["config"] == cell["config"]
    assert os.path.exists(os.path.join(common.HERE, "traffic",
                                       f"{data['kind']}.py"))
    e2e, per_layer = run.cell_metrics(BENCH, cell["name"])
    names = {m["name"] for m in e2e}
    assert "setup_s" in names and len(names) >= 2
    assert per_layer
    # every number compared has a limit of its own
    assert data["limits"] and all(v >= 0 for v in data["limits"].values())


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_entry(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(metric.get("workloads", cells)) <= cells
    if "bound" in metric:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
        return
    path = os.path.join(common.HERE, "metrics", f"{metric['name']}.py")
    spec = importlib.util.spec_from_file_location("m", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    assert callable(mod.read)
    # each cell that reports it reports the end-to-end metric it moves
    moved = next(m for m in BENCH["end_to_end"] if m["name"] == metric["moves"])
    for cell in metric["workloads"]:
        assert cell in moved.get("workloads", cells)


def test_layer_names_agree():
    layers = {}
    for m in BENCH["per_layer"]:
        assert "\n" not in m["layer"] and len(m["layer"]) <= 200
        layers.setdefault(m["layer"].lower(), set()).add(m["layer"])
    assert all(len(v) == 1 for v in layers.values())
