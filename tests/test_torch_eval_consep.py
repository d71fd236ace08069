"""The port's CoNSeP evaluation recipe and finalize-pool bench against the
JAX package's scripts, on the CPU.

- cli/eval_consep_dryrun writes the stand-ins of
  scripts/eval_consep_dryrun.build_standins: the same PNG bytes, and the
  same `.mat` bytes after the header's creation time;
- cli/eval_consep.prepare_truth writes the `.mat` arrays of the heredoc of
  scripts/eval_consep.sh, run with `python -` on the same labels;
- the recipe: on those stand-ins, with one forced-foreground width-8 `.tar`
  (tests/test_torch_tile.py) for both, the port's cli/eval_consep prints
  the instance and type stat lines that the JAX package's run_infer, the
  script's heredoc and compute_stats print (both tile managers in float32,
  as tests/test_torch_tile.py runs the CLIs);
- cli/eval_consep_dryrun runs end to end with `--device cpu` in both
  modes; a malformed `.msgpack` checkpoint and a missing Test/Images
  raise;
- cli/bench_finalize_pool paints the JAX script's windows, counts the same
  instances and prints the same JSON keys.
"""

import json
import os
import re
import subprocess
import sys

import numpy as np
import pytest
import scipy.io as sio

from hover_net_tpu_torch.cli import bench_finalize_pool as t_pool
from hover_net_tpu_torch.cli import eval_consep, eval_consep_dryrun

from test_torch_tile import f32_managers, forced_foreground_tar  # noqa: F401

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPTS = os.path.join(REPO, "scripts")
MAT_HEADER = 116  # the text of a MAT 5 header, which holds the time
STAT_LINE = re.compile(r"^\[.*\]$")


def jax_dryrun():
    sys.path.insert(0, SCRIPTS)
    try:
        import eval_consep_dryrun as j_dryrun
    finally:
        sys.path.remove(SCRIPTS)
    return j_dryrun


def heredoc():
    """The ground-truth heredoc of scripts/eval_consep.sh."""
    with open(os.path.join(SCRIPTS, "eval_consep.sh")) as f:
        text = f.read()
    start = text.index("<<'EOF'\n") + len("<<'EOF'\n")
    return text[start:text.index("\nEOF\n", start)] + "\n"


def tree(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


@pytest.fixture(scope="module")
def standins(tmp_path_factory):
    root = tmp_path_factory.mktemp("consep") / "CoNSeP"
    eval_consep_dryrun.build_standins(str(root))
    return str(root)


def test_standins_are_the_jax_dryruns(standins, tmp_path):
    root = tmp_path / "jax"
    jax_dryrun().build_standins(str(root))
    files = tree(standins)
    assert files == tree(root) == [
        "Test/Images/test_0.png", "Test/Images/test_1.png",
        "Test/Labels/test_0.mat", "Test/Labels/test_1.mat"]
    for rel in files:
        with open(os.path.join(standins, rel), "rb") as f:
            got = f.read()
        want = (root / rel).read_bytes()
        if rel.endswith(".mat"):
            got, want = got[MAT_HEADER:], want[MAT_HEADER:]
        assert got == want, rel
    m = sio.loadmat(os.path.join(standins, "Test/Labels/test_0.mat"))
    assert set(np.unique(m["type_map"])) <= set(range(8))
    assert m["inst_map"].max() > 10


def test_prepare_truth_is_the_scripts_heredoc(standins, tmp_path, capsys):
    lbl = os.path.join(standins, "Test", "Labels")
    eval_consep.prepare_truth(lbl, str(tmp_path / "port"))
    assert capsys.readouterr().out == \
        f"prepared ground truth: {tmp_path / 'port'}\n"
    res = subprocess.run([sys.executable, "-", lbl, str(tmp_path / "jax")],
                         input=heredoc(), capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    names = sorted(os.listdir(tmp_path / "jax"))
    assert sorted(os.listdir(tmp_path / "port")) == names == [
        "test_0.mat", "test_1.mat"]
    for name in names:
        got = sio.loadmat(str(tmp_path / "port" / name))
        want = sio.loadmat(str(tmp_path / "jax" / name))
        keys = {k for k in want if not k.startswith("__")}
        assert keys == {"inst_map", "type_map", "inst_centroid", "inst_type"}
        assert {k for k in got if not k.startswith("__")} == keys
        for k in keys:
            assert got[k].dtype == want[k].dtype, (name, k)
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
        assert set(np.unique(got["type_map"])) <= {0, 1, 2, 3, 4}


def stat_lines(text):
    return [line for line in text.splitlines() if STAT_LINE.match(line)]


def test_recipe_prints_the_jax_stat_lines(standins, tmp_path, capsys,
                                          f32_managers):  # noqa: F811
    from hover_net_tpu.cli import compute_stats as j_compute_stats
    from hover_net_tpu.cli.run_infer import main as jax_run_infer

    tar = forced_foreground_tar(str(tmp_path / "m.tar"), 5, seed=2)
    img_dir = os.path.join(standins, "Test", "Images")
    lbl_dir = os.path.join(standins, "Test", "Labels")
    out_j, out_p = tmp_path / "jax", tmp_path / "port"
    cwd = os.getcwd()
    os.chdir(tmp_path)  # the JAX CLI logs to ./debug.log
    try:
        jax_run_infer([
            "--model_path", tar, "--model_mode", "fast", "--nr_types", "5",
            "--width", "8", "--type_info_path",
            os.path.join(REPO, "type_info.json"), "tile", "--input_dir",
            img_dir, "--output_dir", str(out_j)])
    finally:
        os.chdir(cwd)
    res = subprocess.run([sys.executable, "-", lbl_dir, str(out_j / "true")],
                         input=heredoc(), capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    capsys.readouterr()
    for mode in ("instance", "type"):
        j_compute_stats.main(["--mode", mode, "--pred_dir",
                              str(out_j / "mat"), "--true_dir",
                              str(out_j / "true")])
    want = stat_lines(capsys.readouterr().out)

    got = eval_consep.main([standins, tar, str(out_p), "fast", "8",
                            "--device", "cpu"])
    printed = capsys.readouterr().out
    assert stat_lines(printed) == want
    assert len(want) == 2
    assert "== instance metrics" in printed and "== type metrics" in printed
    n_nuc = 0
    for i in range(2):
        with open(out_p / "json" / f"test_{i}.json") as f:
            n_nuc += len(json.load(f)["nuc"])
    assert n_nuc > 5
    assert np.all(np.isfinite(got["instance"]))
    assert np.all(np.isfinite(got["type"]))


@pytest.mark.parametrize("mode", ["fast", "original"])
def test_dryrun_runs_end_to_end_on_the_cpu(mode, tmp_path, capsys):
    res = eval_consep_dryrun.main([str(tmp_path), "--mode", mode,
                                   "--device", "cpu"])
    printed = capsys.readouterr().out
    assert res["manager"].cfg.mode == mode
    assert res["manager"].cfg.width == 8
    out = tmp_path / "out"
    for sub in ("json", "mat", "true"):
        assert sorted(os.listdir(out / sub)) == [
            f"test_{i}.{'json' if sub == 'json' else 'mat'}"
            for i in range(2)], sub
    assert len(stat_lines(printed)) == 2
    assert printed.rstrip().endswith(f"dry run complete: {out}")


def test_eval_consep_refuses_a_msgpack_and_a_missing_layout(tmp_path,
                                                            standins):
    # the port reads a JAX .msgpack (tests/test_torch_msgpack.py); one
    # cut short raises
    bad = tmp_path / "m.msgpack"
    bad.write_bytes(b"\x82\xa5extra\x80\xa9variables\x81")
    with pytest.raises(ValueError, match="msgpack: truncated"):
        eval_consep.main([standins, str(bad), str(tmp_path / "out"),
                          "--device", "cpu"])
    with pytest.raises(SystemExit, match="missing"):
        eval_consep.main([str(tmp_path), str(tmp_path / "m.tar"),
                          str(tmp_path / "out"), "--device", "cpu"])


def test_bench_finalize_pool_matches_the_jax_script(capsys):
    sys.path.insert(0, SCRIPTS)
    try:
        import bench_finalize_pool as j_pool
    finally:
        sys.path.remove(SCRIPTS)
    args = dict(n_win=3, size=160, per_win=20)
    got, want = t_pool.paint_windows(**args), j_pool.paint_windows(**args)
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)
    assert t_pool.extract_all(got)[1] == j_pool.extract_all(want)[1] > 30

    flags = ["--windows", "3", "--size", "160", "--per_win", "20"]
    res = t_pool.main(flags)
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == res
    jax_res = subprocess.run(
        [sys.executable, os.path.join(SCRIPTS, "bench_finalize_pool.py")]
        + flags, capture_output=True, text=True, timeout=300,
        env=dict(os.environ, JAX_PLATFORMS="cpu"))
    assert jax_res.returncode == 0, jax_res.stderr[-2000:]
    want = json.loads(jax_res.stdout.strip().splitlines()[-1])
    assert list(res) == list(want)
    assert res["instances"] == want["instances"]
    assert res["pool1_overhead_x"] > 0 and res["ms_per_window_seq"] > 0
