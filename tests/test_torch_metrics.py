"""The port's metrics (hover_net_tpu_torch/metrics/{stats,eval}.py)
against the JAX package's, on the CPU.

Every metric of metrics/stats.py gets the same seeded instance maps (a
prediction that moves, drops and adds nuclei against its truth, an
identical one, and an empty one) and must return exactly the JAX
function's value. The evaluation drivers run over one temporary
directory of `.mat` files and must return the same arrays and print the
same line.
"""

import numpy as np
import pytest
import scipy.io as sio

from hover_net_tpu.metrics import eval as j_eval
from hover_net_tpu.metrics import stats as j_stats
from hover_net_tpu_torch import metrics as t_metrics
from hover_net_tpu_torch.metrics import eval as t_eval
from hover_net_tpu_torch.metrics import stats as t_stats

from test_torch_host_copies import assert_same, blobs

SHAPE = (96, 88)


def pair(case, seed):
    """(true, pred) contiguous instance maps for one case."""
    true = j_stats.remap_label(blobs(SHAPE, 16, seed=seed))
    if case == "identical":
        return true, true.copy()
    if case == "empty":
        return true, np.zeros_like(true)
    pred = np.roll(true, (seed % 3, 1 + seed % 2), axis=(0, 1))
    pred[pred % 5 == 0] = 0  # missed nuclei
    extra = blobs(SHAPE, 6, seed=seed + 50)
    pred = np.where((pred == 0) & (extra > 0), extra + pred.max(), pred)
    return true, j_stats.remap_label(pred)


METRICS = {
    "_confusion": lambda m, t, p: m._confusion(t, p),
    "get_dice_1": lambda m, t, p: m.get_dice_1(t, p),
    "get_fast_aji": lambda m, t, p: m.get_fast_aji(t, p),
    "get_fast_aji_plus": lambda m, t, p: m.get_fast_aji_plus(t, p),
    "get_fast_pq": lambda m, t, p: m.get_fast_pq(t, p),
    "get_fast_pq_munkres": lambda m, t, p: m.get_fast_pq(t, p, match_iou=0.3),
    "get_fast_dice_2": lambda m, t, p: m.get_fast_dice_2(t, p),
    "get_dice_2": lambda m, t, p: m.get_dice_2(t, p),
}
CASES = [("moved", 0), ("moved", 1), ("moved", 2), ("identical", 3),
         ("empty", 4)]


@pytest.mark.parametrize("case,seed", CASES)
@pytest.mark.parametrize("name", sorted(METRICS))
def test_metric_matches_jax(name, case, seed):
    true, pred = pair(case, seed)
    got = METRICS[name](t_stats, true, pred)
    assert_same(got, METRICS[name](j_stats, true, pred), name)


@pytest.mark.parametrize("seed", [0, 1])
def test_pair_coordinates_matches_jax(seed):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 200, (40, 2))
    b = np.concatenate([a[:30] + rng.normal(0, 6, (30, 2)),
                        rng.uniform(0, 200, (15, 2))])
    got = t_stats.pair_coordinates(a, b, 12)
    want = j_stats.pair_coordinates(a, b, 12)
    assert_same(got, want)
    assert 10 < want[0].shape[0] < 40


def test_package_exports_the_jax_names():
    import hover_net_tpu.metrics as j_metrics

    names = {n for n in dir(j_metrics) if not n.startswith("_")
             and callable(getattr(j_metrics, n))}
    assert names <= set(dir(t_metrics))
    assert t_metrics.get_dice_2 is t_metrics.get_fast_dice_2


def write_eval_dirs(root, n_images=3, seed=0):
    """`true/` and `pred/` `.mat` files with inst_map, inst_centroid and
    inst_type ([N, 1]); the last prediction has no nuclei."""
    true_dir, pred_dir = root / "true", root / "pred"
    true_dir.mkdir()
    pred_dir.mkdir()
    rng = np.random.default_rng(seed)
    for i in range(n_images):
        true, pred = pair("empty" if i == n_images - 1 else "moved", seed + i)
        for inst, d in ((true, true_dir), (pred, pred_dir)):
            ids = np.arange(1, int(inst.max()) + 1)
            ys, xs = np.nonzero(inst)
            lab = inst[ys, xs]
            cnt = np.bincount(lab, minlength=ids.size + 1)[1:]
            cent = np.stack([np.bincount(lab, xs, ids.size + 1)[1:],
                             np.bincount(lab, ys, ids.size + 1)[1:]],
                            axis=1) / np.maximum(cnt, 1)[:, None]
            sio.savemat(str(d / f"img{i}.mat"), {
                "inst_map": inst,
                "inst_centroid": cent if ids.size else np.zeros((0, 2)),
                "inst_type": rng.integers(1, 5, (ids.size, 1))})
    return str(pred_dir), str(true_dir)


@pytest.mark.parametrize("print_img_stats", [False, True])
def test_run_nuclei_inst_stat_matches_jax(tmp_path, capsys,
                                          print_img_stats):
    pred_dir, true_dir = write_eval_dirs(tmp_path)
    out = {}
    for name, mod in (("port", t_eval), ("jax", j_eval)):
        res = mod.run_nuclei_inst_stat(pred_dir, true_dir,
                                       print_img_stats=print_img_stats)
        out[name] = (res, capsys.readouterr().out)
    assert_same(out["port"][0], out["jax"][0])
    assert out["port"][1] == out["jax"][1]
    assert out["jax"][0].shape == (6, 3)
    assert len(out["jax"][1].splitlines()) == 1 + 3 * print_img_stats


@pytest.mark.parametrize("exhaustive", [True, False])
def test_run_nuclei_type_stat_matches_jax(tmp_path, capsys, exhaustive):
    pred_dir, true_dir = write_eval_dirs(tmp_path, seed=7)
    out = {}
    for name, mod in (("port", t_eval), ("jax", j_eval)):
        res = mod.run_nuclei_type_stat(pred_dir, true_dir,
                                       exhaustive=exhaustive)
        out[name] = (res, capsys.readouterr().out)
    assert_same(out["port"][0], out["jax"][0])
    assert out["port"][1] == out["jax"][1]
    assert len(out["jax"][0]) == 2 + 4  # F1_d, acc, 4 types
