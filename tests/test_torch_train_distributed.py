"""Data-parallel training of the port across ranks, on the CPU (gloo).

The geometry of tests/test_torch_train_step.py (width 8, 96^2 -> 4^2, 5
types, the model body in float64, heads and loss float32, the same
one-boundary schedule): 2 ranks, one process each, take a global batch of
4 (2 a rank) for 3 steps, in both freeze modes, through
`parallel.dp_check.rank_steps`. They are held against the JAX package's
meshed step (`make_train_step(..., mesh=make_mesh(2))` on conftest's
virtual CPU devices, in this process) and against the port's one-process
step on the same global batches, with the tolerances of
test_torch_train_step.py: loss terms 1e-5 relative, `grad_norm` 1e-4
relative, each gradient of step 1 within 1e-4 of its tensor's largest
magnitude, parameters after 3 steps within 0.1 * lr, BN running stats
within 1e-5 of their scale, frozen parameters bit-identical to their
start; and every rank ends with rank 0's state, bit for bit. Two negative
controls run the same steps with BatchNorm's moments per rank and with
the ranks' gradients summed instead of averaged: each misses the JAX
step by at least 10x a tolerance, so the checks tell those designs from
the right one.

Then one 4-rank step, the trainer on 2 ranks through the run_train CLI
(its `.tar` loaded by the tile CLI), the device rule of `TrainManager`,
`entry.dryrun_multichip` on two CPU ranks, and `run_ranks` failing fast
when a rank raises, is killed or outlasts the limit. The ranks are
spawned with one thread each; every spawn has a time limit.
"""

import json
import multiprocessing
import os
import threading
import time

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
import optax

from hover_net_tpu.models import HoVerNet as JaxHoVerNet
from hover_net_tpu.models import HoVerNetConfig as JaxConfig
from hover_net_tpu.parallel import train_parallel as j_tp
from hover_net_tpu.parallel.mesh import make_mesh, replicated, shard_batch
from hover_net_tpu_torch.models.checkpoints import (
    load_torch_tar,
    state_dict_from_jax,
)
from hover_net_tpu_torch.models.hovernet import HoVerNet, HoVerNetConfig
from hover_net_tpu_torch.parallel import distributed, dp_check
from hover_net_tpu_torch.parallel import train_parallel as t_tp
from test_torch_train_step import (
    CFG,
    LR,
    NR_TYPES,
    OUT,
    SCHEDULE,
    SIZE,
    WIDTH,
    is_frozen,
    jax_variables,
    keep_grads,
    param_keys,
)
from test_train_e2e import make_patches

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GLOBAL, N_STEPS, RANKS = 4, 3, 2
CFG64 = HoVerNetConfig(mode="fast", nr_types=NR_TYPES, width=WIDTH,
                       dtype=torch.float64)
CASES = [(True, None), (False, None), (False, "local_bn"),
         (False, "sum_grads")]
SPAWN_S = 300.0
# chip_smoke.py's exactness check: the heads and the loss in float64 too
CFG64_HEADS = HoVerNetConfig(mode="fast", nr_types=NR_TYPES, width=WIDTH,
                             dtype=torch.float64, head_dtype=torch.float64)
HEADS_CASES = [(True, None), (False, None)]


def global_batches(n=GLOBAL, steps=N_STEPS, seed=0):
    rng = np.random.default_rng(seed)
    return [{
        "img": rng.integers(0, 256, (n, SIZE, SIZE, 3), np.uint8),
        "np_map": (rng.uniform(0, 1, (n, OUT, OUT)) > 0.4).astype(np.uint8),
        "hv_map": rng.uniform(-1, 1, (n, OUT, OUT, 2)).astype(np.float32),
        "tp_map": rng.integers(0, NR_TYPES, (n, OUT, OUT)).astype(np.int32),
    } for _ in range(steps)]


def run_jax_mesh(variables, data, freeze):
    """The JAX package's step on a 2-device mesh, body in float64:
    {"terms", "grads" (step 1), "state"} keyed as the port's state dict."""
    model = JaxHoVerNet(JaxConfig(mode="fast", nr_types=NR_TYPES,
                                  width=WIDTH, dtype=jnp.float64))
    tx, _ = j_tp.make_optimizer(**SCHEDULE)
    tx = optax.chain(keep_grads(), tx)
    mesh = make_mesh(RANKS)
    with jax.enable_x64(True), mesh:
        cast = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda v: jnp.asarray(v, jnp.float64), t)
        params = cast(variables["params"])
        state = j_tp.TrainState(
            params=params, batch_stats=cast(variables["batch_stats"]),
            opt_state=tx.init(params), step=jnp.zeros((), jnp.int32))
        state = jax.device_put(state, replicated(mesh))
        step = j_tp.make_train_step(model, tx, freeze_encoder=freeze,
                                    mesh=mesh)
        terms, grads = [], None
        for batch in data:
            state, (out, _) = step(state, shard_batch(mesh, batch))
            terms.append({k: float(v) for k, v in out.items()})
            if grads is None:
                grads = jax.tree_util.tree_map(np.asarray,
                                               state.opt_state[0])
        final = jax.tree_util.tree_map(np.asarray, {
            "params": state.params, "batch_stats": state.batch_stats})
    grads = state_dict_from_jax(
        {"params": grads, "batch_stats": variables["batch_stats"]}, CFG)
    return {"terms": terms, "grads": grads,
            "state": state_dict_from_jax(final, CFG)}


def misses(got, want, freeze, start):
    frozen = [k for k in param_keys() if freeze and is_frozen(k)]
    assert (len(frozen) > 100) == freeze
    return dp_check.misses(got, want, start, param_keys(), frozen, LR)


@pytest.fixture(scope="module")
def runs():
    """The ranks' cases (spawned first, in a thread), the JAX meshed runs
    and the one-process runs of both freeze modes."""
    variables = jax_variables()
    start = state_dict_from_jax(variables, CFG)
    data = global_batches()
    box = {}

    def spawn():
        try:
            box["ranks"] = dp_check.rank_steps(
                ["cpu"] * RANKS, CFG64, start, data, CASES, SCHEDULE,
                timeout_s=SPAWN_S)
        except Exception as e:  # re-raised below, in the test
            box["error"] = e

    thread = threading.Thread(target=spawn)
    thread.start()
    jax_runs = {f: run_jax_mesh(variables, data, f) for f in (True, False)}
    one = {f: dp_check.one_process_steps("cpu", CFG64, start, data, f,
                                         SCHEDULE) for f in (True, False)}
    thread.join(SPAWN_S + 30)
    assert not thread.is_alive()
    if "error" in box:
        raise box["error"]
    ranks = dict(zip(CASES, box["ranks"]))
    return start, jax_runs, one, ranks


@pytest.mark.parametrize("freeze", [True, False], ids=["frozen", "full"])
def test_two_ranks_match_jax_mesh_and_one_process(runs, freeze):
    start, jax_runs, one, ranks = runs
    got = ranks[(freeze, None)]
    assert got["equal"], "the ranks' states differ"
    assert len(got["terms"]) == N_STEPS
    for want in (jax_runs[freeze], one[freeze]):
        worst = misses(got, want, freeze, start)
        assert max(worst.values()) <= 1.0, worst
    # the BN running stats moved, from the global batch's moments
    moved = [k for k in start if k.endswith("running_var")
             and not torch.equal(got["state"][k].float(), start[k])]
    assert len(moved) > 50


@pytest.mark.parametrize("mutation", ["local_bn", "sum_grads"])
def test_negative_controls_miss_jax(runs, mutation):
    """Per-rank BN moments (the terms, gradients, parameters and stats
    move) and summed gradients (grad_norm and each gradient 2x; Adam's
    update barely changes) each miss the JAX step by >= 10x a
    tolerance."""
    start, jax_runs, _, ranks = runs
    got = ranks[(False, mutation)]
    worst = misses(got, jax_runs[False], False, start)
    assert max(worst.values()) >= 10.0, worst
    # per-rank moments also leave each rank with its own BN stats
    assert got["equal"] == (mutation == "sum_grads")


@pytest.fixture(scope="module")
def runs_float64_heads():
    """Both freeze modes on 2 ranks and in one process with the heads and
    the loss in float64 too, the configuration of chip_smoke.py's
    exactness check."""
    start = HoVerNet(CFG, generator=torch.Generator().manual_seed(5)
                     ).state_dict()
    data = global_batches(seed=5)
    ranks = dp_check.rank_steps(["cpu"] * RANKS, CFG64_HEADS, start, data,
                                HEADS_CASES, SCHEDULE, timeout_s=SPAWN_S)
    one = [dp_check.one_process_steps("cpu", CFG64_HEADS, start, data, f,
                                      SCHEDULE) for f, _ in HEADS_CASES]
    return start, dict(zip((True, False), zip(ranks, one)))


@pytest.mark.parametrize("freeze", [True, False], ids=["frozen", "full"])
def test_two_ranks_match_one_process_with_float64_heads(runs_float64_heads,
                                                        freeze):
    start, runs = runs_float64_heads
    got, want = runs[freeze]
    assert got["equal"], "the ranks' states differ"
    assert got["terms"][0]["overall_loss"] == pytest.approx(
        want["terms"][0]["overall_loss"], rel=1e-12)
    worst = misses(got, want, freeze, start)
    assert max(worst.values()) <= 1.0, worst


def test_dryrun_and_rank_steps_equal_the_two_spawns(runs_float64_heads,
                                                    capsys):
    """chip_smoke.py phase 14 (b) and (c) in one spawn of the ranks
    (`dp_check.dryrun_and_rank_steps`) give what the two spawns they
    replace give, bit for bit: `dryrun_train_step`'s loss and line, and
    `rank_steps`' runs of both freeze modes."""
    start, runs = runs_float64_heads
    loss, got = dp_check.dryrun_and_rank_steps(
        ["cpu"] * RANKS, CFG64_HEADS, start, global_batches(seed=5),
        HEADS_CASES, SCHEDULE, timeout_s=SPAWN_S)
    assert loss == t_tp.dryrun_train_step(RANKS, ["cpu"] * RANKS)
    line = f"dryrun_multichip ok: {RANKS} devices, loss={loss:.4f}"
    assert capsys.readouterr().out.count(line) == 2
    assert len(got) == len(HEADS_CASES)
    for (freeze, _), run in zip(HEADS_CASES, got):
        want = runs[freeze][0]
        assert run["equal"] and want["equal"]
        assert run["terms"] == want["terms"]
        for part in ("grads", "state"):
            assert list(run[part]) == list(want[part])
            for k, v in want[part].items():
                assert torch.equal(run[part][k], v), (part, k)


def test_four_ranks_one_step():
    """One step over 4 ranks of one sample each equals the one-process
    step on the global batch of 4 (the tolerances above), and every rank
    ends the same."""
    start = HoVerNet(CFG, generator=torch.Generator().manual_seed(3)
                     ).state_dict()
    data = global_batches(steps=1, seed=7)
    got, = dp_check.rank_steps(["cpu"] * 4, CFG64, start, data,
                               [(False, None)], SCHEDULE, timeout_s=SPAWN_S)
    want = dp_check.one_process_steps("cpu", CFG64, start, data, False,
                                      SCHEDULE)
    assert got["equal"]
    worst = misses(got, want, False, start)
    assert max(worst.values()) <= 1.0, worst


# ------------------------------------------------------------- trainer

TRAIN_CONFIG = """
from hover_net_tpu_torch.config import PhaseConfig, TrainConfig

config = TrainConfig(
    model_mode="fast", nr_types=5, type_classification=True, width=8,
    log_dir={log_dir!r}, train_dir_list=[{train!r}],
    valid_dir_list=[{valid!r}], nr_procs_train=0, nr_procs_valid=0,
    debug=True,
    shape_override={{"aug": (140, 140), "act": (96, 96), "out": (4, 4)}},
    phases=[
        PhaseConfig(freeze_encoder=True, pretrained=None,
                    batch_size={{"train": 2, "valid": 2}}, nr_epochs=1),
        PhaseConfig(freeze_encoder=False, pretrained=-1,
                    batch_size={{"train": 2, "valid": 2}}, nr_epochs=1),
    ],
)
"""


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """`run_train --n_devices 2 --device cpu`: two phases of one epoch, 8
    patches at 2 a rank (2 global steps an epoch)."""
    from hover_net_tpu_torch.cli import run_train

    tmp = tmp_path_factory.mktemp("dp_train")
    rng = np.random.default_rng(0)
    make_patches(str(tmp / "train"), 8, rng)
    make_patches(str(tmp / "valid"), 2, rng)
    cfg = tmp / "cfg.py"
    cfg.write_text(TRAIN_CONFIG.format(
        log_dir=str(tmp / "logs"), train=str(tmp / "train"),
        valid=str(tmp / "valid")))
    infos = run_train.main(["--n_devices", "2", "--device", "cpu",
                            "--config", str(cfg)])
    return tmp, infos


def test_trainer_two_ranks_write_rank0_checkpoints_and_stats(trained):
    tmp, infos = trained
    assert len(infos) == 2
    for idx, info in enumerate(infos):
        # global steps: 8 patches in global batches of 4
        assert info.train_state.step == 2
        assert len(info.losses) == len(info.step_s) == 2
        assert np.all(np.isfinite(info.losses))
        d = tmp / "logs" / f"{idx:02d}"
        assert sorted(p.name for p in d.glob("*.tar")) == [
            "net_best=[valid-np_dice].tar", "net_epoch=1.tar"]
        stats = json.loads((d / "stats.json").read_text())
        for k in ("train-overall_loss", "train-grad_norm", "valid-np_dice"):
            assert np.isfinite(stats["1"][k]), k
        payload = torch.load(d / "net_epoch=1.tar", weights_only=True)
        assert payload["step"] == 2
        assert not any(k.startswith("module.") for k in payload["desc"])


def test_trainer_two_ranks_freeze_cut(trained):
    """Phase 1 leaves the frozen parameters at their seeded start and
    moves the rest; phase 2 moves every parameter."""
    tmp, _ = trained
    start = HoVerNet(CFG, generator=torch.Generator().manual_seed(10)
                     ).state_dict()
    p0 = load_torch_tar(str(tmp / "logs" / "00" / "net_epoch=1.tar"))
    p1 = load_torch_tar(str(tmp / "logs" / "01" / "net_epoch=1.tar"))
    for key in param_keys():
        assert torch.equal(p0[key], start[key]) == is_frozen(key), key
        assert not torch.equal(p1[key], p0[key]), key


def test_trainer_two_ranks_tar_loads_in_tile_cli(trained, tmp_path):
    import cv2

    from hover_net_tpu_torch.cli import run_infer

    tmp, _ = trained
    (tmp_path / "in").mkdir()
    img = np.random.default_rng(1).integers(0, 256, (200, 180, 3), np.uint8)
    cv2.imwrite(str(tmp_path / "in" / "a.png"), img)
    run_infer.main([
        "--model_path", str(tmp / "logs" / "01" / "net_epoch=1.tar"),
        "--model_mode", "fast", "--width", "8", "--nr_types", "5",
        "--type_info_path", os.path.join(REPO, "type_info.json"),
        "--device", "cpu", "tile", "--input_dir", str(tmp_path / "in"),
        "--output_dir", str(tmp_path / "out"), "--save_format", "json"])
    assert os.listdir(tmp_path / "out" / "json") == ["a.json"]


@pytest.mark.parametrize("kwargs, want", [
    (dict(device="cpu"), ["cpu"]),
    (dict(n_devices=3, device="cpu"), ["cpu"] * 3),
    (dict(devices=["cpu", "cpu:0", "cpu"]), ["cpu", "cpu:0", "cpu"]),
    (dict(n_devices=2, devices=["cpu"] * 3), ["cpu"] * 2),
], ids=["cpu", "cpu3", "explicit", "explicit2"])
def test_train_devices(kwargs, want):
    from hover_net_tpu_torch.train.manager import train_devices

    assert train_devices(**kwargs) == [torch.device(d) for d in want]


def test_n_devices_beyond_the_cards_raises(monkeypatch, tmp_path):
    """As the JAX trainer's `make_mesh` asserts, asking for more cards
    than there are raises (the inference managers clamp instead)."""
    from hover_net_tpu_torch.config import TrainConfig
    from hover_net_tpu_torch.train.manager import TrainManager, train_devices

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert train_devices(None, "cuda:0") == [torch.device("cuda", 0)]
    with pytest.raises(ValueError, match="need 2 devices"):
        TrainManager(TrainConfig(log_dir=str(tmp_path)), n_devices=2,
                     device="cuda:0")
    with pytest.raises(ValueError, match="need 4 devices"):
        train_devices(4, devices=["cpu"] * 3)


# -------------------------------------------------------------- dryrun

def test_dryrun_multichip_on_two_cpu_ranks(capsys):
    from hover_net_tpu_torch.entry import dryrun_multichip

    dryrun_multichip(2, devices=["cpu", "cpu"])
    out = capsys.readouterr().out
    assert "dryrun_multichip ok: 2 devices, loss=" in out
    assert "dryrun_striped_infer ok: 2 devices," in out


@pytest.mark.parametrize("backend, devices", [
    ("gloo", ["cpu", "cpu"]),
    ("nccl", ["cuda:0", "cuda:1"]),
    ("gloo", ["cuda:0", "cuda:0"]),
    ("gloo", ["cuda:0", "cpu"]),
])
def test_backend_follows_the_devices(backend, devices):
    assert distributed.backend_for(devices) == backend


def live_ranks():
    return [p for p in multiprocessing.active_children()
            if p.name.startswith("rank-")]


def kill_rank_1():
    """SIGKILL rank 1 of the run this process starts, once it is up."""
    deadline = time.monotonic() + 60
    while time.monotonic() < deadline:
        for p in live_ranks():
            if p.name == "rank-1" and p.pid:
                os.kill(p.pid, 9)
                return
        time.sleep(0.05)


@pytest.mark.parametrize("case", ["raises", "killed", "timeout"])
def test_run_ranks_fails_fast(case):
    """A rank that raises, a rank killed while rank 0 waits for it, and a
    run past its limit: each fails the call well inside the limit, with
    the cause, and leaves no rank running."""
    args, limit, want = (2,), SPAWN_S, None
    if case == "raises":
        args, want = ("two",), "TypeError"
    elif case == "killed":
        threading.Thread(target=kill_rank_1, daemon=True).start()
        want = "rank 1 ended with exit code -9"
    else:
        limit, want = 1.0, "timed out"
    t0 = time.monotonic()
    with pytest.raises(RuntimeError, match=want):
        distributed.run_ranks(t_tp._dryrun_rank, ["cpu"] * 2, args,
                              timeout_s=limit)
    assert time.monotonic() - t0 < 120
    assert live_ranks() == []
