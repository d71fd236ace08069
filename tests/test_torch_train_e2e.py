"""The port's two-phase trainer end to end on the CPU.

Two tiny phases (frozen encoder, then chained from its last epoch) over
synthetic patches through the port's run_train CLI: engine, callbacks,
`.tar` checkpoints, stats.json, phase chaining and `--resume`. The
trained `.tar` then loads into the JAX package (its `load_torch_tar`)
and into the port (its `load_torch_tar` and its tile manager), and the
two eval forwards agree to 1e-5 of the outputs' scale.
"""

import json
import os

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from hover_net_tpu.models import HoVerNet as JaxHoVerNet
from hover_net_tpu.models import HoVerNetConfig as JaxConfig
from hover_net_tpu.models.checkpoints import load_torch_tar as jax_load_tar
from hover_net_tpu_torch.cli import run_train
from hover_net_tpu_torch.models.checkpoints import load_torch_tar
from hover_net_tpu_torch.models.hovernet import HoVerNet, HoVerNetConfig
from hover_net_tpu_torch.train.manager import last_checkpoint
from test_train_e2e import make_patches

CONFIG = """
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
                    batch_size={{"train": 2, "valid": 2}},
                    nr_epochs={epochs}),
    ],
)
"""


def write_config(tmp_path, epochs):
    path = tmp_path / f"cfg_{epochs}.py"
    path.write_text(CONFIG.format(
        log_dir=str(tmp_path / "logs"), train=str(tmp_path / "train"),
        valid=str(tmp_path / "valid"), epochs=epochs))
    return str(path)


@pytest.fixture(scope="module")
def trained(tmp_path_factory):
    """Two phases of one epoch, then phase 1 resumed for a second."""
    tmp_path = tmp_path_factory.mktemp("train")
    rng = np.random.default_rng(0)
    make_patches(str(tmp_path / "train"), 4, rng)
    make_patches(str(tmp_path / "valid"), 2, rng)
    first = run_train.main(["--device", "cpu", "--config",
                            write_config(tmp_path, 1)])
    snapshot = {i: json.loads((tmp_path / "logs" / f"{i:02d}" /
                               "stats.json").read_text()) for i in (0, 1)}
    resumed = run_train.main(["--device", "cpu", "--resume", "--config",
                              write_config(tmp_path, 2)])
    return tmp_path, first, snapshot, resumed


def test_two_phases_write_checkpoints_and_stats(trained):
    tmp_path, first, snapshot, _ = trained
    assert len(first) == 2
    for idx in range(2):
        d = tmp_path / "logs" / f"{idx:02d}"
        assert (d / "net_epoch=1.tar").exists()
        assert (d / "net_best=[valid-np_dice].tar").exists()
        keys = snapshot[idx]["1"]
        for k in ("train-overall_loss", "train-grad_norm", "train-lr-net",
                  "valid-np_acc", "valid-np_dice", "valid-hv_mse"):
            assert np.isfinite(keys[k]), k
        assert sum(k.startswith("valid-tp_dice_") for k in keys) == 5
    # 4 patches at batch 2: 2 steps per epoch, each timed, none lost
    for info in first:
        assert info.train_state.step == 2
        assert len(info.step_s) == len(info.wait_s) == 2

    # the trainer's .tar is the reference format
    payload = torch.load(tmp_path / "logs" / "00" / "net_epoch=1.tar",
                         weights_only=True)
    assert set(payload) == {"desc", "optimizer", "step"}
    assert payload["step"] == 2


def test_phase_one_freezes_the_encoder_and_phase_two_chains(trained):
    tmp_path, *_ = trained
    logs = tmp_path / "logs"
    start = HoVerNet(HoVerNetConfig(mode="fast", nr_types=5, width=8),
                     generator=torch.Generator().manual_seed(10)).state_dict()
    p0 = load_torch_tar(str(logs / "00" / "net_epoch=1.tar"))
    for key, want in start.items():
        frozen = key.startswith(("d1.", "d2.", "d3.", "d0.units."))
        if key.endswith(("running_mean", "running_var",
                         "num_batches_tracked")) or "unpool" in key:
            continue
        assert torch.equal(p0[key], want) == frozen, key
    assert not torch.equal(p0["d3.blk_bna.bn.running_var"],
                           start["d3.blk_bna.bn.running_var"])


def test_resume_continues_phase_two(trained):
    tmp_path, _, snapshot, resumed = trained
    d = tmp_path / "logs" / "01"
    # phase 0 was complete and skipped; phase 1 went on from epoch 1
    assert len(resumed) == 1
    assert resumed[0].train_state.step == 4
    assert last_checkpoint(str(d)).endswith("net_epoch=2.tar")
    assert last_checkpoint(str(tmp_path / "logs" / "00")).endswith(
        "net_epoch=1.tar")
    stats = json.loads((d / "stats.json").read_text())
    assert stats["1"] == snapshot[1]["1"]
    assert "valid-np_dice" in stats["2"]
    assert torch.load(d / "net_epoch=2.tar", weights_only=True)["step"] == 4
    assert last_checkpoint(str(tmp_path), allow_missing=True) is None
    with pytest.raises(FileNotFoundError):
        last_checkpoint(str(tmp_path))


def test_trained_tar_loads_in_jax_and_the_port(trained):
    """Both loaders read the same weights: with the body in float64 on
    both sides (heads float32, as both models keep them) the eval
    forwards agree to 1e-5 of the outputs' scale. In float32 they part by
    up to 2e-5 here (trained BN statistics from 2-patch batches), the
    noise that tests/test_torch_model.py bounds at 2e-4."""
    tmp_path, *_ = trained
    tar = str(tmp_path / "logs" / "01" / "net_epoch=2.tar")
    img = np.random.default_rng(5).integers(0, 256, (1, 96, 96, 3),
                                            np.uint8)
    jcfg = JaxConfig(mode="fast", nr_types=5, width=8, dtype=jnp.float64)
    with jax.enable_x64(True):
        variables = jax.tree_util.tree_map(
            lambda v: jnp.asarray(v, jnp.float64), jax_load_tar(tar, jcfg))
        want = jax.jit(lambda v, x: JaxHoVerNet(jcfg).apply(
            v, x, train=False))(variables, jnp.asarray(img))
        want = jax.tree_util.tree_map(np.asarray, want)

    cfg = HoVerNetConfig(mode="fast", nr_types=5, width=8,
                         dtype=torch.float64)
    net = HoVerNet(cfg).eval()
    net.load_state_dict(load_torch_tar(tar), strict=True)
    with torch.no_grad():
        got = net(torch.from_numpy(img).permute(0, 3, 1, 2))
    for name, ref in want.items():
        ref = np.asarray(ref)
        out = got[name].permute(0, 2, 3, 1).numpy()
        assert np.abs(out - ref).max() <= 1e-5 * np.abs(ref).max(), name

    from hover_net_tpu_torch.infer.tile import TileInferManager

    mgr = TileInferManager(model_path=tar, mode="fast", nr_types=5,
                           width=8, dtype=torch.float32, device="cpu")
    for key, value in load_torch_tar(tar).items():
        assert torch.equal(mgr.model.state_dict()[key].cpu(), value), key


def test_view_needs_no_matplotlib(trained, tmp_path, monkeypatch):
    src, *_ = trained
    monkeypatch.chdir(tmp_path)
    monkeypatch.setitem(__import__("sys").modules, "matplotlib", None)
    run_train.main(["--view", "train", "--config", write_config(src, 1)])
    # 4 patches, batches of 4 (train mode drops the last partial one)
    assert os.listdir(tmp_path) == ["view_train_0.png"]


def test_one_device_only_and_no_cpu_fallback(tmp_path):
    """One device unless more are asked for (the CPU is one device; the
    multi-device runs are tests/test_torch_train_distributed.py's), and
    no fallback from CUDA to the CPU."""
    from hover_net_tpu_torch.config import TrainConfig
    from hover_net_tpu_torch.train.manager import TrainManager

    mgr = TrainManager(TrainConfig(log_dir=str(tmp_path)), device="cpu")
    assert mgr.devices == [torch.device("cpu")] and mgr.ctx is None
    assert TrainManager(TrainConfig(log_dir=str(tmp_path)), n_devices=2,
                        device="cpu").n_devices == 2
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            TrainManager(TrainConfig(log_dir=str(tmp_path)))


def test_init_train_state_runs_on_the_card_by_default():
    from hover_net_tpu_torch.parallel import train_parallel as tp

    net = HoVerNet(HoVerNetConfig(mode="fast", nr_types=5, width=8))
    tx, _ = tp.make_optimizer()
    assert tp.init_train_state(net, tx, "cpu").step == 0
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            tp.init_train_state(net, tx)
