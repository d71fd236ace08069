"""The trainer's CUDA paths on the card: the prefetch loader's side-stream
copies and one train step against the same step on the CPU. Every test
here needs a CUDA device and skips without one.

This file imports no jax, so it runs on a machine without it:
  python -m pytest --noconftest -m gpu tests/test_torch_train_cuda.py
"""

import numpy as np
import pytest
import torch

from hover_net_tpu_torch.data import train_pipeline as tpipe
from hover_net_tpu_torch.models.hovernet import HoVerNet, HoVerNetConfig
from hover_net_tpu_torch.parallel import train_parallel as tp

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def write_patches(path, n, size=140, seed=0):
    """n [size, size, 5] int32 patches: RGB, disc instances, types."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size]
    for i in range(n):
        inst = np.zeros((size, size), np.int32)
        for k in range(1, 8):
            cy, cx = rng.integers(15, size - 15, 2)
            inst[((yy - cy) ** 2 + (xx - cx) ** 2 <= 100) & (inst == 0)] = k
        img = rng.integers(0, 256, (size, size, 3))
        np.save(path / f"p{i}.npy", np.dstack(
            [img, inst, np.where(inst > 0, inst % 4 + 1, 0)]).astype(np.int32))


def loader(path, batch):
    return tpipe.TrainLoader(tpipe.PatchDataset([str(path)]),
                             batch_size=batch, input_shape=(96, 96),
                             mask_shape=(4, 4), mode="train", with_type=True,
                             num_workers=0, seed=3)


def test_prefetch_loader_on_the_card(cuda, tmp_path):
    """Batches copied on the side stream equal the host batches, while
    the compute stream is kept busy between hand-outs."""
    write_patches(tmp_path, 12)
    want = list(loader(tmp_path, 2))
    pre = tpipe.PrefetchLoader(loader(tmp_path, 2), cuda, buffer=2)
    big = torch.randn(2048, 2048, device=cuda)
    got = []
    for batch in pre:
        for _ in range(4):
            big = (big @ big).clamp_(-1, 1)
        got.append({k: (v.float() * 1).cpu() for k, v in batch.items()})
    assert len(got) == len(want) == 6 and len(pre.wait_s) == 6
    for g, w in zip(got, want):
        assert g.keys() == w.keys()
        for k in w:
            np.testing.assert_array_equal(g[k].numpy(),
                                          w[k].astype(np.float32), k)


@pytest.mark.parametrize("freeze", [True, False], ids=["frozen", "full"])
def test_train_step_on_the_card_matches_the_cpu(cuda, tmp_path, freeze):
    """One step with the model body in float64 (heads and loss float32,
    as in tests/test_torch_train_step.py; TF32 off): the loss terms,
    grad_norm, every parameter and BN statistic agree with the CPU's to
    1e-5 of their scale, and the frozen parameters are untouched on the
    card."""
    write_patches(tmp_path, 2)
    batch = {k: torch.from_numpy(v)
             for k, v in next(iter(loader(tmp_path, 2))).items()}
    cfg = HoVerNetConfig(mode="fast", nr_types=5, width=8,
                         dtype=torch.float64)
    start = HoVerNet(cfg, generator=torch.Generator().manual_seed(5))
    runs = []
    for device in ("cpu", cuda):
        net = HoVerNet(cfg)
        net.load_state_dict(start.state_dict())
        tx, schedule = tp.make_optimizer()
        state = tp.init_train_state(net, tx, device)
        step = tp.make_train_step(net, schedule, freeze_encoder=freeze)
        # the float32 heads and loss convolutions without TF32
        with torch.backends.cudnn.flags(enabled=True, allow_tf32=False):
            _, (terms, _) = step(state, {k: v.to(device)
                                         for k, v in batch.items()})
        runs.append(({k: float(v) for k, v in terms.items()},
                     {k: v.cpu() for k, v in net.state_dict().items()}))
    (want_terms, want), (got_terms, got) = runs
    for k, w in want_terms.items():
        assert abs(got_terms[k] - w) <= 1e-5 * abs(w), k
    for key, w in want.items():
        if key.endswith("num_batches_tracked"):
            assert torch.equal(got[key], w), key
            continue
        scale = float(w.abs().max()) or 1.0
        assert float((got[key] - w).abs().max()) <= 1e-5 * scale, key
        frozen = key.startswith(("d1.", "d2.", "d3.", "d0.units."))
        if freeze and frozen and not key.endswith(("running_mean",
                                                   "running_var")):
            assert torch.equal(got[key], start.state_dict()[key]), key
