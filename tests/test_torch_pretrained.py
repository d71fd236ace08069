"""`.npz` pretrained weights and the partial merge of the port's trainer.

No ImageNet file is in the repository, so the tests write small ones from
a seeded width-8 model: a TensorFlow-keyed encoder (`group0/block0/...`,
HWIO kernels) and a torch-keyed one (`module.d0.units.0...`, OIHW). Both
must load into the port's encoder exactly, as the JAX package's
`load_pretrained_npz` loads them.
"""

import numpy as np
import pytest
import torch

from hover_net_tpu.models import HoVerNetConfig as JaxConfig
from hover_net_tpu.models import checkpoints as j_ckpt
from hover_net_tpu_torch.models import checkpoints as t_ckpt
from hover_net_tpu_torch.models.hovernet import HoVerNet, HoVerNetConfig
from hover_net_tpu_torch.train.manager import merge_partial

CFG = HoVerNetConfig(mode="fast", nr_types=5, width=8)
ENCODER = ("conv0.", "d0.", "d1.", "d2.", "d3.")


def source_state():
    return HoVerNet(CFG, generator=torch.Generator().manual_seed(7)
                    ).state_dict()


def write_npz(path, style):
    """An encoder-only checkpoint of `source_state()` in `style`, plus a
    classifier head and one stray variable."""
    state = source_state()
    arrays = {}
    if style == "tf":
        torch_key = {p: k for k, p, _ in t_ckpt.name_map(CFG)}
        for tf_key, p in t_ckpt.tf_name_map(CFG):
            key = torch_key[p]
            if key.startswith(ENCODER):
                v = state[key].numpy()
                arrays[tf_key] = (v.transpose(2, 3, 1, 0) if v.ndim == 4
                                  else v)
        arrays["stray/W:0"] = np.zeros(3, np.float32)
    else:
        for key, v in state.items():
            if key.startswith(ENCODER):
                arrays["module." + key] = v.numpy()
        arrays["linear.weight"] = np.zeros((10, 8), np.float32)
        arrays["stray.weight"] = np.zeros(3, np.float32)
    np.savez(path, **arrays)
    return state


def encoder_keys():
    return [k for k, _, _ in t_ckpt.name_map(CFG) if k.startswith(ENCODER)]


@pytest.mark.parametrize("style", ["tf", "torch"])
def test_load_pretrained_npz(style, tmp_path, capsys):
    path = str(tmp_path / f"{style}.npz")
    state = write_npz(path, style)
    got = t_ckpt.load_pretrained_npz(path, CFG)
    assert "stray" in capsys.readouterr().out
    assert sorted(got) == sorted(encoder_keys())
    for key, v in got.items():
        assert torch.equal(v, state[key]), key

    # the JAX package's importer reads the same file to the same weights
    jax_tree = j_ckpt.load_pretrained_npz(path, JaxConfig(
        mode="fast", nr_types=5, width=8))
    for key, p, transform in t_ckpt.name_map(CFG):
        node = jax_tree
        for part in p:
            node = node.get(part, {}) if isinstance(node, dict) else node
        if key not in got:
            assert node == {}, key
            continue
        want = np.asarray(node)
        if transform == "OIHW":
            want = want.transpose(3, 2, 0, 1)
        assert np.array_equal(got[key].numpy(), want), key

    # merged into a fresh model: the encoder is the file's, the rest init
    net = HoVerNet(CFG, generator=torch.Generator().manual_seed(8))
    before = {k: v.clone() for k, v in net.state_dict().items()}
    missing, unknown = merge_partial(net, got)
    assert unknown == []
    assert missing and all(not k.startswith(ENCODER) for k in missing)
    for key, v in net.state_dict().items():
        assert torch.equal(v, state[key] if key in got else before[key]), key


def test_incomplete_encoder_raises(tmp_path):
    path = str(tmp_path / "part.npz")
    state = source_state()
    np.savez(path, **{k: state[k].numpy() for k in encoder_keys()[:-1]})
    with pytest.raises(KeyError, match="misses 1 encoder"):
        t_ckpt.load_pretrained_npz(path, CFG)
    assert len(t_ckpt.load_pretrained_npz(path, CFG, require_encoder=False)
               ) == len(encoder_keys()) - 1


def test_merge_partial_reports_and_raises():
    net = HoVerNet(CFG)
    incoming = {"conv_bot.weight": torch.zeros_like(
        net.state_dict()["conv_bot.weight"]), "extra.weight": torch.ones(2)}
    missing, unknown = merge_partial(net, incoming)
    assert unknown == ["extra.weight"] and "conv_bot.weight" not in missing
    assert not net.conv_bot.weight.any()
    with pytest.raises(ValueError, match="shape mismatch"):
        merge_partial(net, {"conv_bot.weight": torch.zeros(3, 3)})
