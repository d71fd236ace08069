"""The benchmark's reference against the measured program at width 8 on the
CPU: the forward, the post-processing oracle, the training targets and one
training step (loss and gradients)."""

import numpy as np
import pytest
import torch

from benchmark.reference import losses as ref_losses
from benchmark.reference.model import HoVerNetRef, head_maps
from benchmark.reference.paint import paint_tile
from benchmark.reference.postproc import proc_np_hv as ref_proc
from benchmark.reference.targets import gen_targets as ref_targets

from hover_net_tpu_torch.infer.steps import infer_output
from hover_net_tpu_torch.models.hovernet import HoVerNet, HoVerNetConfig
from hover_net_tpu_torch.ops import losses as port_losses
from hover_net_tpu_torch.ops.post_proc_host import proc_np_hv as port_proc
from hover_net_tpu_torch.ops.targets import gen_targets as port_targets

CASES = [("fast", 6, 256), ("original", 5, 270), ("fast", None, 256)]


def _pair(mode, nr_types, seed=0, dtype=torch.float32):
    ref = HoVerNetRef(mode, nr_types, 8)
    ref.init_weights(torch.Generator().manual_seed(seed))
    g = torch.Generator().manual_seed(seed + 1)
    with torch.no_grad():
        for m in ref.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
                m.weight.uniform_(0.5, 1.5, generator=g)
                m.bias.normal_(0, 0.1, generator=g)
    port = HoVerNet(HoVerNetConfig(mode=mode, nr_types=nr_types, width=8,
                                   dtype=dtype, head_dtype=dtype))
    port.load_state_dict(ref.state_dict(), strict=True)
    ref.to(dtype)
    return ref, port


@pytest.mark.parametrize("mode,nr_types,size", CASES)
def test_forward_matches_program(mode, nr_types, size):
    ref, port = _pair(mode, nr_types)
    ref.eval()
    port.eval()
    img = paint_tile(size, size, 12, 3, nr_types)
    x = torch.from_numpy(np.stack([img, img[::-1].copy()]))
    with torch.no_grad():
        a = head_maps(ref(x.permute(0, 3, 1, 2)))
        b = infer_output(port, x)
    assert a.shape == b.shape
    assert torch.equal(a, b)


def test_postproc_matches_program_oracle():
    rng = np.random.default_rng(0)
    _, inst, _ = paint_tile(160, 150, 40, 5, None, with_labels=True)
    hv = ref_targets(inst, inst.shape)["hv_map"]
    pred = np.dstack([(inst > 0) * 0.9 + rng.uniform(0, 0.08, inst.shape),
                      hv + rng.normal(0, 0.05, hv.shape)]).astype(np.float32)
    a, b = ref_proc(pred), port_proc(pred)
    assert a.max() > 20
    np.testing.assert_array_equal(a, b)


def test_targets_match_program():
    _, inst, _ = paint_tile(256, 256, 30, 7, 6, with_labels=True)
    a, b = ref_targets(inst, (164, 164)), port_targets(inst, (164, 164))
    np.testing.assert_array_equal(a["np_map"], b["np_map"])
    np.testing.assert_array_equal(a["hv_map"], b["hv_map"])


@pytest.mark.parametrize("mode,nr_types,size", CASES[:2])
def test_train_step_matches_program(mode, nr_types, size):
    torch.manual_seed(0)
    ref, port = _pair(mode, nr_types, seed=4, dtype=torch.float64)
    ref.train()
    port.train()
    out_sz = 164 if mode == "fast" else 80
    imgs, nps, hvs, tps = [], [], [], []
    for s in range(2):
        img, inst, tp = paint_tile(size, size, 30, 10 + s, nr_types,
                                   with_labels=True)
        t = ref_targets(inst, (out_sz, out_sz))
        c = (size - out_sz) // 2
        imgs.append(img)
        nps.append(t["np_map"])
        hvs.append(t["hv_map"])
        tps.append(tp[c:c + out_sz, c:c + out_sz])
    x = torch.from_numpy(np.stack(imgs)).permute(0, 3, 1, 2).double()
    np_map = torch.from_numpy(np.stack(nps))
    hv = torch.from_numpy(np.stack(hvs)).double()
    tp = torch.from_numpy(np.stack(tps))

    ra = ref(x)
    loss_a, terms_a = ref_losses.hovernet_loss(ra, np_map, hv, tp)
    loss_a.backward()
    pb = port(x)
    f = torch.nn.functional
    pred = {"np": torch.softmax(pb["np"], 1), "hv": pb["hv"],
            "tp": torch.softmax(pb["tp"], 1)}
    true = {"np": f.one_hot(np_map.long(), 2).permute(0, 3, 1, 2).double(),
            "hv": hv.permute(0, 3, 1, 2),
            "tp": f.one_hot(tp.long(), nr_types).permute(0, 3, 1, 2).double()}
    loss_b, terms_b = port_losses.hovernet_loss(pred, true, np_map.double())
    loss_b.backward()
    for name in ("np_bce", "np_dice", "hv_mse", "hv_msge", "tp_bce", "tp_dice"):
        assert torch.allclose(terms_a[name], terms_b[f"loss_{name}"],
                              rtol=1e-9), name
    grads_b = dict(port.named_parameters())
    for name, p in ref.named_parameters():
        torch.testing.assert_close(p.grad, grads_b[name].grad, rtol=1e-7,
                                   atol=1e-10)
