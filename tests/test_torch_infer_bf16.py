"""The port's bf16 inference forward (the inference managers' default
body) against the JAX package's bf16 forward, on the CPU, width 8.

Weights. A seeded float32 port model whose BatchNorm affines are drawn
as the suite draws them (scale U(0.5, 1.5), bias N(0, 0.1)) and whose
running statistics are those of one float32 train-mode batch of two
synthetic nuclei patches (`cli.recipe.synth_nuclei_image`, momentum 1):
|mean| / std of the BN inputs is then what a trained net sees (median
~0.4, a few above 5), where the suite's N(0, 0.1) means would hide a
rounded statistic. The JAX package gets the same float32 values through
`jax_from_state_dict`.

The JAX reference. Flax keeps BN's parameters and statistics in float32
under a bf16 body and rounds each module's output to bf16. On the CPU,
XLA's jit may keep a bf16 intermediate in float32 where two fused ops
meet (`xla_allow_excess_precision`, on by default): the jitted JAX bf16
forward then differs from itself run op by op on 36 % of the stem's
outputs. So the reference is jitted with an `optimization_barrier` on
the inputs and outputs of every Flax module (`strict_bf16`), which holds
every rounding the program states; it equals the jit under
`XLA_FLAGS=--xla_allow_excess_precision=false` bit for bit, and the
eager forward on all but ~1e-5 of the BN outputs. Nothing in the JAX
package changes.

Stages (fast 256^2 and original 270^2, untyped and nr_types=5): the
stem, d0..d3, conv_bot and each branch's u3, u2, u1 and u0, each fed the
JAX stage's bf16 input (teacher forcing: the random net amplifies a
rounding from stage to stage). An element is off when it is more than
one bf16 ulp (at the larger magnitude of the two) from JAX's; u0's float32
head is held in the same unit. `BOUNDS` caps the share of off elements
per stage. Each single convolution (or BN) flips at most ~0.01 % of its
outputs by one ulp (the f32 accumulation order of oneDNN's convolution
against XLA's, and `F.batch_norm`'s x * a + b against flax's
(x - mean) * a + bias); the BN-ReLU layers of a deep stage amplify those
flips, so d1, d2 (6 units) and u3 (8 dense units) reach a few percent
(the measured maxima over the four cases are the comments of
`BOUNDS`). BN in flax's exact order leaves them there, so they are not
a rounding fault.
The negative control rounds every BN to bf16 (the port before it kept
them in float32): the stem goes from ~1e-5 to 11-33 % off, and every
stage with a BN misses its bound (16-51 %).

End to end (typed fast-mode weights above, the np head forced to
foreground, so the hv maps alone cut the instances): the bf16 tile
manager (`predict_image`, device branch, a second slot on "cpu:0" so a
replica is made) on a 300x340 image and the bf16 WSI manager (the
stitched prediction and instance map of its cache) on a 600x500 slide,
both packages, the JAX managers traced under `strict_bf16`. A whole
random width-8 net is chaotic in bf16, so the assertions hold the
stitched maps: each hv channel within 15 % mean relative |delta| of
JAX's and the type map equal on >= 85 % of the pixels (measured: tile
6.7 % / 9.4 % and 94.1 %, WSI 6.4 % / 8.7 % and 97.1 %; with the BN
rounded to bf16 the tile manager gives 29 % / 40 % and 74.9 %). The
instances' AJI is printed, not held (measured: tile 0.62 over 9 JAX
instances, 0.21 with the BN rounded; WSI 0.999 over 3).
"""

import json
import os

import cv2
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from flax import linen as nn

from hover_net_tpu.models import HoVerNet as JaxHoVerNet
from hover_net_tpu.models import HoVerNetConfig as JaxConfig
from hover_net_tpu_torch.cli.recipe import synth_nuclei_image
from hover_net_tpu_torch.metrics.stats import get_fast_aji
from hover_net_tpu_torch.models.blocks import BatchNorm2d, upsample2x
from hover_net_tpu_torch.models.checkpoints import jax_from_state_dict
from hover_net_tpu_torch.models.hovernet import HoVerNet, HoVerNetConfig
from hover_net_tpu_torch.utils.crops import crop_op

torch.set_num_threads(1)

BF16 = torch.bfloat16
WIDTH = 8
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TYPE_INFO = os.path.join(REPO, "type_info.json")
CASES = [("fast", None), ("fast", 5), ("original", None), ("original", 5)]
# the end-to-end managers' configuration
COMMON = dict(mode="fast", nr_types=5, width=WIDTH, type_info_path=TYPE_INFO)
ENCODER = ("conv0", "d0", "d1", "d2", "d3", "conv_bot")
# the share of elements more than one bf16 ulp from JAX's, per stage
# (measured maximum over CASES)
BOUNDS = {
    "conv0": 1e-4,  # 5.7e-6
    "d0": 5e-3,  # 6.0e-4
    "d1": 0.05,  # 1.8e-2
    "d2": 0.1,  # 4.3e-2
    "d3": 0.03,  # 8.2e-3
    "conv_bot": 1e-4,  # 7.2e-6
    "u3": 0.08,  # 3.1e-2
    "u2": 0.01,  # 1.5e-3
    "u1": 1e-4,  # 9.3e-6
    "u0": 1e-4,  # 0
}


def calibrated_model(mode, nr_types, seed=0) -> HoVerNet:
    """The float32 port model of the module docstring."""
    cfg = HoVerNetConfig(mode=mode, nr_types=nr_types, width=WIDTH)
    net = HoVerNet(cfg, generator=torch.Generator().manual_seed(seed))
    rng = np.random.default_rng(seed + 1)
    bns = [m for m in net.modules() if isinstance(m, BatchNorm2d)]
    size = cfg.patch_input_shape
    imgs = np.stack([synth_nuclei_image(size, size, seed=s, n_nuclei=60)[0]
                     for s in (1, 2)])
    with torch.no_grad():
        for m in bns:
            m.weight.copy_(torch.from_numpy(
                rng.uniform(0.5, 1.5, m.num_features)))
            m.bias.copy_(torch.from_numpy(rng.normal(0, 0.1, m.num_features)))
            m.momentum = 1.0
        net.train()(torch.from_numpy(imgs).permute(0, 3, 1, 2))
    for m in bns:
        m.momentum = 0.1
    return net.eval()


def bf16_model(state, mode, nr_types, bn_bf16=False) -> HoVerNet:
    cfg = HoVerNetConfig(mode=mode, nr_types=nr_types, width=WIDTH,
                         dtype=BF16)
    net = HoVerNet(cfg).eval()
    net.load_state_dict(state, strict=True)
    if bn_bf16:  # the negative control: the BN rounded as a whole .to()
        for m in net.modules():
            if isinstance(m, BatchNorm2d):
                m.to(BF16)
    return net


def _barrier(tree):
    return jax.tree_util.tree_map(
        lambda a: jax.lax.optimization_barrier(a)
        if isinstance(a, jax.Array) else a, tree)


def _round_every_module(fn, args, kwargs, context):
    return _barrier(fn(*_barrier(args), **kwargs))


def strict_bf16():
    """Within the block, Flax modules traced by jit materialise their
    inputs and outputs: no bf16 rounding between modules is elided."""
    return nn.intercept_methods(_round_every_module)


def jax_intermediates(state, mode, nr_types, img):
    """Every module output of the JAX bf16 forward on NHWC `img`."""
    cfg = HoVerNetConfig(mode=mode, nr_types=nr_types, width=WIDTH)
    model = JaxHoVerNet(JaxConfig(mode=mode, nr_types=nr_types, width=WIDTH,
                                  dtype=jnp.bfloat16))

    def run(variables, x):
        with strict_bf16():
            _, col = model.apply(variables, x, train=False,
                                 capture_intermediates=True,
                                 mutable=["intermediates"])
        return col["intermediates"]

    it = jax.jit(run)(jax_from_state_dict(state, cfg), jnp.asarray(img))
    return jax.tree_util.tree_map(
        lambda a: np.asarray(a.astype(jnp.float32)), it)


def stage_pairs(net, img, it):
    """{stage: (port output, JAX output)}, each port stage fed the JAX
    stage's input (NHWC float arrays out, bf16 NCHW tensors in)."""
    def out(*path):
        node = it
        for p in path:
            node = node[p]
        return node["__call__"][0]

    def nchw(a):
        return torch.from_numpy(np.array(a)).permute(0, 3, 1, 2).to(BF16)

    cfg = net.cfg
    pairs = {"conv0": (net.conv0(
        torch.from_numpy(img).permute(0, 3, 1, 2).to(BF16) / 255.0),
        out("conv0"))}
    prev = "conv0"
    for name in ENCODER[1:]:
        pairs[name] = (getattr(net, name)(nchw(out(prev))), out(name))
        prev = name
    k = cfg.ksize
    d0, d1, d2 = (nchw(out(n)) for n in ("d0", "d1", "d2"))
    td1 = (2 * (d2.shape[2] - 9 * (k - 1)), 2 * (d2.shape[3] - 9 * (k - 1)))
    td0 = (2 * (td1[0] - 5 * (k - 1)), 2 * (td1[1] - 5 * (k - 1)))
    d1 = crop_op(d1, (d1.shape[2] - td1[0], d1.shape[3] - td1[1]), "NCHW")
    d0 = crop_op(d0, (d0.shape[2] - td0[0], d0.shape[3] - td0[1]), "NCHW")
    for b in cfg.branches:
        br, jb = net.decoder[b], f"decoder_{b}"
        pairs[f"{b}.u3"] = (br.u3(upsample2x(nchw(out("conv_bot"))) + d2),
                            out(jb, "u3_convf"))
        pairs[f"{b}.u2"] = (br.u2(upsample2x(nchw(out(jb, "u3_convf"))) + d1),
                            out(jb, "u2_convf"))
        pairs[f"{b}.u1"] = (br.u1(upsample2x(nchw(out(jb, "u2_convf"))) + d0),
                            out(jb, "u1_conva"))
        pairs[f"{b}.u0"] = (br.u0(nchw(out(jb, "u1_conva"))),
                            out(jb, "u0_conv"))
    return pairs


def off_share(got, want) -> float:
    """Share of the elements more than one bf16 ulp (2^-7 of the larger
    magnitude's power of two) apart."""
    a = got.float().permute(0, 2, 3, 1).numpy().astype(np.float64)
    b = np.asarray(want, np.float64)
    assert a.shape == b.shape
    m = np.maximum(np.abs(a), np.abs(b))
    ulp = np.exp2(np.floor(np.log2(np.where(m > 0, m, 1.0))) - 7)
    return float(np.mean(np.abs(a - b) > ulp))


def stage_shares(net, img, it):
    with torch.no_grad():
        pairs = stage_pairs(net, img, it)
    return {name: off_share(got, want) for name, (got, want) in pairs.items()}


@pytest.fixture(scope="module", params=CASES,
                ids=[f"{m}-{n or 'untyped'}" for m, n in CASES])
def case(request):
    mode, nr_types = request.param
    state = calibrated_model(mode, nr_types).state_dict()
    size = HoVerNetConfig(mode=mode).patch_input_shape
    img = synth_nuclei_image(size, size, seed=3, n_nuclei=60)[0][None]
    img = img.astype(np.float32)
    return mode, nr_types, state, img, jax_intermediates(
        state, mode, nr_types, img)


def test_stages_match_jax_bf16(case):
    mode, nr_types, state, img, it = case
    shares = stage_shares(bf16_model(state, mode, nr_types), img, it)
    print({k: f"{v:.2e}" for k, v in shares.items()})
    for name, share in shares.items():
        assert share <= BOUNDS[name.split(".")[-1]], (name, share)


def test_bf16_batchnorm_misses_the_bounds(case):
    """The negative control: every BN rounded to bf16."""
    mode, nr_types, state, img, it = case
    shares = stage_shares(bf16_model(state, mode, nr_types, bn_bf16=True),
                          img, it)
    print({k: f"{v:.2e}" for k, v in shares.items()})
    assert shares["conv0"] > 0.05
    for name, share in shares.items():
        if name not in ("conv_bot",) and not name.endswith(".u1"):
            assert share > BOUNDS[name.split(".")[-1]], (name, share)


# ------------------------------------------------------------ end to end

@pytest.fixture(scope="module")
def e2e(tmp_path_factory):
    """(tar, tile image, slide dir, mask dir): typed fast-mode calibrated
    weights with a foreground np head, in the reference `.tar` format."""
    root = tmp_path_factory.mktemp("bf16_e2e")
    net = calibrated_model("fast", 5, seed=2)
    with torch.no_grad():
        head = net.decoder["np"].u0.conv
        head.weight.zero_()
        head.bias.copy_(torch.tensor([-2.0, 2.0]))
    tar = str(root / "m.tar")
    torch.save({"desc": net.state_dict()}, tar)
    img = synth_nuclei_image(300, 340, seed=5, n_nuclei=300)[0]
    slide_dir, mask_dir = root / "slides", root / "masks"
    os.makedirs(slide_dir)
    os.makedirs(mask_dir)
    np.save(str(slide_dir / "s.npy"),
            synth_nuclei_image(600, 500, seed=6, n_nuclei=800)[0])
    mask = np.zeros((600 // 8, 500 // 8), np.uint8)
    mask[5:-5, 5:-5] = 255
    cv2.imwrite(str(mask_dir / "s.png"), mask)
    return tar, img, str(slide_dir), str(mask_dir)


def agreement(port, ref, inst_port, inst_ref):
    """(hv mean relative |delta| of each hv channel, share of pixels of
    equal type, AJI of the instance maps)."""
    hv = [float(np.abs(port[..., c] - ref[..., c]).mean()
                / np.abs(ref[..., c]).mean()) for c in (2, 3)]
    same_type = float(np.mean(port[..., 0] == ref[..., 0]))
    aji = get_fast_aji(inst_ref.astype(np.int32), inst_port.astype(np.int32))
    return hv, same_type, aji


def assert_bn_float32(*models):
    for net in models:
        for m in net.modules():
            if isinstance(m, BatchNorm2d):
                assert {t.dtype for t in (m.weight, m.bias, m.running_mean,
                                          m.running_var)} == {torch.float32}


def test_tile_manager_bf16_matches_jax(e2e):
    from hover_net_tpu.infer.tile import TileInferManager as JaxTile
    from hover_net_tpu_torch.infer.tile import TileInferManager as PortTile

    tar, img, _, _ = e2e
    with strict_bf16():
        ref, inst_ref, _ = JaxTile(model_path=tar, dtype=jnp.bfloat16,
                                   batch_size=4, **COMMON).predict_image(img)
    ref = np.asarray(ref)
    port = PortTile(model_path=tar, dtype=BF16, batch_size=4,
                    devices=["cpu", "cpu:0"], **COMMON)
    assert_bn_float32(port.model, port.model_on(torch.device("cpu:0")))
    got, inst, _ = port.predict_image(img)
    hv, same_type, aji = agreement(got, ref, inst, inst_ref)
    print(f"tile: hv {hv}, same type {same_type:.4f}, AJI {aji:.4f}, "
          f"{len(np.unique(inst_ref)) - 1} JAX instances")
    assert max(hv) < 0.15 and same_type >= 0.85, (hv, same_type)

    for net in (port.model, port.model_on(torch.device("cpu:0"))):
        for m in net.modules():  # the negative control
            if isinstance(m, BatchNorm2d):
                m.to(BF16)
    bad, inst_bad, _ = port.predict_image(img)
    hv, same_type, aji = agreement(bad, ref, inst_bad, inst_ref)
    print(f"tile, BN in bf16: hv {hv}, same type {same_type:.4f}, "
          f"AJI {aji:.4f}")
    assert max(hv) > 0.15 and same_type < 0.85, (hv, same_type)


def test_wsi_manager_bf16_matches_jax(e2e, tmp_path):
    from hover_net_tpu.infer.wsi import WSIInferManager as JaxWSI
    from hover_net_tpu_torch.infer.wsi import WSIInferManager as PortWSI

    tar, _, slide_dir, mask_dir = e2e
    kw = dict(model_path=tar, batch_size=8, chunk_shape=1000,
              tile_shape=256, ambiguous_size=32, proc_mag=40,
              pred_map_dtype="float32", hbm_pred_budget=0, **COMMON)
    maps = {}
    for name, cls, extra in (
            ("jax", JaxWSI, dict(dtype=jnp.bfloat16)),
            ("port", PortWSI, dict(dtype=BF16, device="cpu"))):
        cache = str(tmp_path / f"cache_{name}")
        mgr = cls(cache_path=cache, **extra, **kw)
        if name == "port":
            assert_bn_float32(mgr.model)
        out = tmp_path / name
        os.makedirs(out)
        mgr.save_thumb = mgr.save_mask = False
        with strict_bf16():  # process_wsi_list without the cache's removal
            mgr.process_single_file(os.path.join(slide_dir, "s.npy"),
                                    os.path.join(mask_dir, "s.png"), str(out))
        maps[name] = (np.load(os.path.join(cache, "pred_map.npy")),
                      np.load(os.path.join(cache, "pred_inst.npy")))
        with open(out / "s.json") as f:
            assert json.load(f)["nuc"]
    (got, inst), (ref, inst_ref) = maps["port"], maps["jax"]
    hv, same_type, aji = agreement(got, ref, inst, inst_ref)
    print(f"wsi: hv {hv}, same type {same_type:.4f}, AJI {aji:.4f}, "
          f"{len(np.unique(inst_ref)) - 1} JAX instances")
    assert max(hv) < 0.15 and same_type >= 0.85, (hv, same_type)
