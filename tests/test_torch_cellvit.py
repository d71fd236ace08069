"""CellViT-SAM-H in the port (hover_net_tpu_torch/models/cellvit.py) against
the benchmark's plain float32 reference (benchmark/reference/cellvit.py),
on the CPU at a tiny size: embedding 64, depth 4, 4 heads, window 3,
global blocks 1 and 3, skips after blocks 1-4, 80^2 patches (a 5^2 grid,
so the windowed blocks pad it to 6^2).

The weights are seeded with He-normal convolutions and linear layers,
BatchNorm statistics off their defaults and relative-position tables and
positions of unit-order size: with PyTorch's default initialisation the
decoders shrink the ViT's skips to ~1e-4 of the maps, and no comparison of
the maps could tell whether the attention ran right.
"""

import json
import math
from types import SimpleNamespace

import cv2
import numpy as np
import pytest
import torch
from torch import nn

from benchmark.reference.cellvit import SAM_H, CellViTRef
from hover_net_tpu_torch.infer import steps
from hover_net_tpu_torch.models import cellvit
from hover_net_tpu_torch.models.cellvit import CellViT, CellViTConfig
from hover_net_tpu_torch.models.checkpoints import load_model_state
from hover_net_tpu_torch.runtime import forward_events

torch.set_num_threads(1)

TINY = dict(patch_size=16, embed_dim=64, depth=4, num_heads=4,
            mlp_ratio=4.0, window_size=3, global_attn_indexes=(1, 3),
            extract_layers=(1, 2, 3, 4), out_chans=256,
            num_tissue_classes=19, patch_input=80, patch_output=64)
# the reference takes SAM's img_size, the port its patch_input
REF_TINY = dict(TINY, img_size=80)
# the port's bf16 body against the float32 reference: bf16 rounds each
# matmul input and output to 2^-9 relative, through 4 blocks and ~15
# convolutions in a row; measured 1.2-2.5 % on these weights
BF16_TOL = 0.05


def tiny_cfg(**kw) -> CellViTConfig:
    return CellViTConfig(nr_types=6, **TINY, **kw)


def seeded_reference(seed: int = 0) -> CellViTRef:
    ref = CellViTRef(REF_TINY, 6).eval()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in ref.modules():
            if isinstance(m, nn.ConvTranspose2d):
                fan_in = m.weight.shape[0]
            elif isinstance(m, (nn.Conv2d, nn.Linear)):
                fan_in = m.weight[0].numel()
            else:
                fan_in = None
            if fan_in:
                m.weight.normal_(0, math.sqrt(2 / fan_in), generator=g)
                if m.bias is not None:
                    m.bias.normal_(0, 0.1, generator=g)
            if isinstance(m, nn.BatchNorm2d):
                m.running_mean.normal_(0, 0.1, generator=g)
                m.running_var.uniform_(0.5, 1.5, generator=g)
        for name, p in ref.named_parameters():
            if "rel_pos" in name or "pos_embed" in name:
                p.normal_(0, 0.5, generator=g)
    return ref


def images(n: int, size: int, seed: int = 5) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.rand(n, 3, size, size, generator=g) * 255


def rel(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


@pytest.fixture(scope="module")
def ref():
    return seeded_reference()


@pytest.mark.parametrize("size", [80, 48])
def test_forward_matches_reference(ref, size):
    """float32: every head and the tissue logits within 1e-5 of the
    reference. At 48^2 (a 3^2 grid) `pos_embed` is cropped and the global
    blocks' tables (9 rows for a 5^2 grid) are resized to 5 rows."""
    port = CellViT(tiny_cfg()).eval()
    port.load_state_dict(ref.state_dict(), strict=True)
    x = images(2, size)
    with torch.no_grad():
        want, got = ref(x), port(x)
    assert set(got) == set(want) == {"tissue_types", "nuclei_binary_map",
                                     "hv_map", "nuclei_type_map"}
    for k in want:
        assert got[k].shape == want[k].shape
        assert rel(got[k], want[k]) <= 1e-5, k


def test_bf16_body_within_tolerance_rel_pos_needed(ref):
    """The port's bf16 body (float32 norms and heads) stays within
    BF16_TOL of the float32 reference on every output, where the
    reference with its relative-position tables zeroed misses it."""
    port = CellViT.from_state_dict(tiny_cfg(dtype=torch.bfloat16),
                                   ref.state_dict()).eval()
    assert port.encoder.blocks[0].norm1.weight.dtype == torch.float32
    assert port.decoder0[0].block[1].running_var.dtype == torch.float32
    assert port.nuclei_type_maps_decoder.decoder0_header[2].weight.dtype \
        == torch.float32
    assert port.encoder.blocks[0].attn.qkv.weight.dtype == torch.bfloat16
    zeroed = CellViTRef(REF_TINY, 6).eval()
    zeroed.load_state_dict({k: v.clone().zero_() if "rel_pos" in k else v
                            for k, v in ref.state_dict().items()})
    x = images(2, 80)
    with torch.no_grad():
        want, got, nobias = ref(x), port(x), zeroed(x)
    for k in want:
        assert rel(got[k], want[k]) <= BF16_TOL, k
        assert rel(nobias[k], want[k]) > BF16_TOL, k


def test_decode_is_the_centre_of_the_patch(ref):
    """`decode(encode(x))` gives the branches under HoVer-Net's names, cut
    to the centre patch_output^2, and the inference contract
    (`infer_output`) reads them."""
    port = CellViT(tiny_cfg()).eval()
    port.load_state_dict(ref.state_dict())
    x = images(2, 80)
    with torch.no_grad():
        full = port(x)
        out = port.decode(port.encode(x))
        maps = steps.infer_output(port, x.permute(0, 2, 3, 1))
    assert torch.equal(out["np"], full["nuclei_binary_map"][:, :, 8:72,
                                                            8:72])
    assert torch.equal(out["hv"], full["hv_map"][:, :, 8:72, 8:72])
    assert maps.shape == (2, 64, 64, 4)
    assert torch.equal(maps[..., 2:], out["hv"].permute(0, 2, 3, 1))


def test_state_dict_loads_from_cellvit_pth(ref, tmp_path):
    """The port's keys are CellViT's: a `.pth` in CellViT's layout
    (`model_state_dict` beside its other entries) loads with strict=True,
    and so does the reference `.tar` layout."""
    keys = list(CellViT(tiny_cfg()).state_dict())
    assert keys == list(ref.state_dict())
    for name in ("encoder.patch_embed.proj.weight", "encoder.pos_embed",
                 "encoder.blocks.3.norm1.weight",
                 "encoder.blocks.3.attn.qkv.bias",
                 "encoder.blocks.3.attn.proj.weight",
                 "encoder.blocks.3.attn.rel_pos_h",
                 "encoder.blocks.3.attn.rel_pos_w",
                 "encoder.blocks.3.norm2.bias",
                 "encoder.blocks.3.mlp.lin1.weight",
                 "encoder.blocks.3.mlp.lin2.bias",
                 "encoder.neck.0.weight", "encoder.neck.1.weight",
                 "encoder.neck.2.weight", "encoder.neck.3.bias",
                 "decoder0.1.block.1.running_var",
                 "decoder1.2.block.0.weight", "decoder2.1.block.1.weight",
                 "decoder3.0.block.2.bias",
                 "nuclei_binary_map_decoder.bottleneck_upsampler.weight",
                 "hv_map_decoder.decoder3_upsampler.3.weight",
                 "nuclei_type_maps_decoder.decoder0_header.2.weight",
                 "classifier_head.weight"):
        assert name in keys, name
    pth = tmp_path / "CellViT-tiny.pth"
    torch.save({"arch": "CellViTSAM", "epoch": 1,
                "model_state_dict": ref.state_dict(),
                "config": {"model": {"backbone": "SAM-H"}}}, pth)
    cfg = tiny_cfg()
    model = CellViT.from_state_dict(cfg,
                                    load_model_state(str(pth), cfg)).eval()
    x = images(1, 80)
    with torch.no_grad():
        assert rel(model(x)["hv_map"], ref(x)["hv_map"]) <= 1e-5
    tar = tmp_path / "tiny.tar"
    torch.save({"desc": ref.state_dict()}, tar)
    CellViT.from_state_dict(cfg, load_model_state(str(tar), cfg))
    with pytest.raises(ValueError, match=".pth or .tar"):
        load_model_state(str(tmp_path / "net.msgpack"), cfg)


def test_published_sizes():
    """At the published widths (built on the meta device) the port holds
    the reference's keys and shapes: 699.74M parameters, 4 global blocks
    with 127-row tables and 28 windowed with 27."""
    with torch.device("meta"):
        port = CellViT(CellViTConfig.for_mode("cellvit_sam_h", nr_types=6))
        ref = CellViTRef(SAM_H, 6)
    shapes = {k: v.shape for k, v in port.state_dict().items()}
    assert shapes == {k: v.shape for k, v in ref.state_dict().items()}
    assert sum(p.numel() for p in port.parameters()) == 699_741_149
    rows = [b.attn.rel_pos_h.shape[0] for b in port.encoder.blocks]
    assert [i for i, r in enumerate(rows) if r == 127] == [7, 15, 23, 31]
    assert rows.count(27) == 28
    assert port.cfg.patch_input_shape == 1024
    assert port.cfg.patch_output_shape == 960


class _Recorder:
    """A stand-in for `steps.StageEvents` that records the part names."""

    def __init__(self):
        self.names = []

    def record(self):
        return object()

    def part(self, name, start, end):
        self.names.append(name)


def test_forward_parts_and_k3_gate(ref):
    """Inside `runtime.forward_events` a forward adds one `global_attn` or
    `window_attn` part a block and `vit_encoder` / `vit_decoder` around
    them; K3's gate says no to CellViT, on a card too."""
    port = CellViT(tiny_cfg(dtype=torch.bfloat16)).eval()
    port.load_state_dict(ref.state_dict())
    events = _Recorder()
    token = forward_events.set(events)
    try:
        with torch.no_grad():
            steps.infer_output(port, images(1, 80).permute(0, 2, 3, 1))
    finally:
        forward_events.reset(token)
    assert events.names == ["window_attn", "global_attn", "window_attn",
                            "global_attn", "vit_encoder", "vit_decoder"]
    with torch.no_grad():
        assert not steps._use_fused_enc(port, torch.device("cuda"))
    assert not steps._use_fused_enc(
        SimpleNamespace(cfg=tiny_cfg(dtype=torch.bfloat16), training=False),
        torch.device("cuda"))


@pytest.fixture
def tiny_mode(monkeypatch, ref, tmp_path):
    """`--model_mode cellvit_sam_h` at the tiny size, its checkpoint a
    CellViT-layout `.pth` of the seeded reference."""
    monkeypatch.setitem(cellvit.CELLVIT_MODES, "cellvit_sam_h", dict(TINY))
    pth = tmp_path / "tiny.pth"
    torch.save({"model_state_dict": ref.state_dict()}, pth)
    info = tmp_path / "type_info.json"
    info.write_text(json.dumps({str(k): [f"t{k}", [k * 40, 0, 0]]
                                for k in range(6)}))
    return str(pth), str(info)


def _nuclei_image(h, w, seed):
    rng = np.random.default_rng(seed)
    img = np.full((h, w, 3), 228, np.uint8)
    for _ in range(12):
        cv2.circle(img, (int(rng.integers(10, w - 10)),
                         int(rng.integers(10, h - 10))),
                   int(rng.integers(4, 8)), (130, 70, 150), -1)
    return img


def test_tile_and_wsi_managers_run_cellvit(tiny_mode, tmp_path):
    """`run_infer tile|wsi --model_mode cellvit_sam_h` build CellViT
    through the managers (batch 8 by default, its patch shapes) and write
    their json; the WSI slide's forward ran in batches of 8 patches."""
    from hover_net_tpu_torch.cli.run_infer import main

    pth, info = tiny_mode
    common = ["--model_path", pth, "--model_mode", "cellvit_sam_h",
              "--nr_types", "6", "--type_info_path", info,
              "--device", "cpu"]
    tin = tmp_path / "tiles"
    tin.mkdir()
    cv2.imwrite(str(tin / "t.png"), _nuclei_image(150, 130, 1))
    mgr = main(common + ["tile", "--input_dir", str(tin), "--output_dir",
                         str(tmp_path / "tile_out"), "--save_format",
                         "json"])
    assert isinstance(mgr.model, CellViT) and mgr.batch_size == 8
    assert (mgr.patch_input_shape, mgr.patch_output_shape) == (80, 64)
    with open(tmp_path / "tile_out" / "json" / "t.json") as f:
        assert set(json.load(f)) == {"mag", "nuc"}

    sin, smask = tmp_path / "slides", tmp_path / "masks"
    sin.mkdir()
    smask.mkdir()
    np.save(str(sin / "s.npy"), _nuclei_image(300, 260, 2))
    cv2.imwrite(str(smask / "s.png"), np.full((30, 26), 255, np.uint8))
    mgr = main(common + ["wsi", "--input_dir", str(sin), "--output_dir",
                         str(tmp_path / "wsi_out"), "--input_mask_dir",
                         str(smask), "--cache_path", str(tmp_path / "cache"),
                         "--tile_shape", "256", "--ambiguous_size", "32",
                         "--chunk_shape", "1000"])
    assert isinstance(mgr.model, CellViT)
    # the one chunk feeds 4 x 3 patches of 80^2 (HoVer-Net's chunk grid):
    # batches of 8 and 4
    assert mgr.n_forward_batches == 2
    with open(tmp_path / "wsi_out" / "s.json") as f:
        assert set(json.load(f)) == {"mag", "nuc"}


@pytest.mark.parametrize("slots", [2, 3])
def test_striped_buffer_holds_cellvit_patches(slots):
    """`run_infer wsi --n_devices N`: the striped pred buffer's landing
    rows hold a whole 960^2 CellViT output, so patches that straddle
    stripe borders leave every slot's core rows equal to the one-device
    buffer's (CPU slots of a mesh)."""
    from hover_net_tpu_torch.infer import wsi
    from hover_net_tpu_torch.parallel.mesh import make_mesh

    shape, out_sz = (2500, 1100), 960
    coords = np.array([(y, x) for y in range(0, shape[0], out_sz)
                       for x in range(0, shape[1], out_sz)], np.int32)
    rng = np.random.default_rng(0)
    outs = torch.from_numpy(rng.standard_normal(
        (len(coords), out_sz, out_sz, 3)).astype(np.float16))

    def filled(mesh):
        mgr = wsi.WSIInferManager.__new__(wsi.WSIInferManager)
        mgr.cfg = CellViTConfig.for_mode("cellvit_sam_h", nr_types=6)
        mgr.pred_map_dtype = np.dtype("float16")
        mgr.mesh, mgr.device = mesh, torch.device("cpu")
        mgr.wsi_proc_shape = np.array(shape)
        mgr._alloc_pred_dev(3)
        wsi.fill_pred_dev(mgr, outs, coords, 2)
        return mgr

    one = filled(None)._pred_dev
    striped = filled(make_mesh(devices=["cpu"] * slots))
    s_rows, halo = striped._stripe
    assert halo == 1024
    for d, buf in enumerate(striped._pred_dev):
        lo = d * s_rows
        hi = min(lo + s_rows, one.shape[0])
        assert torch.equal(buf[halo:halo + hi - lo], one[lo:hi]), d


def test_run_train_refuses_cellvit(tmp_path):
    from hover_net_tpu_torch.cli.run_train import main

    cfg = tmp_path / "cfg.py"
    cfg.write_text("from hover_net_tpu_torch.config import TrainConfig\n"
                   "config = TrainConfig(model_mode='cellvit_sam_h')\n")
    with pytest.raises(ValueError, match="HoVer-Net"):
        main(["--config", str(cfg), "--device", "cpu"])


@pytest.mark.gpu
def test_published_widths_on_card():
    """At the published widths on two 1024^2 patches: the port in float32
    (TF32 off) within 1e-4 of the reference, and its bf16 body (the
    managers' default) within BF16_TOL on the maps."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(0)
    ref = CellViTRef(SAM_H, 6).eval()
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in ref.named_parameters():
            if "rel_pos" in name or "pos_embed" in name:
                p.normal_(0, 0.5, generator=g)
    state = ref.state_dict()
    ref.cuda()
    x = images(2, 1024).cuda()
    with torch.no_grad():
        want = ref(x)
    del ref
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, BF16_TOL)):
        cfg = CellViTConfig.for_mode("cellvit_sam_h", nr_types=6,
                                     dtype=dtype)
        port = CellViT.from_state_dict(cfg, state).cuda().eval()
        with torch.no_grad():
            got = port(x)
        for k in ("nuclei_binary_map", "hv_map", "nuclei_type_map"):
            err = rel(got[k], want[k])
            print(dtype, k, err)
            assert err <= tol, (dtype, k, err)
        del port, got
