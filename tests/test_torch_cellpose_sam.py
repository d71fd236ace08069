"""Cellpose-SAM in the port (hover_net_tpu_torch/models/cellpose_sam.py and
ops/flow_dynamics.py) against the benchmark's plain float32 reference
(benchmark/reference/cellpose_sam.py), on the CPU at a tiny size:
embedding 64, 4 blocks of 4 heads, patch 8 on 64^2 blocks (an 8^2 grid),
the blocks' rel-pos tables built as SAM builds them (27 rows in the
formerly windowed blocks, 127 in the global ones) and resized to 15.

The weights are seeded with He-normal convolutions and linear layers and
relative-position tables and positions of unit-order size, so that no
comparison could pass with the attention's bias dropped. The dynamics are
held to Cellpose's published code on painted masks through their own
flows (`masks_to_flows`), as the net's output would carry them.
"""

import json
import math

import cv2
import numpy as np
import pytest
import torch
from torch import nn

from benchmark.reference import cellpose_sam as ref_cp
from benchmark.reference.cellpose_sam import SAM_L, CellposeRef
from hover_net_tpu_torch.infer import steps
from hover_net_tpu_torch.models import cellpose_sam
from hover_net_tpu_torch.models.cellpose_sam import (
    CellposeSAM,
    CellposeSAMConfig,
)
from hover_net_tpu_torch.models.checkpoints import load_model_state
from hover_net_tpu_torch.ops import flow_dynamics
from hover_net_tpu_torch.runtime import forward_events

torch.set_num_threads(1)

TINY = dict(patch_size=8, embed_dim=64, depth=4, num_heads=4, mlp_ratio=4.0,
            sam_window_size=14, sam_global_attn_indexes=(1, 3), sam_grid=64,
            out_chans=32, nout=3, patch_input=64, patch_output=48)
# the reference's names of the same architecture
REF_TINY = dict(patch_size=8, embed_dim=64, depth=4, num_heads=4,
                mlp_ratio=4.0, window_size=14, global_attn_indexes=[1, 3],
                out_chans=32, nout=3, bsize=64)
# the port's bf16 body against the float32 reference: bf16 rounds each
# matmul input and output to 2^-9 relative, through 4 blocks, the neck
# and the readout; measured 0.6-0.9 % on these weights
BF16_TOL = 0.03


def tiny_cfg(**kw) -> CellposeSAMConfig:
    return CellposeSAMConfig(**TINY, **kw)


def seeded_reference(seed: int = 0) -> CellposeRef:
    ref = CellposeRef(REF_TINY).eval()
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for name, m in ref.named_modules():
            if isinstance(m, (nn.Conv2d, nn.Linear)):
                m.weight.normal_(0, math.sqrt(2 / m.weight[0].numel()),
                                 generator=g)
                if m.bias is not None:
                    m.bias.normal_(0, 0.1, generator=g)
        for name, p in ref.named_parameters():
            if "rel_pos" in name or "pos_embed" in name:
                p.normal_(0, 0.5, generator=g)
    return ref


def blocks(n: int, size: int = 64, seed: int = 5) -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, 3, size, size, generator=g)


def rel(a, b) -> float:
    return float((a.float() - b.float()).norm() / b.float().norm())


@pytest.fixture(scope="module")
def ref():
    return seeded_reference()


def test_forward_matches_reference(ref):
    """float32: the [dY, dX, cellprob] map within 1e-5 of the reference,
    the tables of 27 and 127 rows resized to the 8^2 grid's 15."""
    port = CellposeSAM(tiny_cfg()).eval()
    port.load_state_dict(ref.state_dict(), strict=True)
    rows = [b.attn.rel_pos_h.shape[0] for b in port.encoder.blocks]
    assert rows == [27, 127, 27, 127]
    assert all(b.window == 0 for b in port.encoder.blocks)
    x = blocks(2)
    with torch.no_grad():
        want, got = ref(x), port(x)
    assert got.shape == want.shape == (2, 3, 64, 64)
    assert rel(got, want) <= 1e-5


def test_bf16_body_within_tolerance_rel_pos_needed(ref):
    """The port's bf16 body (float32 norms and readout) stays within
    BF16_TOL of the float32 reference, where the reference with its
    relative-position tables zeroed misses it."""
    port = CellposeSAM.from_state_dict(tiny_cfg(dtype=torch.bfloat16),
                                       ref.state_dict()).eval()
    assert port.encoder.blocks[0].norm1.weight.dtype == torch.float32
    assert port.encoder.neck[1].weight.dtype == torch.float32
    assert port.out.weight.dtype == torch.float32
    assert port.W2.dtype == torch.float32
    assert port.encoder.blocks[0].attn.qkv.weight.dtype == torch.bfloat16
    zeroed = CellposeRef(REF_TINY).eval()
    zeroed.load_state_dict({k: v.clone().zero_() if "rel_pos" in k else v
                            for k, v in ref.state_dict().items()})
    x = blocks(2)
    with torch.no_grad():
        want, got, nobias = ref(x), port(x), zeroed(x)
    assert rel(got, want) <= BF16_TOL
    assert rel(nobias, want) > BF16_TOL


def test_decode_is_the_centre_and_infer_output_reads_it(ref):
    port = CellposeSAM(tiny_cfg()).eval()
    port.load_state_dict(ref.state_dict())
    x = blocks(2)
    with torch.no_grad():
        full = port(x)
        out = port.decode(port.encode(x))
        maps = steps.infer_output(port, x.permute(0, 2, 3, 1))
    assert set(out) == {"flows"}
    assert torch.equal(out["flows"], full[:, :, 8:56, 8:56])
    assert maps.shape == (2, 48, 48, 3)
    assert torch.equal(maps, out["flows"].permute(0, 2, 3, 1))
    assert steps.flow_outputs(port)
    assert not steps._use_fused_enc(port, torch.device("cuda"))


def test_readout_is_cellposes_transposed_convolution(ref):
    """`pixel_shuffle` gives what Cellpose's `conv_transpose2d` with the
    identity `W2` gives, bit for bit."""
    port = CellposeSAM(tiny_cfg()).eval()
    port.load_state_dict(ref.state_dict())
    y = torch.randn(2, 192, 4, 4)
    want = torch.nn.functional.conv_transpose2d(y, port.W2, stride=8)
    assert torch.equal(torch.nn.functional.pixel_shuffle(y, 8), want)


# Cellpose's state dict: the keys of `vit_sam.Transformer("vit_l")`
CELLPOSE_KEYS = (
    "encoder.pos_embed", "encoder.patch_embed.proj.weight",
    "encoder.patch_embed.proj.bias", "encoder.blocks.3.norm1.weight",
    "encoder.blocks.3.norm1.bias", "encoder.blocks.3.attn.rel_pos_h",
    "encoder.blocks.3.attn.rel_pos_w", "encoder.blocks.3.attn.qkv.weight",
    "encoder.blocks.3.attn.qkv.bias", "encoder.blocks.3.attn.proj.weight",
    "encoder.blocks.3.attn.proj.bias", "encoder.blocks.3.norm2.weight",
    "encoder.blocks.3.mlp.lin1.weight", "encoder.blocks.3.mlp.lin2.bias",
    "encoder.neck.0.weight", "encoder.neck.1.weight", "encoder.neck.1.bias",
    "encoder.neck.2.weight", "encoder.neck.3.bias", "out.weight",
    "out.bias", "W2", "diam_labels", "diam_mean")


def test_state_dict_loads_from_cellpose_file(ref, tmp_path):
    """The port's keys are Cellpose's: its file (`cpsam`: a plain state
    dict, no extension; DataParallel's `module.` prefix allowed) and a
    `.tar` load with strict=True."""
    keys = list(CellposeSAM(tiny_cfg()).state_dict())
    assert keys == list(ref.state_dict())
    for name in CELLPOSE_KEYS:
        assert name in keys, name
    cfg = tiny_cfg()
    path = tmp_path / "cpsam"
    torch.save({f"module.{k}": v for k, v in ref.state_dict().items()},
               path)
    model = CellposeSAM.from_state_dict(cfg, load_model_state(str(path),
                                                              cfg)).eval()
    assert not model.W2.requires_grad
    x = blocks(1)
    with torch.no_grad():
        assert rel(model(x), ref(x)) <= 1e-5
    tar = tmp_path / "tiny.tar"
    torch.save({"desc": ref.state_dict()}, tar)
    CellposeSAM.from_state_dict(cfg, load_model_state(str(tar), cfg))
    extra = dict(ref.state_dict(), extra=torch.zeros(1))
    with pytest.raises(RuntimeError, match="extra"):
        CellposeSAM.from_state_dict(cfg, extra)


def test_published_sizes():
    """At the published widths (meta device): the reference's keys and
    shapes, 24 blocks of 1024 with 16 heads of 64 and MLP 4096, tables of
    127 rows at blocks 5, 11, 17 and 23 and 27 elsewhere, every block
    global, pos_embed 32^2, the readout 256 -> 192."""
    with torch.device("meta"):
        port = CellposeSAM(CellposeSAMConfig.for_mode("cellpose_sam"))
        ref = CellposeRef(SAM_L)
    shapes = {k: v.shape for k, v in port.state_dict().items()}
    assert shapes == {k: v.shape for k, v in ref.state_dict().items()}
    assert len(port.encoder.blocks) == 24
    blk = port.encoder.blocks[0]
    assert blk.attn.heads == 16 and blk.attn.qkv.weight.shape == (3072, 1024)
    assert blk.mlp.lin1.weight.shape == (4096, 1024)
    rows = [b.attn.rel_pos_h.shape for b in port.encoder.blocks]
    assert [i for i, r in enumerate(rows) if r[0] == 127] == [5, 11, 17, 23]
    assert rows.count((27, 64)) == 20
    assert all(b.window == 0 and b.part == "global_attn"
               for b in port.encoder.blocks)
    assert port.encoder.pos_embed.shape == (1, 32, 32, 1024)
    assert port.encoder.patch_embed.proj.weight.shape == (1024, 3, 8, 8)
    assert port.out.weight.shape == (192, 256, 1, 1)
    assert sum(p.numel() for p in port.encoder.parameters()) == 304_542_720
    assert port.cfg.patch_input_shape == 256
    assert port.cfg.patch_output_shape == 224
    with pytest.raises(ValueError, match="type"):
        CellposeSAMConfig.for_mode("cellpose_sam", nr_types=6)


class _Recorder:
    """A stand-in for `steps.StageEvents` recording the names."""

    def __init__(self):
        self.names, self.stages = [], []

    def record(self):
        return object()

    def part(self, name, start, end):
        self.names.append(name)

    def stage(self, name):
        self.stages.append(name)


def test_forward_parts_once_a_block(ref):
    """Inside `runtime.forward_events` a forward adds one `global_attn` part
    a block, then `vit_encoder` and `readout`."""
    port = CellposeSAM(tiny_cfg(dtype=torch.bfloat16)).eval()
    port.load_state_dict(ref.state_dict())
    events = _Recorder()
    token = forward_events.set(events)
    try:
        with torch.no_grad():
            steps.infer_output(port, blocks(1).permute(0, 2, 3, 1))
    finally:
        forward_events.reset(token)
    assert events.names == ["global_attn"] * 4 + ["vit_encoder", "readout"]


def test_normalize99_matches_cellpose():
    """The device `normalize99` of an image inside a padded canvas equals
    Cellpose's numpy `normalize_img` of the image, a constant channel
    left as it is."""
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (70, 90, 3)).astype(np.uint8)
    img[..., 2] = 17
    canvas = np.pad(img, ((5, 9), (3, 4), (0, 0)), mode="reflect")
    got = cellpose_sam.normalize99(torch.from_numpy(canvas), (70, 90),
                                   (5, 3))
    want = ref_cp.normalize99(img)
    np.testing.assert_allclose(got[5:75, 3:93].numpy(), want, rtol=1e-6,
                               atol=1e-6)
    assert torch.equal(got[..., 2], torch.full((84, 97), 17.0))


# ------------------------------------------------------------ dynamics


def painted_masks(case: str, shape=(120, 150), seed: int = 0):
    """Painted nuclei (ellipses, some touching) and one case of interest."""
    rng = np.random.default_rng(seed)
    h, w = shape
    m = np.zeros(shape, np.int32)
    k = 0
    for _ in range(40):
        cy, cx = int(rng.integers(8, h - 8)), int(rng.integers(8, w - 8))
        ry, rx = int(rng.integers(4, 9)), int(rng.integers(4, 9))
        sub = np.zeros(shape, np.uint8)
        cv2.ellipse(sub, (cx, cy), (rx, ry), int(rng.integers(180)), 0, 360,
                    1, -1)
        if (m[sub > 0] > 0).mean() > 0.3:
            continue
        k += 1
        m[(sub > 0) & (m == 0)] = k
    if case == "border":  # a nucleus cut by the image's edge: its seed
        # lies by the border
        m[:14, 60:76] = 0
        cv2.ellipse(m, (68, 2), (8, 7), 0, 0, 360, k + 1, -1)
    elif case == "big":  # one mask over 0.4 of the image
        m[:, :] = np.where(np.arange(w)[None, :] < 0.55 * w, k + 1, m)
    elif case == "small":  # a disc of 13 pixels, under 15
        m[:14, :14] = 0
        yy, xx = np.mgrid[-2:3, -2:3]
        m[4:9, 4:9][yy ** 2 + xx ** 2 <= 4] = k + 1
    return m


def flow_map(masks: np.ndarray, case: str = "") -> np.ndarray:
    """[H, W, 3]: 5x the masks' own flows and a cellprob of +-4, as a
    trained net gives; for `bad`, the largest mask's flows all pointing
    right, so that its pixels gather on its right edge into masks whose
    own flows disagree with the net's."""
    mu = ref_cp.masks_to_flows_gpu(masks.astype(np.int64))
    fmap = np.zeros(masks.shape + (3,), np.float32)
    fmap[..., :2] = (5 * mu).transpose(1, 2, 0)
    fmap[..., 2] = np.where(masks > 0, 4.0, -4.0)
    if case == "bad":
        ids, counts = np.unique(masks[masks > 0], return_counts=True)
        worst = masks == ids[np.argmax(counts)]
        fmap[worst, 0], fmap[worst, 1] = 0.0, 5.0
    return fmap


def same_partition(a: np.ndarray, b: np.ndarray) -> bool:
    """Equal label maps up to their ids."""
    pairs = set(zip(a.ravel().tolist(), b.ravel().tolist()))
    return (len(pairs) == len(np.unique(a)) == len(np.unique(b))
            and all((x == 0) == (y == 0) for x, y in pairs))


@pytest.mark.parametrize("case", ["plain", "border", "big", "bad", "small"])
def test_dynamics_match_cellpose(case):
    """Painted masks through their own flows: the port's dynamics give the
    reference's masks (Cellpose's published code) up to renumbering, and
    the same counts of seeds and of masks dropped; the case of interest
    shows in them."""
    masks = painted_masks(case)
    fmap = flow_map(masks, case)
    want, counts = ref_cp.masks_of_map(fmap)
    got, pc = flow_dynamics.compute_masks(
        torch.from_numpy(fmap).permute(2, 0, 1))
    got = got.numpy()
    assert same_partition(got, want.astype(np.int64))
    assert {k: int(v) for k, v in pc.items()} == counts
    assert counts["n_seeds"] > 10
    if case == "plain":  # the painted masks, a few boundary pixels apart
        fg = masks > 0
        assert len(np.unique(got)) == len(np.unique(masks))
        best = {a: np.bincount(got[masks == a]).argmax()
                for a in np.unique(masks[fg])}
        agree = np.vectorize(best.get)(masks[fg]) == got[fg]
        assert agree.mean() > 0.95
    if case == "big":  # dropped: over 0.4 of the image
        assert (got[:, : int(0.5 * masks.shape[1])] == 0).all()
    if case == "bad":
        assert counts["n_dropped_flow_error"] >= 1
    if case == "small":
        assert counts["n_dropped_small"] == 1
        assert got[:14, :14].max() == 0
    if case == "border":
        assert got[:3, 62:75].min() > 0


def test_masks_to_flows_matches_cellpose():
    masks = painted_masks("plain")
    want = ref_cp.masks_to_flows_gpu(masks.astype(np.int64))
    got = flow_dynamics.masks_to_flows(torch.from_numpy(masks),
                                       int(masks.max())).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_fill_holes_gives_enclosed_background_to_its_mask():
    m = np.zeros((40, 40), np.int32)
    cv2.circle(m, (12, 12), 8, 1, -1)
    m[10:14, 10:14] = 0  # a hole
    cv2.circle(m, (30, 30), 6, 2, -1)
    m[0:6, 30:36] = 3  # a mask of 36 pixels
    got, small = flow_dynamics.fill_holes_and_remove_small(
        torch.from_numpy(m), 3)
    want, ws = ref_cp.fill_holes_and_remove_small_masks(m.copy())
    assert same_partition(got.numpy(), want) and int(small) == ws == 0
    assert got[10:14, 10:14].min() > 0


# --------------------------------------------------------- the managers


def _nuclei_image(h, w, seed):
    rng = np.random.default_rng(seed)
    img = np.full((h, w, 3), 228, np.uint8)
    for _ in range(12):
        cv2.circle(img, (int(rng.integers(10, w - 10)),
                         int(rng.integers(10, h - 10))),
                   int(rng.integers(5, 8)), (130, 70, 150), -1)
    return img


def _dark_flows(real):
    """`infer_output` whose map is replaced by the flows of the dark
    pixels' components in each block's centre (a stand-in for a trained
    net: a seeded random one predicts no cells), the real forward run
    first."""
    from scipy.ndimage import label

    def fake(model, imgs):
        out = real(model, imgs)
        h = out.shape[1]
        m = (imgs.shape[1] - h) // 2
        maps = []
        for img in imgs[:, m:m + h, m:m + h, 0].cpu().numpy():
            lab = label(img < 0.5)[0]
            maps.append(flow_map(lab))
        return torch.from_numpy(np.stack(maps)).to(out)

    return fake


@pytest.fixture
def tiny_mode(monkeypatch, ref, tmp_path):
    """`--model_mode cellpose_sam` at the tiny size, its checkpoint a
    Cellpose-layout state dict of the seeded reference."""
    monkeypatch.setitem(cellpose_sam.CELLPOSE_MODES, "cellpose_sam",
                        dict(TINY))
    path = tmp_path / "cpsam"
    torch.save(ref.state_dict(), path)
    monkeypatch.setattr(steps, "infer_output",
                        _dark_flows(steps.infer_output))
    return str(path)


def test_tile_cli_runs_cellpose(tiny_mode, tmp_path):
    """`run_infer tile --model_mode cellpose_sam` builds Cellpose-SAM
    through the tile manager (batch 8, its block shapes) and writes an
    untyped json of the masks, with the counters in its timings; the
    pipeline marks the flow stages in order."""
    from hover_net_tpu_torch.cli.run_infer import main

    tin = tmp_path / "tiles"
    tin.mkdir()
    cv2.imwrite(str(tin / "t.png"), _nuclei_image(150, 130, 1))
    mgr = main(["--model_path", tiny_mode, "--model_mode", "cellpose_sam",
                "--device", "cpu", "tile", "--input_dir", str(tin),
                "--output_dir", str(tmp_path / "out")])
    assert isinstance(mgr.model, CellposeSAM) and mgr.batch_size == 8
    assert (mgr.patch_input_shape, mgr.patch_output_shape) == (64, 48)
    with open(tmp_path / "out" / "json" / "t.json") as f:
        nuc = json.load(f)["nuc"]
    assert 6 <= len(nuc) <= 14
    assert all(v["type"] is None for v in nuc.values())
    t = mgr.timings[0]
    assert t["n_seeds"] >= len(nuc)
    assert t["n_dropped_flow_error"] >= 0 and t["n_dropped_small"] >= 0
    assert t["from_tables"] and t["n_nuclei"] == len(nuc)
    assert (tmp_path / "out" / "overlay" / "t.png").exists()

    events = _Recorder()
    img = _nuclei_image(150, 130, 1)
    mgr._dispatch(img, 0)  # builds the pipeline of the image's grid
    run = next(iter(mgr._pipelines.values()))
    padded, coords, _ = mgr._reflect_padded(img)
    run(torch.from_numpy(np.ascontiguousarray(padded)),
        torch.from_numpy(coords.astype(np.int64)), img.shape[:2], events)
    assert events.stages == ["start", *steps.FLOW_STAGES]


def test_wsi_and_host_branch_and_training_refuse_cellpose(tiny_mode,
                                                          tmp_path):
    from hover_net_tpu_torch.cli.run_infer import main
    from hover_net_tpu_torch.cli.run_train import main as train_main
    from hover_net_tpu_torch.infer.tile import TileInferManager
    from hover_net_tpu_torch.infer.wsi import WSIInferManager

    with pytest.raises(ValueError, match="tile manager only"):
        main(["--model_path", tiny_mode, "--model_mode", "cellpose_sam",
              "--device", "cpu", "wsi", "--input_dir", str(tmp_path),
              "--output_dir", str(tmp_path / "out")])
    kw = dict(model_path=tiny_mode, mode="cellpose_sam", device="cpu")
    with pytest.raises(ValueError, match="percentiles"):
        WSIInferManager(**kw)
    with pytest.raises(ValueError, match="host_post_proc"):
        TileInferManager(device_post_proc=False, **kw)
    cfg = tmp_path / "cfg.py"
    cfg.write_text("from hover_net_tpu_torch.config import TrainConfig\n"
                   "config = TrainConfig(model_mode='cellpose_sam')\n")
    with pytest.raises(ValueError, match="Cellpose-SAM"):
        train_main(["--config", str(cfg), "--device", "cpu"])


def test_wsi_refusal_message(tiny_mode, tmp_path):
    """`run_infer wsi` reaches the slide manager's refusal, which says why
    and what to run instead."""
    from hover_net_tpu_torch.cli.run_infer import main

    with pytest.raises(ValueError) as err:
        main(["--model_path", tiny_mode, "--model_mode", "cellpose_sam",
              "--device", "cpu", "wsi", "--input_dir", str(tmp_path),
              "--output_dir", str(tmp_path / "out")])
    assert str(err.value) == ("cellpose_sam runs through the tile manager "
                              "only: Cellpose normalises each image by its "
                              "own percentiles")


@pytest.mark.gpu
def test_published_widths_on_card():
    """At the published widths on two 256^2 blocks: the port in float32
    (TF32 off) within 1e-4 of the reference, its bf16 body (the managers'
    default) within BF16_TOL; then the flow pipeline of a painted 1000^2
    tile through the card's dynamics gives the reference dynamics' masks
    on the same map."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.manual_seed(0)
    ref = CellposeRef(SAM_L).eval()
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for name, p in ref.named_parameters():
            if "rel_pos" in name or "pos_embed" in name:
                p.normal_(0, 0.5, generator=g)
    state = ref.state_dict()
    ref.cuda()
    x = blocks(2, 256).cuda()
    with torch.no_grad():
        want = ref(x)
    del ref
    for dtype, tol in ((torch.float32, 1e-4), (torch.bfloat16, BF16_TOL)):
        cfg = CellposeSAMConfig.for_mode("cellpose_sam", dtype=dtype)
        port = CellposeSAM.from_state_dict(cfg, state).cuda().eval()
        with torch.no_grad():
            got = port(x)
        err = rel(got, want)
        print(dtype, err)
        assert err <= tol, (dtype, err)
        del port, got
    masks = painted_masks("plain", (1000, 1000), seed=3)
    fmap = flow_map(masks)
    want, counts = ref_cp.masks_of_map(fmap, "cuda")
    got, pc = flow_dynamics.compute_masks(
        torch.from_numpy(fmap).cuda().permute(2, 0, 1))
    assert same_partition(got.cpu().numpy(), want.astype(np.int64))
    assert {k: int(v) for k, v in pc.items()} == counts
