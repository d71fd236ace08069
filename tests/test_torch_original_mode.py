"""Original mode against the JAX package, on the CPU.

Original mode is 270^2 patches in and 80^2 out, a 'VALID' 7x7 stem and
5x5 dense decoder units: the JAX package's default training configuration
(`TrainConfig.model_mode`) and the mode of the published CoNSeP
checkpoint. Width 8, typed with 5 types:

(a) tile: both packages' `TileInferManager` in float32 on a 300x340 and a
    260x260 image (4x5 and 4x4 grids of 270^2 patches) give identical
    inst_maps and json nuclei; the weights are the forced-foreground `.tar`
    of tests/test_torch_e2e_instances.py, in original mode;
(b) WSI: both packages' `WSIInferManager` on the 600x500 pseudo-slide of
    that file. The stitched prediction maps agree within 2e-4 of each
    channel's scale (the model-level bound of tests/test_torch_model.py),
    and the port's manager fed the JAX manager's stitched map writes the
    JAX json, nucleus for nucleus. End to end the two agree but for a few
    boundaries: in float32 the stitched hv maps differ by ~1e-5 of their
    scale (values in the thousands on a random net), and that flips
    watershed boundaries of a few nuclei in either mode (here 4 of 73; in
    fast mode 6 of 72 and 2 of 33 with the weight seeds 3 and 4), so the
    end-to-end check is the same nucleus ids, each within a pixel, and at
    least 90 % of them identical in every field;
(c) the train step at the smallest original geometry, 198^2 -> 8^2 (the
    JAX model maps 190 + 8k to 8k; `TrainConfig.shape_override` carries
    it), model body in float64, 3 steps, both freeze modes, at the
    tolerances of tests/test_torch_train_step.py through
    `parallel.dp_check.misses`; the negative control moves the skip crop
    of d0 and d1 by one pixel, and misses by >= 10x a tolerance;
(d) `TrainLoader` at `num_workers=0` on 540^2 typed patches at the true
    original shapes (input 270, targets 80) gives the JAX loader's
    batches, crops and np / hv / tp targets, bit for bit, two epochs over.
"""

import json
import os
from unittest import mock

import cv2
import numpy as np
import pytest
import scipy.io as sio
import torch

import jax
import jax.numpy as jnp
import optax

from hover_net_tpu.models import HoVerNet as JaxHoVerNet
from hover_net_tpu.models import HoVerNetConfig as JaxConfig
from hover_net_tpu.parallel import train_parallel as j_tp
from hover_net_tpu_torch.config import TrainConfig
from hover_net_tpu_torch.models import hovernet as t_hovernet
from hover_net_tpu_torch.models.checkpoints import state_dict_from_jax
from hover_net_tpu_torch.models.hovernet import HoVerNet, HoVerNetConfig
from hover_net_tpu_torch.parallel import dp_check

from test_torch_host_copies import assert_same, blobs
from test_torch_tile import forced_foreground_tar
from test_torch_train_step import LR, SCHEDULE, is_frozen, keep_grads
from test_wsi import _paint_nuclei

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TYPE_INFO = os.path.join(REPO, "type_info.json")
NR_TYPES, WIDTH = 5, 8
COMMON = dict(mode="original", nr_types=NR_TYPES, width=WIDTH,
              type_info_path=TYPE_INFO)
TILE_SHAPES = {"t0": (300, 340), "t1": (260, 260)}


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    """(original-mode tar, tile input dir, slide dir, mask dir): the
    images and slide of tests/test_torch_e2e_instances.py, plus a second
    tile."""
    root = tmp_path_factory.mktemp("orig")
    tar = forced_foreground_tar(str(root / "m.tar"), NR_TYPES, seed=2,
                                mode="original")
    tile_dir, slide_dir, mask_dir = (root / n for n in ("in", "slides",
                                                        "masks"))
    for d in (tile_dir, slide_dir, mask_dir):
        os.makedirs(d)
    for i, (name, shape) in enumerate(TILE_SHAPES.items()):
        img = np.random.default_rng(i).integers(0, 255, shape + (3,),
                                                dtype=np.uint8)
        cv2.imwrite(str(tile_dir / f"{name}.png"), img)
    rng = np.random.default_rng(3)
    inst = _paint_nuclei((600, 500), rng, 40)
    slide = np.full((600, 500, 3), (230, 200, 220), np.uint8)
    slide[inst > 0] = (120, 60, 150)
    np.save(str(slide_dir / "s.npy"),
            (slide - rng.integers(0, 20, slide.shape)).astype(np.uint8))
    mask = np.zeros((600 // 8, 500 // 8), np.uint8)
    mask[5:-5, 5:-5] = 255
    cv2.imwrite(str(mask_dir / "s.png"), mask)
    return tar, str(tile_dir), str(slide_dir), str(mask_dir)


# ------------------------------------------------------------------ (a)

def test_tile_managers_give_the_same_instances(inputs, tmp_path):
    from hover_net_tpu.infer.tile import TileInferManager as JaxTile
    from hover_net_tpu_torch.infer.tile import TileInferManager as PortTile

    tar, tile_dir, _, _ = inputs
    JaxTile(model_path=tar, dtype=jnp.float32, batch_size=4, **COMMON) \
        .process_file_list(tile_dir, str(tmp_path / "jax"))
    port = PortTile(model_path=tar, dtype=torch.float32, batch_size=4,
                    device="cpu", **COMMON)
    assert (port.patch_input_shape, port.patch_output_shape) == (270, 80)
    port.process_file_list(tile_dir, str(tmp_path / "port"))
    n_nuc = 0
    for name, shape in TILE_SHAPES.items():
        out = {}
        for pkg in ("jax", "port"):
            with open(tmp_path / pkg / "json" / f"{name}.json") as f:
                out[pkg] = (json.load(f)["nuc"], sio.loadmat(
                    str(tmp_path / pkg / "mat" / f"{name}.mat")))
        assert out["port"][1]["inst_map"].shape == shape
        np.testing.assert_array_equal(out["port"][1]["inst_map"],
                                      out["jax"][1]["inst_map"])
        assert out["port"][0] == out["jax"][0]
        n_nuc += len(out["jax"][0])
    assert n_nuc > 5


def pad_or_cut(real_pad):
    """np.pad that reads a negative width after an axis as a cut there."""
    def pad(arr, pad_width, *args, **kwargs):
        widths = np.broadcast_to(np.asarray(pad_width), (arr.ndim, 2))
        arr = arr[tuple(slice(0, n + min(int(after), 0))
                        for n, (_, after) in zip(arr.shape, widths))]
        return real_pad(arr, [(int(b), max(int(a), 0)) for b, a in widths],
                        *args, **kwargs)
    return pad


def test_tile_canvas_cut_where_the_padding_passes_it(inputs, tmp_path,
                                                     monkeypatch):
    """A 700x260 image takes a 9x4 grid, canonical 10x4: its reflect
    padding (1085 rows) reaches past the canonical canvas (990 rows), as
    a 1000^2 tile's does in original mode (1405 against 1310). The JAX
    manager asks np.pad for a negative extension there and writes
    nothing; the port cuts the canvas, which the patches never read past.
    With np.pad reading a negative width as that cut, the JAX manager
    gives the port's instances."""
    from hover_net_tpu.infer.tile import TileInferManager as JaxTile
    from hover_net_tpu_torch.infer.tile import TileInferManager as PortTile

    tar = inputs[0]
    in_dir = tmp_path / "in"
    os.makedirs(in_dir)
    img = np.random.default_rng(5).integers(0, 255, (700, 260, 3),
                                            dtype=np.uint8)
    cv2.imwrite(str(in_dir / "w.png"), img)
    jax_mgr = JaxTile(model_path=tar, dtype=jnp.float32, batch_size=8,
                      **COMMON)
    with pytest.raises(RuntimeError):
        jax_mgr.process_file_list(str(in_dir), str(tmp_path / "jax0"))
    PortTile(model_path=tar, dtype=torch.float32, batch_size=8,
             device="cpu", **COMMON).process_file_list(
                 str(in_dir), str(tmp_path / "port"))
    monkeypatch.setattr(np, "pad", pad_or_cut(np.pad))
    jax_mgr.process_file_list(str(in_dir), str(tmp_path / "jax"))
    monkeypatch.undo()
    out = {}
    for pkg in ("jax", "port"):
        with open(tmp_path / pkg / "json" / "w.json") as f:
            out[pkg] = (json.load(f)["nuc"], sio.loadmat(
                str(tmp_path / pkg / "mat" / "w.mat"))["inst_map"])
    assert out["port"][1].shape == (700, 260)
    np.testing.assert_array_equal(out["port"][1], out["jax"][1])
    assert out["port"][0] == out["jax"][0]
    assert len(out["jax"][0]) > 5


# ------------------------------------------------------------------ (b)

def wsi_classes():
    """The two managers, each keeping its stitched map (`self.stitched`)
    when the chunk loop ends, and the port's manager fed a given map in
    place of its chunk loop."""
    from hover_net_tpu.infer.wsi import WSIInferManager as JaxWSI
    from hover_net_tpu_torch.infer.wsi import WSIInferManager as PortWSI

    class Jax(JaxWSI):
        def _get_raw_prediction(self, chunk_info, patch_info):
            super()._get_raw_prediction(chunk_info, patch_info)
            self.stitched = np.array(np.load(self._pred_map_path))

    class Port(PortWSI):
        def _get_raw_prediction(self, chunk_info, patch_info):
            super()._get_raw_prediction(chunk_info, patch_info)
            h, w = (int(v) for v in self.wsi_proc_shape)
            self.stitched = self._pred_dev[:h, :w].numpy().copy()

    class Fed(PortWSI):
        fed = None

        def _get_raw_prediction(self, chunk_info, patch_info):
            pred_map = np.load(self._pred_map_path, mmap_mode="r+")
            pred_map[:] = self.fed
            pred_map.flush()

    return Jax, Port, Fed


def test_wsi_managers_give_the_same_instances(inputs, tmp_path):
    tar, _, slide_dir, mask_dir = inputs
    Jax, Port, Fed = wsi_classes()
    kw = dict(model_path=tar, batch_size=8, chunk_shape=1000,
              tile_shape=256, ambiguous_size=32, proc_mag=40,
              pred_map_dtype="float32", **COMMON)
    port_kw = dict(kw, dtype=torch.float32, device="cpu")
    # the JAX map on the mmap path, the port's on the device-buffer path
    jax_mgr = Jax(cache_path=str(tmp_path / "c_jax"), dtype=jnp.float32,
                  hbm_pred_budget=0, **kw)
    port_mgr = Port(cache_path=str(tmp_path / "c_port"), **port_kw)
    fed_mgr = Fed(cache_path=str(tmp_path / "c_fed"), hbm_pred_budget=0,
                  **port_kw)
    nuc = {}
    for name, mgr in (("jax", jax_mgr), ("port", port_mgr)):
        mgr.process_wsi_list(slide_dir, str(tmp_path / name),
                             input_mask_dir=mask_dir)
    fed_mgr.fed = jax_mgr.stitched
    fed_mgr.process_wsi_list(slide_dir, str(tmp_path / "fed"),
                             input_mask_dir=mask_dir)
    for name in ("jax", "port", "fed"):
        with open(tmp_path / name / "s.json") as f:
            nuc[name] = json.load(f)

    # the stitched maps: the forward's float32 agreement
    want, got = jax_mgr.stitched, port_mgr.stitched
    assert got.shape == want.shape == (600, 500, 4)
    for ch in range(4):
        scale = max(1.0, float(np.abs(want[..., ch]).max()))
        assert np.abs(got[..., ch] - want[..., ch]).max() <= 2e-4 * scale, ch
    # given the same map, the port's WSI post-processing is the JAX one's
    assert nuc["fed"] == nuc["jax"]
    assert len(nuc["jax"]["nuc"]) > 50
    # end to end: the same nuclei, but for float32's boundary flips
    jn, pn = nuc["jax"]["nuc"], nuc["port"]["nuc"]
    assert pn.keys() == jn.keys()
    same = [k for k in jn if pn[k] == jn[k]]
    assert len(same) >= 0.9 * len(jn)
    for k in jn:
        assert np.abs(np.subtract(pn[k]["centroid"], jn[k]["centroid"])
                      ).max() <= 1.0, k


# ------------------------------------------------------------------ (c)

TRAIN_CFG = TrainConfig(model_mode="original", nr_types=NR_TYPES,
                        width=WIDTH, shape_override={
                            "aug": (198, 198), "act": (198, 198),
                            "out": (8, 8)})
CFG = HoVerNetConfig(mode="original", nr_types=NR_TYPES, width=WIDTH)
CFG64 = HoVerNetConfig(mode="original", nr_types=NR_TYPES, width=WIDTH,
                       dtype=torch.float64)
N_STEPS, BATCH = 3, 2


def original_batches(seed=0):
    size, out = TRAIN_CFG.act_shape[0], TRAIN_CFG.out_shape[0]
    rng = np.random.default_rng(seed)
    return [{
        "img": rng.integers(0, 256, (BATCH, size, size, 3), np.uint8),
        "np_map": (rng.uniform(0, 1, (BATCH, out, out)) > 0.4
                   ).astype(np.uint8),
        "hv_map": rng.uniform(-1, 1, (BATCH, out, out, 2)).astype(np.float32),
        "tp_map": rng.integers(0, NR_TYPES, (BATCH, out, out)
                               ).astype(np.int32),
    } for _ in range(N_STEPS)]


def run_jax(variables, data, freeze):
    """N_STEPS JAX train steps in original mode, body in float64:
    {"terms", "grads" (step 1), "state"} keyed as the port's state dict."""
    model = JaxHoVerNet(JaxConfig(mode="original", nr_types=NR_TYPES,
                                  width=WIDTH, dtype=jnp.float64))
    tx, _ = j_tp.make_optimizer(**SCHEDULE)
    tx = optax.chain(keep_grads(), tx)
    with jax.enable_x64(True):
        cast = lambda t: jax.tree_util.tree_map(  # noqa: E731
            lambda v: jnp.asarray(v, jnp.float64), t)
        params = cast(variables["params"])
        state = j_tp.TrainState(
            params=params, batch_stats=cast(variables["batch_stats"]),
            opt_state=tx.init(params), step=jnp.zeros((), jnp.int32))
        step = j_tp.make_train_step(model, tx, freeze_encoder=freeze)
        terms, grads = [], None
        for batch in data:
            state, (out, _) = step(state, batch)
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


@pytest.fixture(scope="module")
def train_setup():
    """(JAX variables, the port's start state dict, batches, the JAX runs
    by freeze mode, filled as the tests ask for them)."""
    model = JaxHoVerNet(JaxConfig(mode="original", nr_types=NR_TYPES,
                                  width=WIDTH))
    size = TRAIN_CFG.act_shape[0]
    variables = jax.jit(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)),
        train=False))()
    variables = jax.tree_util.tree_map(np.asarray, variables)
    variables = {k: dict(v) for k, v in variables.items()}
    return (variables, state_dict_from_jax(variables, CFG),
            original_batches(), {})


def jax_run(train_setup, freeze):
    variables, _, data, runs = train_setup
    if freeze not in runs:
        runs[freeze] = run_jax(variables, data, freeze)
    return runs[freeze]


def train_misses(got, want, freeze, start):
    params = [k for k, _ in HoVerNet(CFG).named_parameters()]
    frozen = [k for k in params if freeze and is_frozen(k)]
    assert (len(frozen) > 100) == freeze
    return dp_check.misses(got, want, start, params, frozen, LR)


@pytest.mark.parametrize("freeze", [True, False], ids=["frozen", "full"])
def test_train_step_at_the_original_geometry_matches_jax(train_setup,
                                                         freeze):
    _, start, data, _ = train_setup
    assert data[0]["img"].shape[1:3] == (198, 198)
    assert data[0]["np_map"].shape[1:] == TRAIN_CFG.out_shape == (8, 8)
    want = jax_run(train_setup, freeze)
    got = dp_check.one_process_steps("cpu", CFG64, start, data, freeze,
                                     SCHEDULE)
    assert len(got["terms"]) == N_STEPS
    worst = train_misses(got, want, freeze, start)
    assert max(worst.values()) <= 1.0, worst
    moved = [k for k in start if k.endswith("running_var")
             and not torch.equal(got["state"][k].float(), start[k])]
    assert len(moved) > 50


def shifted_crop(x, cropping, layout="NHWC"):
    """A skip crop one pixel down and right of the centre: the defect a
    wrong crop geometry of original mode would be."""
    ct, cl = cropping[0] // 2 + 1, cropping[1] // 2 + 1
    h, w = x.shape[2] - cropping[0], x.shape[3] - cropping[1]
    return x[:, :, ct:ct + h, cl:cl + w]


def test_shifted_skip_crop_misses_jax(train_setup):
    """The negative control: the port with the d0 and d1 skips cropped a
    pixel off centre misses the JAX step by >= 10x a tolerance."""
    _, start, data, _ = train_setup
    want = jax_run(train_setup, False)
    with mock.patch.object(t_hovernet, "crop_op", shifted_crop):
        got = dp_check.one_process_steps("cpu", CFG64, start, data, False,
                                         SCHEDULE)
    worst = train_misses(got, want, False, start)
    assert max(worst.values()) >= 10.0, worst


# ------------------------------------------------------------------ (d)

@pytest.mark.parametrize("mode", ["train", "valid"])
def test_train_loader_at_the_original_shapes_matches_jax(mode, tmp_path):
    """540^2 typed patches (RGB, instances, types), input 270^2, targets
    80^2: the port's loader gives the JAX loader's batches, two epochs."""
    from hover_net_tpu.data import train_pipeline as j_pipe
    from hover_net_tpu_torch.data import train_pipeline as t_pipe

    cfg = TrainConfig()
    assert cfg.model_mode == "original"
    assert (cfg.act_shape, cfg.out_shape) == ((270, 270), (80, 80))
    for i in range(3):
        rng = np.random.default_rng(60 + i)
        inst = blobs((540, 540), 60, seed=60 + i)
        patch = np.concatenate([
            rng.integers(0, 256, (540, 540, 3)), inst[..., None],
            np.where(inst > 0, inst % 4 + 1, 0)[..., None]], -1)
        np.save(tmp_path / f"p{i}.npy", patch.astype(np.int32))
    epochs = []
    for mod in (t_pipe, j_pipe):
        loader = mod.TrainLoader(
            mod.PatchDataset([str(tmp_path)]), batch_size=2,
            input_shape=cfg.act_shape, mask_shape=cfg.out_shape, mode=mode,
            with_type=True, num_workers=0, seed=22)
        epochs.append([list(loader) for _ in range(2)])
        loader.close()
    assert_same(epochs[0], epochs[1])
    batch = epochs[0][0][0]
    assert batch["img"].shape == (2, 270, 270, 3)
    assert batch["hv_map"].shape == (2, 80, 80, 2)
    assert {"np_map", "tp_map"} <= batch.keys()
    assert batch["np_map"].any()
