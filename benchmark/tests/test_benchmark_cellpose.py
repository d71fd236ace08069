"""The Cellpose-SAM cell (`traffic/tile_cellpose.py`) and the four-card
slide cell (`traffic/wsi_4chip.py`) at test size on the CPU.

Cellpose-SAM runs tiny (embedding 64, 4 blocks, patch 8 on 64^2 blocks to
48^2) in the configuration and, through `CELLPOSE_MODES`, in the program;
its weights come from two recipe steps on the CPU, which predict no
cells, so where a run needs masks the program's forward is replaced by
the flows of the image's dark components (`dark_flows`). The four-card
cell runs on four CPU slots of one device (the striped path, as a
`--n_devices 4` run on cards takes it)."""

import json
import tempfile
import time

import numpy as np
import pytest
import torch

from benchmark import common, control, run
from benchmark.reference import cellpose_recipe, recipe
from benchmark.reference import cellpose_sam as ref_cp
from benchmark.traffic import tile_cellpose, wsi_4chip
from hover_net_tpu_torch.models import cellpose_sam
from hover_net_tpu_torch.ops import flow_dynamics

TINY = dict(embed_dim=64, depth=4, num_heads=4, global_attn_indexes=[1, 3],
            out_chans=32, bsize=64, patch_input=64, patch_output=48)
PROGRAM = dict(embed_dim=64, depth=4, num_heads=4,
               sam_global_attn_indexes=(1, 3), out_chans=32, patch_input=64,
               patch_output=48)
SMALL = {"tiles": 4, "tile_size": 150, "nuclei_per_tile": [10, 14],
         "tiles_per_call": 2, "max_calls": 40, "warm_tiles": 1,
         "check_tiles": 2, "check_within": 2, "trace_from_call": 1,
         "trace_calls": 1}
RECIPE = {"size": 64, "batch": 2, "nuclei_per_tile": [3, 5],
          "check_size": 128, "check_nuclei": 8, "more_steps": 1}


def dark_flows(real, bad=False):
    """`infer_output` whose map is the flows (5x `masks_to_flows`) and a
    cellprob of +-4 of the dark components of each block's centre, the
    real forward run first: a stand-in for a trained net. With `bad` the
    largest component of each block flows twice as fast: its points still
    meet, but its flow error (1) is over Cellpose's 0.4."""
    from scipy.ndimage import label

    def fake(model, imgs):
        out = real(model, imgs)
        h = out.shape[1]
        m = (imgs.shape[1] - h) // 2
        maps = []
        for img in imgs[:, m:m + h, m:m + h].float().mean(-1).cpu().numpy():
            lab = label(img < 0.5)[0]
            mu = ref_cp.masks_to_flows_gpu(lab)
            if bad and lab.max():
                mu = mu * np.where(
                    lab == np.bincount(lab.ravel())[1:].argmax() + 1, 2, 1)
            maps.append(np.concatenate(
                [5 * mu, np.where(lab > 0, 4.0, -4.0)[None]]).transpose(
                    1, 2, 0))
        return torch.from_numpy(np.stack(maps)).to(out)

    return fake


@pytest.fixture(scope="module")
def tiny_cell(tmp_path_factory):
    """tiny_cell(seed, seconds, trace) -> a CPU Context of
    `tile_cellpose_sam` at test size."""
    mp = pytest.MonkeyPatch()
    mp.setitem(cellpose_sam.CELLPOSE_MODES, "cellpose_sam",
               {**cellpose_sam.CELLPOSE_MODES["cellpose_sam"], **PROGRAM})
    mp.setenv("TMPDIR", str(tmp_path_factory.mktemp("tmp")))
    path = str(tmp_path_factory.mktemp("weights") / "cellpose.tar")
    mp.setattr(cellpose_recipe, "ensure_weights", lambda cfg, log=None: path)
    trained = []

    def make(seed=7, seconds=0.5, trace=False):
        bench = common.load_json("BENCHMARK.json")
        cell = common.load_json("benchmark", "workloads",
                                "tile_cellpose_sam.json")
        cfg = common.load_json("benchmark", "configs", "cellpose_sam_he.json")
        cfg.update(TINY, batch_size=4)
        cfg["recipe"].update(RECIPE)
        cell.update(SMALL)
        if not trained:
            trained.append(cellpose_recipe.train(cfg, path, device="cpu",
                                                 steps=2))
        return common.Context(seed=seed, seconds=seconds, trace=trace,
                              cell=cell, cfg=cfg, bench=bench,
                              t0=time.perf_counter(), device="cpu")

    make.trained = trained
    yield make
    mp.undo()


def test_files_are_read():
    """The configuration and both cells' files are read as the run reads
    them: every width as published, nothing reduced; the cells' kinds
    have their traffic modules."""
    bench = common.load_json("BENCHMARK.json")
    cfg = common.load_json("benchmark", "configs", "cellpose_sam_he.json")
    assert cfg["reduced"] == [] and cfg["nr_types"] is None
    assert {k: cfg[k] for k in ref_cp.SAM_L} == ref_cp.SAM_L
    assert (cfg["patch_input"], cfg["patch_output"]) == (256, 224)
    cells = {w["name"]: w for w in bench["workloads"]}
    for name, kind, chips in (("tile_cellpose_sam", "tile_cellpose", 1),
                              ("wsi_fast_pannuke_4chip", "wsi_4chip", 4)):
        cell = common.load_json("benchmark", "workloads", f"{name}.json")
        assert cell["kind"] == cells[name]["traffic"] == kind
        assert cells[name]["chips"] == chips
        e2e, per_layer = run.cell_metrics(bench, name)
        assert "setup_s" in {m["name"] for m in e2e} and per_layer
    _, per_layer = run.cell_metrics(bench, "tile_cellpose_sam")
    assert {"global_attn_ms.tile", "attn_roofline_pct.tile",
            "flow_follow_ms.tile", "flow_masks_ms.tile",
            "flow_tables_ms.tile", "forward_ms.tile",
            "mfu_pct.tile"} <= {m["name"] for m in per_layer}
    assert "post_proc_ms.tile" not in {m["name"] for m in per_layer}
    _, per_layer = run.cell_metrics(bench, "wsi_fast_pannuke_4chip")
    names = {m["name"] for m in per_layer}
    assert "mfu_pct.wsi" not in names and "device_idle_pct.wsi" not in names
    assert "device_idle_pct.wsi_mesh" in names


def test_reference_dynamics_equal_the_programs_on_a_painted_tile():
    """A painted tile's nuclei through their own flows: Cellpose's code as
    the reference writes it and the program's dynamics give the same
    masks up to their ids, and the same counts."""
    from benchmark.reference.paint import paint_tile

    _, inst, _ = paint_tile(300, 300, 60, 21, None, with_labels=True)
    mu = ref_cp.masks_to_flows_gpu(inst.astype(np.int64))
    fmap = np.concatenate([5 * mu, np.where(inst > 0, 4.0, -4.0)[None]]
                          ).transpose(1, 2, 0).astype(np.float32)
    want, counts = ref_cp.masks_of_map(fmap)
    got, pc = flow_dynamics.compute_masks(
        torch.from_numpy(fmap).permute(2, 0, 1))
    got = got.numpy()
    pairs = set(zip(want.ravel().tolist(), got.ravel().tolist()))
    assert len(pairs) == len(np.unique(want)) == len(np.unique(got)) > 40
    assert {k: int(v) for k, v in pc.items()} == counts


def test_sound_run_and_planted_fault(tiny_cell, monkeypatch):
    """A run at test size: its line's keys, `correct` under limits that
    pass it; with one mask in 20 dropped from the json (the planted fault
    of `benchmark.control`), `pp_miss` reads it and `correct` is false."""
    from hover_net_tpu_torch.infer import base, steps

    monkeypatch.setattr(steps, "infer_output", dark_flows(steps.infer_output))
    tempfile.tempdir = None
    sound = run.execute(tiny_cell(seed=11))
    assert set(sound) == {"correct", "attempted", "failed", "metrics",
                          "device", "checks"}
    assert sound["failed"] == 0 and sound["attempted"] > 0
    assert set(sound["checks"]) == {"map_err", "pp_miss", "pp_extra"}
    assert set(sound["metrics"]) == {"setup_s", "tiles_per_s"}
    assert sound["checks"]["pp_miss"]["value"] == 0
    assert sound["checks"]["pp_extra"]["value"] == 0
    limits = {"map_err": 1.5 * sound["checks"]["map_err"]["value"],
              "pp_miss": 0.025, "pp_extra": 0.005}
    ctx = tiny_cell(seed=11)
    ctx.cell["limits"] = limits
    assert run.execute(ctx)["correct"]
    monkeypatch.setattr(base, "save_json", base.save_json)
    control.drop_nuclei(every=5)
    ctx = tiny_cell(seed=11)
    ctx.cell["limits"] = limits
    broken = run.execute(ctx)
    assert not broken["correct"]
    assert broken["checks"]["pp_miss"]["value"] > 0.1
    assert broken["checks"]["pp_extra"]["value"] == 0


def test_fault_that_keeps_masks(tiny_cell, monkeypatch):
    """Where the net's flows of some masks are bad, the sound program drops
    them as the reference's dynamics do (`pp_extra` 0); with its
    flow-error check left out (`--fault skip_flow_error`) its json keeps
    them, which `pp_extra` reads and `pp_miss` cannot, and `correct` is
    false."""
    from hover_net_tpu_torch.infer import steps

    monkeypatch.setattr(steps, "infer_output",
                        dark_flows(steps.infer_output, bad=True))
    monkeypatch.setattr(flow_dynamics, "remove_bad_flow_masks",
                        flow_dynamics.remove_bad_flow_masks)
    tempfile.tempdir = None
    limits = {"map_err": 1e9, "pp_miss": 0.025, "pp_extra": 0.005}
    ctx = tiny_cell(seed=11)
    ctx.cell["limits"] = limits
    sound = run.execute(ctx)
    assert sound["correct"]
    assert sound["checks"]["pp_extra"]["value"] == 0
    tile_cellpose.skip_flow_error()
    ctx = tiny_cell(seed=11)
    ctx.cell["limits"] = limits
    broken = run.execute(ctx)
    assert not broken["correct"]
    assert broken["checks"]["pp_extra"]["value"] > 0.05
    assert broken["checks"]["pp_miss"]["value"] == 0


def test_fp8_control_is_not_correct(tiny_cell):
    """The fp8 control reads a larger map gap than the bf16 witness on the
    tiles a run of the seed checks; under a limit above the witness it
    reads `correct` false."""
    tempfile.tempdir = None
    ctx = tiny_cell(seed=5)
    wts = tile_cellpose.weights(ctx)
    fp8 = tile_cellpose.control_checks(ctx, wts)
    bf16 = tile_cellpose.control_checks(tiny_cell(seed=5), wts, "bf16")
    assert set(fp8) == {"map_err"}
    assert 0 < bf16["map_err"][0] < fp8["map_err"][0]
    limit = 2 * bf16["map_err"][0]
    assert fp8["map_err"][0] > limit
    assert not run.judge({"map_err": [fp8["map_err"][0], limit]})


def test_trace_run_facts(tiny_cell):
    """A traced run's facts carry the tile keys and the FLOPs of a tile's
    blocks and of their attention; on the CPU no CUDA event times the
    stages, so their readers find nothing."""
    tempfile.tempdir = None
    ctx = tiny_cell(seed=3, seconds=2, trace=True)
    out = tile_cellpose.run(ctx)
    ctx.cleanup()
    facts = out["facts"]
    assert {"timings", "trace", "tiles", "flops_per_tile",
            "attn_flops_per_tile"} <= set(facts)
    assert 0 < facts["attn_flops_per_tile"] < facts["flops_per_tile"]
    assert all("n_seeds" in t for t in facts["timings"])
    res = run.assemble(ctx, out)
    assert "mfu_pct.tile" in res["metrics"]
    for name in ("forward_ms.tile", "global_attn_ms.tile",
                 "flow_follow_ms.tile", "flow_masks_ms.tile",
                 "flow_tables_ms.tile", "attn_roofline_pct.tile"):
        assert run.read_metric(name, facts) is None


def test_metric_readers():
    """The new readers on timings as a card's run writes them."""
    facts = {"attn_flops_per_tile": 4.0e12,
             "timings": [{"global_attn": 30.0, "flow_follow": 4.0,
                          "flow_masks": 2.0, "flow_error": 3.0,
                          "tables": 9.0},
                         {"global_attn": 50.0, "flow_follow": 6.0,
                          "flow_masks": 2.0, "flow_error": 1.0,
                          "tables": 11.0}]}
    assert run.read_metric("global_attn_ms.tile", facts) == 40.0
    assert run.read_metric("flow_follow_ms.tile", facts) == 5.0
    assert run.read_metric("flow_masks_ms.tile", facts) == 4.0
    assert run.read_metric("flow_tables_ms.tile", facts) == 10.0
    # HoVer-Net's tiles have a `tables` stage too, and no flow stages
    assert run.read_metric("flow_tables_ms.tile", {"timings": [
        {"forward": 1.0, "tables": 5.0}]}) is None
    assert run.read_metric("attn_roofline_pct.tile", facts) == \
        pytest.approx(100 * 4.0e12 / 0.040 / 989e12)


def test_flops_at_the_published_size():
    """One 256^2 block through Cellpose-SAM: ~0.73 TFLOP, of it ~0.31 in
    the attention modules (qkv through proj)."""
    cfg = common.load_json("benchmark", "configs", "cellpose_sam_he.json")
    total, attn = tile_cellpose.block_flops(json.dumps(cfg, sort_keys=True))
    assert 0.70e12 < total < 0.76e12
    assert 0.30e12 < attn < 0.33e12


def test_program_without_the_mode_fails_at_once(monkeypatch, tiny_cell):
    """A program without `--model_mode cellpose_sam` (the parent of the
    change that adds it) exits before any training or painting."""
    import hover_net_tpu_torch.models.zoo as zoo

    monkeypatch.setattr(zoo, "MODES", ("fast", "original", "cellvit_sam_h"))
    ctx = tiny_cell()
    with pytest.raises(SystemExit, match="cellpose_sam"):
        tile_cellpose.run(ctx)
    assert ctx.work is None


def test_four_slot_slide_cell(small_cell, monkeypatch):
    """`wsi_fast_pannuke_4chip` at test size on four CPU slots: the striped
    path runs, the check reads the slide's map from the stripes' core
    rows and is `correct` under the cell's limits scaled as the other
    slide cells' tests scale them; the line counts four slots."""
    tempfile.tempdir = None
    bench = common.load_json("BENCHMARK.json")
    cell = common.load_json("benchmark", "workloads",
                            "wsi_fast_pannuke_4chip.json")
    cfg = common.load_json("benchmark", "configs",
                           "hovernet_fast_pannuke.json")
    cfg.update(width=8, batch_size=4)
    cell.update(slides=1, slide_size=1200, chunk_shape=1000, tile_shape=512,
                ambiguous_size=32, warm_size=600, check_regions=2,
                check_region=256, margin=16, trace_slide=1)
    small_cell("wsi_fast_pannuke")  # the recipe's tiny weights
    ctx = common.Context(seed=9, seconds=0.5, trace=False, cell=cell,
                         cfg=cfg, bench=bench, t0=time.perf_counter(),
                         device="cpu")
    out = wsi_4chip.run(ctx)
    ctx.cleanup()
    assert out["failed"] == 0 and out["attempted"] >= 1
    assert out["device"]["count"] == 1  # four slots of the one CPU
    assert set(out["checks"]) == {"map_err", "type_err", "pp_miss"}
    assert out["checks"]["pp_miss"][0] == 0


def test_idle_share_of_each_card():
    """Each card's busy seconds from a chrome trace's device events (the
    card from `args.device`, else `pid`), clipped to the stretch mark and
    merged where a card's streams overlap; the reader's mean of the
    cards' idle shares, and nothing without cards (the parent's trace, a
    CPU run)."""
    from benchmark.trace import MARK

    ev = [{"ph": "X", "name": MARK, "ts": 1000.0, "dur": 1000.0},
          {"ph": "X", "cat": "kernel", "name": "k", "ts": 900.0,
           "dur": 300.0, "args": {"device": 0}},
          {"ph": "X", "cat": "kernel", "name": "k", "ts": 1100.0,
           "dur": 300.0, "args": {"device": 0, "stream": 9}},
          {"ph": "X", "cat": "gpu_memcpy", "name": "c", "ts": 1500.0,
           "dur": 100.0, "pid": 2},
          {"ph": "X", "cat": "cpu_op", "name": "h", "ts": 1000.0,
           "dur": 900.0, "pid": 1}]
    busy = wsi_4chip.busy_by_card(ev, range(4))
    assert busy == pytest.approx({"0": 4e-4, "1": 0.0, "2": 1e-4,
                                  "3": 0.0})
    facts = {"trace": {"window_s": 1e-3, "busy_s_by_card": busy}}
    assert run.read_metric("device_idle_pct.wsi_mesh", facts) == \
        pytest.approx(100 * (0.6 + 1 + 0.9 + 1) / 4)
    assert run.read_metric("device_idle_pct.wsi_mesh", {"trace": {
        "window_s": 1e-3, "busy_s": 5e-4}}) is None


def test_stripe_crop_reads_core_rows():
    """Two stripes of 4 core rows and 2 landing rows each: a box over the
    border reads each card's core rows."""
    full = torch.arange(8 * 3, dtype=torch.float32).reshape(8, 3, 1)
    halo, s_rows = 2, 4
    stripes = []
    for d in range(2):
        buf = torch.full((s_rows + 2 * halo, 3, 1), -1.0)
        buf[halo:halo + s_rows] = full[d * s_rows:(d + 1) * s_rows]
        stripes.append(buf)
    got = wsi_4chip.stripe_crop(stripes, (s_rows, halo), 2, 1, 5, 2)
    assert np.array_equal(got, full[2:7, 1:3].numpy())


def test_recipe_left_out_of_setup(tiny_cell, monkeypatch):
    ctx = tiny_cell()
    cached = cellpose_recipe.ensure_weights

    def training(cfg, log=None):
        time.sleep(1.2)
        return cached(cfg)

    monkeypatch.setattr(cellpose_recipe, "ensure_weights", training)
    before = ctx.elapsed()
    tile_cellpose.weights(ctx)
    assert ctx.elapsed() - before < 0.5 and ctx.excluded_s >= 1.2
    assert recipe.ensure_weights is not training
