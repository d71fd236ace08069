"""The CellViT-SAM-H cell (`traffic/wsi_vit.py`) at test size on the CPU: a
tiny CellViT (embedding 64, depth 4, window 3, 80^2 patches to 64^2) in
the configuration and, through `CELLVIT_MODES`, in the program; weights
from two recipe steps on the CPU."""

import json
import tempfile
import time

import pytest

from benchmark import common, run
from benchmark.reference import cellvit_recipe
from benchmark.traffic import wsi_vit

from hover_net_tpu_torch.models import cellvit

TINY = dict(img_size=80, patch_size=16, embed_dim=64, depth=4, num_heads=4,
            mlp_ratio=4.0, window_size=3, global_attn_indexes=[1, 3],
            extract_layers=[1, 2, 3, 4], patch_input=80, patch_output=64)
SMALL = {"slides": 2, "slide_size": 400, "chunk_shape": 1000,
         "tile_shape": 256, "ambiguous_size": 32, "warm_size": 200,
         "check_regions": 2, "check_region": 128, "margin": 16,
         "trace_slide": 1}
RECIPE = {"size": 80, "batch": 2, "nuclei_per_tile": [3, 5],
          "check_size": 80, "check_nuclei": 6, "big_steps": 1,
          "big_batch": 1, "big_nuclei_per_tile": [3, 5]}


@pytest.fixture(scope="module")
def tiny_cell(tmp_path_factory):
    """tiny_cell(seed, seconds, trace) -> a CPU Context of
    `wsi_cellvit_sam_h` at test size."""
    mp = pytest.MonkeyPatch()
    prog = {k: tuple(v) if isinstance(v, list) else v
            for k, v in TINY.items() if k != "img_size"}
    mp.setitem(cellvit.CELLVIT_MODES, "cellvit_sam_h",
               {**cellvit.CELLVIT_MODES["cellvit_sam_h"], **prog})
    mp.setenv("TMPDIR", str(tmp_path_factory.mktemp("tmp")))
    path = str(tmp_path_factory.mktemp("weights") / "cellvit.tar")
    mp.setattr(cellvit_recipe, "ensure_weights", lambda cfg, log=None: path)
    trained = []

    def make(seed=7, seconds=0.5, trace=False):
        bench = common.load_json("BENCHMARK.json")
        cell = common.load_json("benchmark", "workloads",
                                "wsi_cellvit_sam_h.json")
        cfg = common.load_json("benchmark", "configs",
                               "cellvit_sam_h_pannuke.json")
        cfg.update(TINY, batch_size=4)
        cfg["recipe"].update(RECIPE)
        cell.update(SMALL)
        if not trained:
            trained.append(cellvit_recipe.train(cfg, path, device="cpu",
                                                steps=2))
        return common.Context(seed=seed, seconds=seconds, trace=trace,
                              cell=cell, cfg=cfg, bench=bench,
                              t0=time.perf_counter(), device="cpu")

    make.trained = trained
    yield make
    mp.undo()


def test_recipe_checks_and_trains_at_the_check_size(tiny_cell):
    """Two steps cannot find the painted nuclei, so the recipe trains its
    last steps at the check size and checks again."""
    tiny_cell()
    report = tiny_cell.trained[0]
    assert len(report["checks"]) == 2
    assert report["checks"][0]["painted_nuclei"] == RECIPE["check_nuclei"]
    assert len(report["losses"]) == 3


def test_altered_answer_is_not_correct(tiny_cell, monkeypatch):
    import hover_net_tpu_torch.infer.wsi as wsi

    tempfile.tempdir = None
    sound = run.execute(tiny_cell(seed=11))
    assert list(sound) == ["correct", "attempted", "failed", "metrics",
                           "device", "checks"]
    assert sound["failed"] == 0 and sound["attempted"] > 0
    assert set(sound["checks"]) == {"map_err", "type_err", "pp_miss"}
    assert set(sound["metrics"]) == {"setup_s", "wsi_mpx_per_s"}
    limits = {k: 1.5 * v["value"] + 1e-3 for k, v in sound["checks"].items()}
    ctx = tiny_cell(seed=11)
    ctx.cell["limits"] = limits
    assert run.execute(ctx)["correct"]
    real = wsi.infer_output

    def altered(model, imgs):
        out = real(model, imgs).clone()
        out[..., -2:] *= -1
        return out

    monkeypatch.setattr(wsi, "infer_output", altered)
    ctx = tiny_cell(seed=11)
    ctx.cell["limits"] = limits
    broken = run.execute(ctx)
    assert not broken["correct"]
    assert broken["checks"]["map_err"]["value"] > 10 * sound["checks"][
        "map_err"]["value"]


def test_trace_run_facts(tiny_cell):
    """A traced run's facts carry wsi.py's keys and the attention's FLOPs;
    on the CPU no CUDA event times the parts, so their readers find
    nothing and the line leaves them out."""
    tempfile.tempdir = None
    ctx = tiny_cell(seed=3, seconds=2, trace=True)
    out = wsi_vit.run(ctx)
    ctx.cleanup()
    facts = out["facts"]
    assert {"timings", "mpx", "trace", "flops_per_patch", "patches",
            "k1_pixels", "attn_flops_per_patch", "traced_slide"} <= set(facts)
    assert 0 < facts["attn_flops_per_patch"] < facts["flops_per_patch"]
    assert facts["traced_slide"] in facts["timings"]
    res = run.assemble(ctx, out)
    assert "forward_ms_per_mpx.wsi" not in res["metrics"]  # CPU: no events
    assert "inference_ms_per_mpx.wsi" in res["metrics"]
    for name in ("vit_encoder_ms_per_mpx.wsi", "attn_roofline_pct.wsi"):
        assert run.read_metric(name, facts) is None


def test_part_readers():
    """The parts' readers on timings as a card's run writes them."""
    facts = {"mpx": 200.0, "patches": 80, "attn_flops_per_patch": 2.5e12,
             "traced_slide": "s001",
             "timings": {"s000": {"vit_encoder": 1000.0,
                                  "global_attn": 300.0,
                                  "window_attn": 500.0,
                                  "vit_decoder": 600.0},
                         "s001": {"vit_encoder": 1000.0,
                                  "global_attn": 300.0,
                                  "window_attn": 500.0,
                                  "vit_decoder": 600.0}}}
    assert run.read_metric("vit_encoder_ms_per_mpx.wsi", facts) == 10.0
    assert run.read_metric("global_attn_ms_per_mpx.wsi", facts) == 3.0
    assert run.read_metric("window_attn_ms_per_mpx.wsi", facts) == 5.0
    assert run.read_metric("vit_decoder_ms_per_mpx.wsi", facts) == 6.0
    share = run.read_metric("attn_roofline_pct.wsi", facts)
    assert share == pytest.approx(100 * 2.5e12 * 80 / 0.8 / 989e12)


def test_flops_at_the_published_size():
    """One 1024^2 patch through CellViT-SAM-H: 9.82 TFLOP, of them 5.96 in
    the encoder and 2.51 in the attention modules (qkv through proj)."""
    cfg = common.load_json("benchmark", "configs",
                           "cellvit_sam_h_pannuke.json")
    total, attn = wsi_vit.vit_flops(json.dumps(cfg, sort_keys=True), 1024)
    assert total == pytest.approx(9.8168e12, rel=1e-4)
    assert attn == pytest.approx(2.5095e12, rel=1e-4)


def test_control_reads_worse_than_witness(tiny_cell):
    """The fp8 control against the float32 reference reads a larger map
    gap than the bf16 witness, on the regions a run of the seed checks."""
    tempfile.tempdir = None
    ctx = tiny_cell(seed=5)
    fp8 = wsi_vit.control_checks(ctx, wsi_vit.weights(ctx))
    assert set(fp8) == {"map_err", "type_err"}
    ctx = tiny_cell(seed=5)
    bf16 = wsi_vit.control_checks(ctx, wsi_vit.weights(ctx), "bf16")
    assert 0 < bf16["map_err"][0] < fp8["map_err"][0]


def test_program_without_the_mode_fails_at_once(monkeypatch):
    """A program without `--model_mode cellvit_sam_h` (the parent of the
    change that adds it) exits before any training or painting."""
    import hover_net_tpu_torch.models.zoo as zoo

    monkeypatch.setattr(zoo, "MODES", ("fast", "original"))
    with pytest.raises(SystemExit, match="cellvit_sam_h"):
        wsi_vit.ensure_supported("cellvit_sam_h")


def test_recipe_left_out_of_setup(tiny_cell, monkeypatch):
    ctx = tiny_cell()
    cached = cellvit_recipe.ensure_weights

    def training(cfg, log=None):
        time.sleep(1.2)
        return cached(cfg)

    monkeypatch.setattr(cellvit_recipe, "ensure_weights", training)
    before = ctx.elapsed()
    wsi_vit.weights(ctx)
    assert ctx.elapsed() - before < 0.5 and ctx.excluded_s >= 1.2

