"""The port's recipe checkpoint (hover_net_tpu_torch/cli/recipe.py) and
the CLIs that share it (bench_train, probe_device_time,
fused_encoder_drift, parity_drift_sweep) on the CPU, against the JAX
package's code where there is some:

- `synth_nuclei_image` and `synth_pred_map` equal bench.py's, array for
  array;
- the checkpoint recipe's first batches equal those bench.py:86-101 draws
  from the same rng (bench.synth_nuclei_image and the JAX gen_targets);
  a 3-step width-8 recipe writes a `.tar` that the port's tile manager
  loads and that `jax_from_state_dict` carries to the variables the JAX
  package's own `.tar` loader reads; a second call hits the cache;
- cli.bench_train's float32 parameters with a bf16 body and float32
  heads; the prefix cuts of cli.probe_device_time equal the full model's
  intermediates, exactly in float32; the drift CLIs' AJI equals the JAX
  `get_fast_aji` to 1e-12;
- each CLI's `main` on `--device cpu` prints one parseable JSON line
  last.

The weights of the drift CLIs' cases are a seeded width-8 init whose np
head is a constant foreground (as tests/test_torch_tile.py makes them),
so the instances are cut by the hv maps of the random net.
"""

import json
import os

import numpy as np
import pytest
import torch

import bench as jax_bench
from hover_net_tpu_torch.cli import (
    bench_train,
    fused_encoder_drift,
    parity_drift_sweep,
    probe_device_time,
    recipe,
)
from hover_net_tpu_torch.models.checkpoints import (
    jax_from_state_dict,
    load_torch_tar,
)
from hover_net_tpu_torch.models.hovernet import HoVerNet, HoVerNetConfig

WIDTH = 8


def forced_foreground_state(seed=3, nr_types=None):
    """A seeded width-8 state dict of the port with a constant-foreground
    np head."""
    net = HoVerNet(HoVerNetConfig(mode="fast", nr_types=nr_types, width=WIDTH),
                   generator=torch.Generator().manual_seed(seed))
    state = net.state_dict()
    state["decoder.np.u0.conv.weight"].zero_()
    state["decoder.np.u0.conv.bias"].copy_(torch.tensor([-2.0, 2.0]))
    return state


@pytest.fixture(scope="module")
def forced_tar(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("forced") / "m.tar")
    torch.save({"desc": forced_foreground_state()}, path)
    return path


@pytest.fixture(scope="module")
def cached_recipe(tmp_path_factory):
    """(cache dir, path) of a 3-step width-8 recipe checkpoint on the CPU."""
    d = str(tmp_path_factory.mktemp("recipe"))
    kw = dict(steps=3, batch=2, width=WIDTH, device="cpu", ckpt_dir=d)
    return kw, recipe.train_e2e_checkpoint(**kw)


# ------------------------------------------------------- synthetic data

@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("fn", ["synth_nuclei_image", "synth_pred_map"])
def test_synthetic_data_equals_bench(fn, seed):
    kw = (dict(seed=seed, n_nuclei=60) if fn == "synth_nuclei_image"
          else dict(n_nuclei=60, seed=seed))
    want = getattr(jax_bench, fn)(200, 180, **kw)
    got = getattr(recipe, fn)(200, 180, **kw)
    for w, g in zip(want if isinstance(want, tuple) else (want,),
                    got if isinstance(got, tuple) else (got,)):
        assert g.dtype == w.dtype
        np.testing.assert_array_equal(g, w)


# ------------------------------------------------------- the recipe

def jax_recipe_batches(rng, batch, n):
    """bench.py:86-101's `make_batch`, with numpy in place of jnp."""
    from hover_net_tpu.ops.targets import gen_targets

    out = []
    for _ in range(n):
        imgs, nps, hvs = [], [], []
        for _ in range(batch):
            img, inst = jax_bench.synth_nuclei_image(
                256, 256, seed=int(rng.integers(1 << 30)), n_nuclei=70)
            t = gen_targets(inst, (164, 164))
            imgs.append(img.astype(np.float32))
            nps.append(t["np_map"].astype(np.int32))
            hvs.append(t["hv_map"].astype(np.float32))
        out.append({"img": np.stack(imgs), "np_map": np.stack(nps),
                    "hv_map": np.stack(hvs)})
    return out


def test_recipe_batches_equal_bench_code():
    want = jax_recipe_batches(np.random.default_rng(0), 2, 3)
    gen = recipe.recipe_batches(np.random.default_rng(0), 2)
    for w in want:
        got = next(gen)
        assert got.keys() == w.keys()
        for k in w:
            assert got[k].dtype == w[k].dtype
            np.testing.assert_array_equal(got[k], w[k])


def test_typed_recipe_batches_draw_types_per_instance():
    b = next(recipe.recipe_batches(np.random.default_rng(0), 2, nr_types=5))
    assert b["tp_map"].shape == b["np_map"].shape == (2, 164, 164)
    assert set(np.unique(b["tp_map"])) <= {0, 1, 2, 3, 4}
    np.testing.assert_array_equal(b["tp_map"] > 0, b["np_map"] > 0)
    assert len(np.unique(b["tp_map"])) == 5


@pytest.mark.parametrize("nr_types, guess", [(None, 71), (5, 71), (5, 1)],
                         ids=["untyped", "typed", "typed-every-guess-wrong"])
def test_pooled_recipe_batches_equal_recipe_batches(nr_types, guess):
    """The recipe's batches drawn by worker processes are
    `recipe_batches`' array for array; with types, also when every batch
    drawn ahead has to be drawn again (a wrong guess of the types a
    tile draws)."""
    from hover_net_tpu_torch.data.synthetic import pooled_recipe_batches

    gen = recipe.recipe_batches(np.random.default_rng(3), 3, nr_types)
    host_s = []
    got = list(pooled_recipe_batches(3, 3, 4, nr_types, workers=2, ahead=3,
                                     guess=guess, host_s=host_s))
    assert len(got) == 4 and len(host_s) == 4
    for g in got:
        w = next(gen)
        assert g.keys() == w.keys()
        for k in w:
            assert g[k].dtype == w[k].dtype
            np.testing.assert_array_equal(g[k], w[k])


def test_recipe_checkpoint_loads_in_both_packages(cached_recipe):
    from hover_net_tpu.models import HoVerNetConfig as JaxConfig
    from hover_net_tpu.models.checkpoints import load_torch_tar as jax_load

    from hover_net_tpu_torch.infer.tile import TileInferManager

    _, path = cached_recipe
    mgr = TileInferManager(model_path=path, width=WIDTH,
                           dtype=torch.float32, device="cpu")
    state = load_torch_tar(path)
    assert recipe.state_sha256(mgr.model.state_dict()) == \
        recipe.state_sha256(state)
    cfg = HoVerNetConfig(mode="fast", nr_types=None, width=WIDTH)
    carried = jax_from_state_dict(state, cfg)
    want = jax_load(path, JaxConfig(mode="fast", nr_types=None, width=WIDTH))
    for col in ("params", "batch_stats"):
        flat_w = _flatten(want[col])
        flat_g = _flatten(carried[col])
        assert flat_g.keys() == flat_w.keys()
        for k, v in flat_w.items():
            np.testing.assert_array_equal(flat_g[k], np.asarray(v))


def _flatten(tree, prefix=()):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(_flatten(v, prefix + (k,)))
        else:
            out[prefix + (k,)] = v
    return out


def no_training(*a, **k):
    raise AssertionError("the cached recipe was trained again")


def test_recipe_checkpoint_is_cached(cached_recipe, monkeypatch):
    kw, path = cached_recipe
    monkeypatch.setattr(recipe, "make_train_step", no_training)
    assert recipe.train_e2e_checkpoint(**kw) == path
    # another recipe is another file
    with pytest.raises(AssertionError, match="trained again"):
        recipe.train_e2e_checkpoint(**dict(kw, steps=4))


def test_recipe_cache_key_covers_the_training_code(cached_recipe, monkeypatch):
    """The key hashes the files of the code the recipe runs: an edit to
    one of them trains anew."""
    import sys

    from hover_net_tpu_torch.data import synthetic
    from hover_net_tpu_torch.models import blocks
    from hover_net_tpu_torch.ops import losses, targets
    from hover_net_tpu_torch.utils import crops

    pkg = os.path.dirname(os.path.dirname(recipe.__file__))
    used = [sys.modules[f.__module__].__file__ for f in (
        recipe.train_e2e_checkpoint, recipe.make_train_step, HoVerNet,
        blocks.ResidualBlock, losses.hovernet_loss, targets.gen_targets,
        recipe.device_prefetch, recipe.save_train_tar, crops.cropping_center,
        synthetic.pooled_recipe_batches)]
    assert {os.path.relpath(f, pkg) for f in used} == set(recipe.RECIPE_SOURCES)

    kw, path = cached_recipe
    monkeypatch.setattr(recipe, "recipe_sources_sha256", lambda: "edited")
    monkeypatch.setattr(recipe, "make_train_step", no_training)
    with pytest.raises(AssertionError, match="trained again"):
        recipe.train_e2e_checkpoint(**kw)


# ------------------------------------------------------- training

def record_outputs(modules):
    """{name: the module's output in its first forward} (hooks that keep
    the output and return nothing, so the forward is unchanged)."""
    seen = {}

    def hook(name):
        def keep(_m, _inp, out):
            seen.setdefault(name, out)
        return keep

    for name, m in modules.items():
        m.register_forward_hook(hook(name))
    return seen


def test_bench_trainer_keeps_float32_parameters_with_a_bf16_body():
    state, step = bench_train.bf16_trainer(WIDTH, torch.device("cpu"))
    net = state.model
    seen = record_outputs({"d0": net.d0, "head": net.decoder["np"].u0})
    batch = {k: torch.from_numpy(v) for k, v in next(recipe.recipe_batches(
        np.random.default_rng(0), 2)).items()}
    _, (terms, _) = step(state, batch)
    assert {k: v.dtype for k, v in seen.items()} == {
        "d0": torch.bfloat16, "head": torch.float32}
    assert {p.dtype for p in net.parameters()} == {torch.float32}
    exp_avg = [s["exp_avg"].dtype for s in state.optimizer.state.values()]
    assert exp_avg and set(exp_avg) == {torch.float32}
    assert torch.isfinite(terms["overall_loss"])


# ------------------------------------------------------- forward split

@pytest.mark.parametrize("cut", probe_device_time.CUTS)
def test_prefix_cuts_equal_full_model_intermediates(cut):
    torch.manual_seed(0)
    net = HoVerNet(HoVerNetConfig(mode="fast", nr_types=None, width=WIDTH),
                   generator=torch.Generator().manual_seed(1)).eval()
    x = torch.randint(0, 256, (2, 3, 256, 256), dtype=torch.uint8)
    first = list(net.decoder)[0]
    seen = record_outputs({"d0": net.d0, "enc": net.conv_bot,
                           "dec1": net.decoder[first]})
    with torch.no_grad():
        out = net(x)
        got = probe_device_time.prefix_forward(net, x, cut)
    seen["full"] = torch.cat(list(out.values()), dim=1)
    assert got.dtype == torch.float32
    assert torch.equal(got, seen[cut])


@pytest.mark.parametrize("size", [164, 200, 1000])
def test_canonical_grid_tiles_the_canvas(size):
    """The probe's patches: a row-major grid of top-left corners a step
    apart whose outputs cover the source, in a canvas one patch margin
    wider than the outputs."""
    from hover_net_tpu_torch.data.tiling import prepare_tile_patching

    win, step = 256, 164
    coords, (rows, cols), canvas = probe_device_time.canonical_grid(
        size, win, step)
    exact = prepare_tile_patching((size, size), win, step)[2]
    assert rows >= exact[0] and cols >= exact[1]
    assert rows * step >= size and canvas == rows * step + win - step
    want = [(y * step, x * step) for y in range(rows) for x in range(cols)]
    assert coords.dtype == np.int64
    assert [tuple(c) for c in coords.tolist()] == want
    if size == 1000:
        assert (rows, cols) == (7, 7)


def test_forward_flops_count_each_patch_once():
    net = HoVerNet(HoVerNetConfig(mode="fast", nr_types=None, width=WIDTH))
    one, per_module = probe_device_time.forward_flops(net, 1)
    two, _ = probe_device_time.forward_flops(net, 2)
    assert one > 0 and two == 2 * one and per_module["Global"] == one
    # the count runs on a meta copy: the model keeps its weights
    assert {p.device.type for p in net.parameters()} == {"cpu"}


def test_fill_synthetic_sets_the_timing_weights():
    """Each BatchNorm's scale and running variance 1, every other
    parameter and buffer 0.01, the batch counters left alone."""
    net = probe_device_time.fill_synthetic(
        HoVerNet(HoVerNetConfig(mode="fast", nr_types=None, width=WIDTH)))
    ones = {f"{name}.{k}" for name, m in net.named_modules()
            if hasattr(m, "running_var") for k in ("weight", "running_var")}
    state = net.state_dict()
    assert ones and ones < state.keys()
    for name, t in state.items():
        if name.endswith("num_batches_tracked"):
            assert int(t) == 0, name
        else:
            assert torch.all(t == (1.0 if name in ones else 0.01)), name


# ------------------------------------------------------- drift scoring

@pytest.mark.parametrize("module", [parity_drift_sweep, fused_encoder_drift])
def test_drift_aji_equals_jax_get_fast_aji(module):
    from hover_net_tpu.metrics.stats import get_fast_aji, remap_label

    rng = np.random.default_rng(4)
    for _ in range(5):
        a = rng.integers(0, 12, (60, 50)) * 3  # ids with gaps
        b = np.where(rng.random((60, 50)) < 0.8, a, rng.integers(0, 12,
                                                                 (60, 50)))
        want = float(get_fast_aji(remap_label(a), remap_label(b)))
        assert abs(module.pair_aji(a, b) - want) <= 1e-12
    empty = np.zeros((8, 8), np.int32)
    assert module.pair_aji(empty, empty) == 1.0
    assert module.pair_aji(empty, np.ones_like(empty)) == 0.0


def test_fused_encoder_drift_counts_its_k3_launches(forced_tar, capsys):
    """One forward batch a tile in each pass; on the CPU the gate keeps
    the standard forward, so the fused passes launch no K3."""
    out = fused_encoder_drift.main(["--device", "cpu", "--width", str(WIDTH),
                                    "--size", "200", "--n", "2",
                                    "--model_path", forced_tar])
    capsys.readouterr()
    assert out["fused_forward_batches"] == 2
    assert out["k3_launches"] == 0
    assert out["fused_vs_standard"]["aji_min"] == 1.0


# ------------------------------------------------------- the CLIs' lines

def cli_cases():
    """(name, main, argv(tmp dir, tar)) of each CLI's CPU run."""
    small = ["--device", "cpu", "--width", str(WIDTH)]
    return [
        ("bench_train", bench_train.main, lambda t, tar: small + [
            "--batch", "2", "--steps", "2"]),
        ("bench_train --loader_only", bench_train.main, lambda t, tar: small + [
            "--loader_only", "--workers", "0", "--n_patches", "4", "--batch",
            "2", "--workdir", t]),
        ("probe_device_time", probe_device_time.main, lambda t, tar: small + [
            "--size", "200", "--reps", "1", "--batch", "2", "--split",
            "forward"]),
        ("fused_encoder_drift", fused_encoder_drift.main,
         lambda t, tar: small + ["--size", "200", "--n", "1",
                                 "--model_path", tar]),
        ("parity_drift_sweep", parity_drift_sweep.main,
         lambda t, tar: small + ["--size", "200", "--n", "1", "--model_path",
                                 tar, "--csv", os.path.join(t, "p.csv")]),
    ]


@pytest.mark.parametrize("name,main,argv", cli_cases(),
                         ids=[c[0] for c in cli_cases()])
def test_main_prints_one_json_line_last(name, main, argv, forced_tar,
                                        tmp_path, capsys):
    out = main(argv(str(tmp_path), forced_tar))
    last = capsys.readouterr().out.strip().splitlines()[-1]
    assert json.loads(last) == json.loads(json.dumps(out))
    assert out["device"] == "cpu"
    assert out["card"].startswith("cpu")
