"""The port's spans and layer timings (runtime.span and the managers'
`timings`), the benchmark's readers of them, and the WSI manager's
tissue table over several slides. CPU tests, and one card test marked
`gpu`, which skips without a CUDA device.

This file imports no jax, so its card test runs on a machine without it:
  python -m pytest --noconftest -m gpu tests/test_torch_spans.py
"""

import importlib.util
import os

import cv2
import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from hover_net_tpu_torch.infer import steps
from hover_net_tpu_torch.infer.tile import TileInferManager
from hover_net_tpu_torch.infer.wsi import WSIInferManager
from hover_net_tpu_torch.models.hovernet import HoVerNet, HoVerNetConfig
from hover_net_tpu_torch.parallel import train_parallel as tp
from hover_net_tpu_torch.runtime import span

# several test workers share the host's cores
torch.set_num_threads(1)

WIDTH = 8
METRICS = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "benchmark", "metrics")


def profiled_names(fn):
    """The names of the host events a CPU torch.profiler records while
    `fn()` runs."""
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return {e.name for e in prof.events()}


# ------------------------------------------------------------ the helper

def test_span_adds_host_seconds_across_repeated_and_nested_spans():
    times = {}
    for _ in range(3):
        with span("hnt.test.outer", times, "outer"):
            with span("hnt.test.inner", times, "inner"):
                pass
            with span("hnt.test.inner", times, "inner"):
                pass
    assert set(times) == {"outer", "inner"}
    assert times["outer"] >= times["inner"] > 0
    before = dict(times)
    with span("hnt.test.outer", times, "outer"):
        pass
    assert times["outer"] > before["outer"]
    assert times["inner"] == before["inner"]


def test_span_adds_on_exception_and_reraises():
    times = {"k": 1.0}
    with pytest.raises(KeyError):
        with span("hnt.test.raises", times, "k"):
            raise KeyError("x")
    assert times["k"] > 1.0
    with span("hnt.test.untimed"):  # no dict: a range only
        pass


def test_span_name_in_cpu_profiler_trace():
    times = {}

    def body():
        with span("hnt.test.traced", times, "traced"):
            torch.ones(4).sum()

    assert "hnt.test.traced" in profiled_names(body)
    assert times["traced"] > 0
    # with no profiler running the span opens no range, and still times
    with span("hnt.test.quiet", times, "quiet"):
        pass
    assert times["quiet"] > 0


# ------------------------------------------------------------ inputs

@pytest.fixture(scope="module")
def tar(tmp_path_factory):
    """A width-8 fast untyped checkpoint in the reference `.tar` format."""
    net = HoVerNet(HoVerNetConfig(mode="fast", width=WIDTH),
                   generator=torch.Generator().manual_seed(0))
    path = str(tmp_path_factory.mktemp("spans") / "w8.tar")
    torch.save({"desc": net.state_dict()}, path)
    return path


def nuclei_image(shape, seed, n=25):
    rng = np.random.default_rng(seed)
    img = np.full(shape + (3,), 230, np.uint8)
    yy, xx = np.mgrid[:shape[0], :shape[1]]
    for _ in range(n):
        cy, cx = rng.integers(10, np.array(shape) - 10)
        r = int(rng.integers(4, 8))
        img[(yy - cy) ** 2 + (xx - cx) ** 2 <= r * r] = (130, 80, 150)
    return img


# ------------------------------------------------------------ tile path

def test_tile_run_writes_read_and_dispatch_ms(tar, tmp_path):
    src = tmp_path / "in"
    os.makedirs(src)
    for k in range(2):
        cv2.imwrite(str(src / f"t{k}.png"), nuclei_image((300, 340), k))
    mgr = TileInferManager(model_path=tar, mode="fast", width=WIDTH,
                           dtype=torch.float32, batch_size=8, device="cpu")
    assert mgr.process_file_list(str(src), str(tmp_path / "out"),
                                 save_format="json") == 2
    assert [t["name"] for t in mgr.timings] == ["t0", "t1"]
    for t in mgr.timings:
        assert t["read_ms"] > 0 and t["dispatch_ms"] > 0
        assert t["finalize_ms"] > 0
        # no CUDA events on the CPU
        assert not set(steps.STAGES + ("encoder", "decoders")) & set(t)


def test_encode_decode_is_the_forward_and_cpu_events_record_nothing():
    net = HoVerNet(HoVerNetConfig(mode="fast", nr_types=4, width=WIDTH),
                   generator=torch.Generator().manual_seed(1)).eval()
    x = torch.from_numpy(np.random.default_rng(0).integers(
        0, 255, (2, 256, 256, 3), dtype=np.uint8))
    events = steps.StageEvents(torch.device("cpu"))
    with torch.no_grad():
        want = net(x.permute(0, 3, 1, 2))
        got = net.decode(net.encode(x.permute(0, 3, 1, 2)))
        out = steps.forward_batches(net, x, 0, events)
        plain = steps.infer_output(net, x)
    assert all(torch.equal(want[k], got[k]) for k in want)
    assert torch.equal(out, plain)
    assert events.ms() == {} and not events.stages and not events.parts


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (K1 and CUDA events)")
    return torch.device("cuda")


@pytest.mark.gpu
def test_stage_events_travel_with_each_call(cuda, tar, monkeypatch):
    """Two tiles dispatched before either is read keep their own events,
    and the dispatch returns before the tile's `tables` event fires (a
    device sleep is queued at the end of the tables stage, after its
    boundary compaction's host read)."""
    real = steps.tables_tail

    def slow_tables(*args):
        out = real(*args)
        torch.cuda._sleep(int(4e8))  # ~0.2 s of device time
        return out

    monkeypatch.setattr(steps, "tables_tail", slow_tables)
    mgr = TileInferManager(model_path=tar, mode="fast", width=WIDTH,
                           batch_size=8, device="cuda")
    imgs = [nuclei_image((500, 500), k) for k in range(2)]
    mgr.predict_image_async(imgs[0])[1].ms()  # warm-up, K1 built
    times = {}
    first = mgr.predict_image_async(imgs[0], times=times)
    assert not first[1].stages[-1][1].query()  # tables still queued
    second = mgr.predict_image_async(imgs[1])
    assert times["dispatch"] > 0
    split = [ev.ms() for _, ev in (first, second)]
    for ms in split:
        assert set(ms) == set(steps.STAGES) | {"encoder", "decoders"}
        assert ms["tables"] > 100  # the sleep is in this call's stage
        assert 0 < ms["encoder"] + ms["decoders"] <= ms["forward"]
    for img, (out, _) in zip(imgs, (first, second)):
        mgr.finalize_prediction(img, out)


# ------------------------------------------------------------ WSI path

def test_wsi_slides_write_their_spans(tar, tmp_path):
    """One manager over two slides: the chunk wait and the
    post-processing's extraction and callbacks on each, the model's build
    on the first only."""
    src, masks = tmp_path / "in", tmp_path / "mask"
    os.makedirs(src)
    os.makedirs(masks)
    for k in range(2):
        np.save(str(src / f"s{k}.npy"), nuclei_image((500, 420), k, 40))
        cv2.imwrite(str(masks / f"s{k}.png"),
                    np.full((50, 42), 255, np.uint8))
    mgr = WSIInferManager(model_path=tar, mode="fast", width=WIDTH,
                          dtype=torch.float32, batch_size=8, device="cpu",
                          chunk_shape=400, tile_shape=256,
                          ambiguous_size=32, proc_mag=40,
                          cache_path=str(tmp_path / "cache"))
    assert mgr.process_wsi_list(str(src), str(tmp_path / "out"),
                                input_mask_dir=str(masks)) == 2
    first, second = mgr.timings["s0"], mgr.timings["s1"]
    assert first["model_build"] > 0 and "model_build" not in second
    for t in (first, second):
        assert t["chunk_wait"] >= 0
        assert t["pp_extract"] > 0 and t["pp_callback"] >= 0
        phases = sum(t[f"post_proc_phase{k}"] for k in (1, 2, 3))
        assert t["pp_extract"] + t["pp_callback"] <= phases
        assert t["chunk_wait"] <= t["inference"]
        assert "forward_ms" not in t  # CUDA events only


def test_one_manager_selects_each_slide_by_its_own_mask():
    """Two slides of one size with different masks through one manager:
    each slide's patches are selected by its own mask, as a fresh
    manager selects them."""
    shape, mask_shape = (1000, 800), (100, 80)
    top = np.zeros(mask_shape, np.uint8)
    top[:40] = 1
    left = np.zeros(mask_shape, np.uint8)
    left[:, :20] = 1
    ys, xs = np.meshgrid(np.arange(0, 1000, 100), np.arange(0, 800, 100),
                         indexing="ij")
    tl = np.stack([ys.ravel(), xs.ravel()], -1)
    patches = np.stack([np.stack([tl, tl + 100], 1)] * 2, 1)  # [K, 2, 2, 2]

    def select(mgr, mask):
        mgr.wsi_mask = mask.copy()  # a new slide's mask, as read
        mgr.wsi_proc_shape = np.array(shape)
        return mgr._select_masked_patches(patches)

    def fresh(mask):
        return select(WSIInferManager.__new__(WSIInferManager), mask)

    assert len(fresh(top)) == 4 * 8 and len(fresh(left)) == 10 * 2
    one = WSIInferManager.__new__(WSIInferManager)
    for mask in (top, left, top):
        np.testing.assert_array_equal(select(one, mask), fresh(mask))


# ------------------------------------------------------------ train step

def test_train_step_spans_in_profiler_trace():
    model = HoVerNet(HoVerNetConfig(mode="fast", nr_types=5, width=WIDTH),
                     generator=torch.Generator().manual_seed(0))
    tx, schedule = tp.make_optimizer(steps_per_epoch=10)
    state = tp.init_train_state(model, tx, "cpu")
    batch = {k: torch.from_numpy(v)
             for k, v in tp._dryrun_batch(2).items()}
    step = tp.make_train_step(model, schedule)
    names = profiled_names(lambda: step(state, batch))
    assert {"hnt.train.forward", "hnt.train.loss", "hnt.train.backward",
            "hnt.train.optimizer"} <= names
    assert state.step == 1


# ------------------------------------------------------------ readers

def reader(name):
    spec = importlib.util.spec_from_file_location(
        f"reader_{name.replace('.', '_')}",
        os.path.join(METRICS, f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


TILE_READERS = {"read_ms.tile": "read_ms", "dispatch_ms.tile": "dispatch_ms",
                "encoder_ms.tile": "encoder", "decoder_ms.tile": "decoders"}
# metric: (timing key, ms per unit of the key)
WSI_READERS = {"chunk_wait_ms_per_mpx.wsi": ("chunk_wait", 1e3),
               "forward_ms_per_mpx.wsi": ("forward_ms", 1.0),
               "pp_extract_ms_per_mpx.wsi": ("pp_extract", 1e3),
               "pp_callback_ms_per_mpx.wsi": ("pp_callback", 1e3),
               "model_build_ms_per_mpx.wsi": ("model_build", 1e3)}


@pytest.mark.parametrize("name", sorted(TILE_READERS))
def test_tile_reader(name):
    read, key = reader(name), TILE_READERS[name]
    timings = [{key: 2.0, "forward": 9.0}, {key: 4.0}, {"name": "host"}]
    assert read({"timings": timings}) == pytest.approx(3.0)
    # the parent's timings lack the key: the metric is absent
    assert read({"timings": [{"forward": 9.0, "finalize_ms": 1.0}]}) is None
    assert read({"timings": []}) is None


@pytest.mark.parametrize("name", sorted(WSI_READERS))
def test_wsi_reader(name):
    read = reader(name)
    key, scale = WSI_READERS[name]
    timings = {"s000": {key: 0.5, "inference": 3.0},
               "s001": {key: 1.5, "inference": 3.0},
               "s002": {"inference": 3.0}}
    assert read({"timings": timings, "mpx": 4.0}) == \
        pytest.approx(2.0 * scale / 4.0)
    assert read({"timings": {"s000": {"inference": 3.0}},
                 "mpx": 4.0}) is None
    assert read({"timings": timings, "mpx": 0.0}) is None
