"""The port's evaluation CLIs and model summary against the JAX package's,
on the CPU.

- cli/compute_stats in both modes prints what the JAX CLI prints;
- cli/convert_format writes the JAX CLI's `.tsv` files byte for byte,
  typed and untyped;
- utils/summary.model_summary of the torch model gives the JAX summary's
  parameter and batch-statistics totals for the same config.
"""

import json
import os

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from hover_net_tpu.cli import compute_stats as j_compute_stats
from hover_net_tpu.cli import convert_format as j_convert
from hover_net_tpu.models import HoVerNet as JaxHoVerNet
from hover_net_tpu.models import HoVerNetConfig as JaxConfig
from hover_net_tpu.utils.summary import model_summary as j_summary
from hover_net_tpu_torch.cli import compute_stats as t_compute_stats
from hover_net_tpu_torch.cli import convert_format as t_convert
from hover_net_tpu_torch.infer.base import save_json
from hover_net_tpu_torch.metrics.stats import remap_label
from hover_net_tpu_torch.models.hovernet import HoVerNet, HoVerNetConfig
from hover_net_tpu_torch.ops.post_proc_host import extract_instance_info
from hover_net_tpu_torch.utils.summary import model_summary as t_summary

from test_torch_host_copies import blobs
from test_torch_metrics import write_eval_dirs

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.mark.parametrize("argv", [["--mode", "instance"],
                                  ["--mode", "instance", "--print_img_stats"],
                                  ["--mode", "type"]])
def test_compute_stats_prints_the_jax_lines(tmp_path, capsys, argv):
    pred_dir, true_dir = write_eval_dirs(tmp_path, seed=3)
    argv = argv + ["--pred_dir", pred_dir, "--true_dir", true_dir]
    printed = []
    for main in (t_compute_stats.main, j_compute_stats.main):
        main(argv)
        printed.append(capsys.readouterr().out)
    assert printed[0] == printed[1]
    assert printed[0].startswith("[") or "--print_img_stats" in argv


def write_jsons(json_dir, typed):
    """Two tile jsons through the port's writer, one of them empty."""
    os.makedirs(json_dir)
    for i, seed in enumerate((11, 12)):
        inst = remap_label(blobs((90, 100), 12, seed=seed))
        tp = (np.random.default_rng(seed).integers(0, 6, inst.shape)
              .astype(np.int32) if typed else None)
        _, info = extract_instance_info(inst, tp, n_types=6)
        save_json(os.path.join(json_dir, f"t{i}.json"), info, None)
    save_json(os.path.join(json_dir, "t_empty.json"), {}, None)


@pytest.mark.parametrize("typed", [False, True])
def test_convert_format_writes_the_jax_tsv(tmp_path, typed):
    json_dir = str(tmp_path / "json")
    write_jsons(json_dir, typed)
    flags = ["--json_dir", json_dir, "--scale_factor", "0.5"]
    if typed:
        flags += ["--nr_types", "6", "--type_info_path",
                  os.path.join(REPO, "type_info.json")]
    outs = {}
    for name, main in (("port", t_convert.main), ("jax", j_convert.main)):
        out = tmp_path / name
        main(flags + ["--output_dir", str(out)])
        outs[name] = {f: (out / f).read_bytes() for f in os.listdir(out)}
    assert outs["port"] == outs["jax"]
    assert sorted(outs["jax"]) == ["t0.tsv", "t1.tsv", "t_empty.tsv"]
    with open(os.path.join(json_dir, "t0.json")) as f:
        n_nuc = len(json.load(f)["nuc"])
    assert outs["jax"]["t0.tsv"].count(b"\n") == n_nuc + 1 > 5


def totals(text):
    return [line for line in text.splitlines()
            if line.startswith(("total parameters", "batch-stat buffers"))]


@pytest.mark.parametrize("mode", ["fast", "original"])
@pytest.mark.parametrize("nr_types", [None, 5])
def test_model_summary_totals_match_jax(mode, nr_types):
    cfg = JaxConfig(mode=mode, nr_types=nr_types, width=8)
    model = JaxHoVerNet(cfg)
    size = cfg.patch_input_shape
    shapes = jax.eval_shape(lambda: model.init(
        jax.random.PRNGKey(0), jnp.zeros((1, size, size, 3)), train=False))
    want = totals(j_summary(shapes))
    net = HoVerNet(HoVerNetConfig(mode=mode, nr_types=nr_types, width=8))
    text = t_summary(net, max_rows=5)
    assert totals(text) == want and len(want) == 2
    assert len(text.splitlines()) == 1 + 6 + 2
