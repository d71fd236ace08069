"""The port stands alone: nothing in hover_net_tpu_torch/ or chip_smoke.py
imports jax, flax, optax, msgpack (a GPU host need not have them; the
port reads the JAX checkpoints with its own models/msgpack_io.py),
the JAX package hover_net_tpu, or the JAX package's measurement scripts
(bench.py and scripts/ at the repository root), directly or through
another module."""

import ast
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FORBIDDEN = ("jax", "flax", "optax", "msgpack", "hover_net_tpu", "bench",
             "scripts")
# the port's counterparts of bench.py's recipe and of scripts/, under cli/
MEASUREMENT_CLIS = ("recipe", "probe_pp_stages", "bench_train",
                    "probe_device_time", "fused_encoder_drift",
                    "parity_drift_sweep", "eval_consep", "eval_consep_dryrun",
                    "bench_finalize_pool")


def port_sources():
    """Every .py file of the port, and chip_smoke.py (repo-relative)."""
    out = ["chip_smoke.py"]
    for root, _, files in os.walk(os.path.join(REPO, "hover_net_tpu_torch")):
        out += [os.path.relpath(os.path.join(root, f), REPO)
                for f in files if f.endswith(".py")]
    return sorted(out)


def forbidden_imports(path):
    """(line, module) of every import of a FORBIDDEN package in `path`."""
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read(), path)
    bad = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        else:
            continue
        bad += [(node.lineno, n) for n in names
                if n.split(".")[0] in FORBIDDEN]
    return bad


def test_forbidden_imports_are_found(tmp_path):
    """The walk itself sees plain, dotted, from- and nested imports, and
    passes the port's own package and relative imports."""
    src = ("import os\nimport jax.numpy as jnp\n"
           "from hover_net_tpu.ops import cc_np\n"
           "import hover_net_tpu_torch\nfrom . import filters\n"
           "def f():\n    import flax\n"
           "import optax\nfrom msgpack import packb\n"
           "from hover_net_tpu_torch.models import msgpack_io\n"
           "from .msgpack_io import msgpack_restore\n")
    path = tmp_path / "probe.py"
    path.write_text(src)
    assert [n for _, n in forbidden_imports(str(path))] == [
        "jax.numpy", "hover_net_tpu.ops", "optax", "msgpack", "flax"]


def test_jax_bench_and_scripts_imports_are_found(tmp_path):
    """An import of bench.py or of a module of scripts/ is found; the
    port's own cli.bench_train and cli.recipe are not."""
    src = ("import bench\nfrom scripts import probe_forward_split\n"
           "from scripts.bench_wsi import main\n"
           "from hover_net_tpu_torch.cli import bench_train\n"
           "from hover_net_tpu_torch.cli.recipe import synth_pred_map\n")
    path = tmp_path / "probe.py"
    path.write_text(src)
    assert [n for _, n in forbidden_imports(str(path))] == [
        "bench", "scripts", "scripts.bench_wsi"]


@pytest.mark.parametrize("name", MEASUREMENT_CLIS)
def test_measurement_clis_are_in_the_checked_sources(name):
    assert f"hover_net_tpu_torch/cli/{name}.py" in port_sources()


@pytest.mark.parametrize("path", port_sources())
def test_source_imports_no_jax_package(path):
    assert forbidden_imports(path) == [], path


def test_cellvit_module_is_checked():
    assert "hover_net_tpu_torch/models/cellvit.py" in port_sources()


@pytest.mark.parametrize("path", ["hover_net_tpu_torch/models/cellpose_sam.py",
                                  "hover_net_tpu_torch/ops/flow_dynamics.py"])
def test_cellpose_modules_are_checked(path):
    assert path in port_sources()


def reference_sources():
    """Every .py file of the benchmark's plain references."""
    ref = os.path.join(REPO, "benchmark", "reference")
    return sorted(os.path.relpath(os.path.join(ref, f), REPO)
                  for f in os.listdir(ref) if f.endswith(".py"))


@pytest.mark.parametrize("path", reference_sources())
def test_reference_imports_no_program(path):
    """The benchmark's references (the CellViT one among them) import
    nothing of the port, of jax or of the JAX package."""
    with open(os.path.join(REPO, path)) as f:
        tree = ast.parse(f.read(), path)
    names = [a.name for n in ast.walk(tree) if isinstance(n, ast.Import)
             for a in n.names]
    names += [n.module or "" for n in ast.walk(tree)
              if isinstance(n, ast.ImportFrom) and n.level == 0]
    assert not [n for n in names if n.split(".")[0] in
                ("hover_net_tpu_torch", "hover_net_tpu", "jax", "flax")], path


def test_cellpose_reference_is_checked():
    assert {"benchmark/reference/cellpose_sam.py",
            "benchmark/reference/cellpose_recipe.py"} <= set(
                reference_sources())


def test_new_traffic_modules_import_without_jax():
    """A fresh interpreter imports the Cellpose-SAM and four-card traffic
    modules, the Cellpose reference and its recipe: neither jax nor any
    module of the JAX package is loaded."""
    code = (
        "import sys\n"
        "import benchmark.traffic.tile_cellpose\n"
        "import benchmark.traffic.wsi_4chip\n"
        "import benchmark.reference.cellpose_recipe\n"
        "import benchmark.reference.cellpose_sam\n"
        "import hover_net_tpu_torch.ops.flow_dynamics\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr


def test_port_modules_import_without_jax():
    """A fresh interpreter (tests/conftest.py imports jax in this one)
    imports every module of the port and chip_smoke.py; neither jax nor
    any module of the JAX package or of its scripts is loaded."""
    code = (
        "import pkgutil, sys\n"
        "import hover_net_tpu_torch as p\n"
        "names = [m.name for m in pkgutil.walk_packages(p.__path__, "
        "p.__name__ + '.')]\n"
        "for n in names: __import__(n)\n"
        "import chip_smoke\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.split()[-1]) >= 30


def test_spawned_ranks_import_no_jax():
    """A multi-device run's ranks (spawned processes, one a device) import
    the port and nothing of jax, flax or the JAX package: every process of
    a fresh 2-rank `dryrun_train_step` on the CPU reports its imports
    (PYTHONPROFILEIMPORTTIME, inherited by the ranks)."""
    code = ("from hover_net_tpu_torch.parallel.train_parallel import "
            "dryrun_train_step\n"
            "dryrun_train_step(2, ['cpu', 'cpu'])\n")
    env = dict(os.environ, PYTHONPROFILEIMPORTTIME="1")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert "dryrun_multichip ok: 2 devices" in res.stdout
    names = [line.rsplit("|", 1)[1].strip()
             for line in res.stderr.splitlines()
             if line.startswith("import time:") and "|" in line]
    # the parent and both ranks imported the rank's module
    assert names.count("hover_net_tpu_torch.parallel.train_parallel") == 3
    assert not [n for n in names if n.split(".")[0] in FORBIDDEN]
