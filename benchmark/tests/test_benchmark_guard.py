"""The import guard of benchmark/run.py compares top-level names whole."""

from benchmark.run import forbidden_modules


def test_port_passes_and_jax_package_fails():
    assert forbidden_modules(["hover_net_tpu_torch",
                              "hover_net_tpu_torch.infer.tile"]) == []
    assert forbidden_modules(["hover_net_tpu.x"]) == ["hover_net_tpu"]
    assert forbidden_modules(["jax.numpy", "flax", "optax.x", "jaxlib",
                              "numpy"]) == ["flax", "jax", "jaxlib", "optax"]


def test_reference_imports_no_program():
    import subprocess
    import sys

    code = ("import sys, benchmark.reference.infer, benchmark.reference.recipe,"
            " benchmark.reference.compare, benchmark.roofline;"
            "print(sorted({m.split('.')[0] for m in sys.modules}))")
    from benchmark import common

    out = subprocess.run([sys.executable, "-c", code], cwd=common.ROOT,
                         capture_output=True,
                         text=True, check=True).stdout
    for name in ("hover_net_tpu_torch", "hover_net_tpu", "jax"):
        assert f"'{name}'" not in out
