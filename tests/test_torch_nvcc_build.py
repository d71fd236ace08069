"""The CUDA build's cache key (hover_net_tpu_torch/ops/nvcc_build.py),
on the CPU: no nvcc is needed.

A library's name carries `source_digest`: a hash of its `.cu`, every
`csrc/` file it includes with quotes and the nvcc flags, so an edit to a
header or a flag can never load a stale library.
"""

import os
import subprocess

from hover_net_tpu_torch.ops import nvcc_build
from hover_net_tpu_torch.ops.nvcc_build import (
    CSRC,
    NVCC_FLAGS,
    source_digest,
    source_files,
)


def write(path, text):
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)


def sources(tmp_path):
    """k.cu -> "a.cuh" -> "sub/b.cuh", plus system and missing includes."""
    src = str(tmp_path / "k.cu")
    write(src, '#include <cuda_runtime.h>\n#include "a.cuh"\n'
               '  #  include "missing.h"\nint f() { return A + B; }\n')
    write(str(tmp_path / "a.cuh"), '#pragma once\n#include "sub/b.cuh"\n'
                                   "#define A 1\n")
    write(str(tmp_path / "sub" / "b.cuh"), "#pragma once\n#define B 2\n")
    write(str(tmp_path / "unrelated.cuh"), "#define C 3\n")
    return src


def test_source_files_follow_quoted_includes(tmp_path):
    src = sources(tmp_path)
    names = sorted(os.path.relpath(f, tmp_path) for f in source_files(src))
    assert names == ["a.cuh", "k.cu", os.path.join("sub", "b.cuh")]


def test_digest_changes_with_an_included_header(tmp_path):
    src = sources(tmp_path)
    before = source_digest(src, NVCC_FLAGS)
    assert source_digest(src, NVCC_FLAGS) == before  # stable
    write(str(tmp_path / "sub" / "b.cuh"), "#pragma once\n#define B 5\n")
    after = source_digest(src, NVCC_FLAGS)
    assert after != before
    write(str(tmp_path / "unrelated.cuh"), "#define C 4\n")
    assert source_digest(src, NVCC_FLAGS) == after  # not included


def test_digest_changes_with_the_flags(tmp_path):
    src = sources(tmp_path)
    base = source_digest(src, NVCC_FLAGS)
    extra = source_digest(src, (*NVCC_FLAGS, "-Xptxas", "-v"))
    assert extra != base
    assert source_digest(src, (*NVCC_FLAGS, "-DK3_EXTRA=1")) not in (
        base, extra)


def test_k3_digest_covers_its_geometry_header():
    src = os.path.join(CSRC, "fused_block.cu")
    assert os.path.join(CSRC, "fused_block_geom.cuh") in source_files(src)


def test_compile_passes_flags_and_keeps_the_log(tmp_path, monkeypatch):
    """`_compile` runs nvcc with the library's own flags, names the
    library by the digest, keeps nvcc's messages beside it, and does not
    build again while source and flags are unchanged."""
    csrc = tmp_path / "csrc"
    src = sources(csrc)
    os.rename(src, str(csrc / "demo.cu"))
    calls = []

    def fake_nvcc(cmd, capture_output, text):
        calls.append(cmd)
        write(cmd[cmd.index("-o") + 1], "not a library")
        return subprocess.CompletedProcess(cmd, 0, "", "ptxas info : Used 7 "
                                                        "registers\n")

    monkeypatch.setattr(nvcc_build, "CSRC", str(csrc))
    monkeypatch.setattr(nvcc_build, "BUILD_DIR", str(tmp_path / "out"))
    monkeypatch.setattr(nvcc_build, "nvcc_path", lambda: "nvcc")
    monkeypatch.setattr(nvcc_build.subprocess, "run", fake_nvcc)
    flags = (*NVCC_FLAGS, "-Xptxas", "-v")
    so = nvcc_build._compile("demo", flags)
    digest = source_digest(str(csrc / "demo.cu"), flags)
    assert os.path.basename(so) == f"demo_{digest}.so"
    assert calls[0][1:1 + len(flags)] == list(flags)
    with open(so[:-3] + ".log") as f:
        assert "Used 7 registers" in f.read()
    assert nvcc_build._compile("demo", flags) == so and len(calls) == 1
    nvcc_build._compile("demo", NVCC_FLAGS)  # other flags: a new build
    assert len(calls) == 2
