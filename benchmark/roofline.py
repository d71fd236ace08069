"""The yardstick of the per-layer shares: the card's peaks, the work of a
HoVer-Net patch counted on the reference model, and K1's byte floor.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, no sparsity) at its
700 W limit, as PERF.md's kernel bounds take them: 989 TFLOP/s in bf16,
495 TFLOP/s in TF32, 3.35 TB/s of HBM. The FLOPs are counted by
`torch.utils.flop_counter.FlopCounterMode` on the benchmark's own plain
model (reference/model.py) at the cell's shapes, so a kernel that a later
change puts in the program's place cannot drop out of the count. K1 (the
post-processing tail) reads its two input maps and writes its label map
once: 9 bytes a pixel (PERF.md, "Bound").
"""

from __future__ import annotations

import functools

BF16_PEAK_FLOPS = 989e12
TF32_PEAK_FLOPS = 495e12
HBM_BYTES_PER_S = 3.35e12
K1_BYTES_PER_PIXEL = 9


@functools.lru_cache(maxsize=8)
def patch_flops(mode: str, nr_types, width: int, size: int) -> int:
    """FLOPs of one forward of one `size`^2 patch through the reference
    model (a multiply-add counts 2)."""
    import torch
    from torch.utils.flop_counter import FlopCounterMode

    from .reference.model import HoVerNetRef

    with torch.device("meta"):
        model = HoVerNetRef(mode, nr_types, width).eval()
        x = torch.zeros(1, 3, size, size)
    with FlopCounterMode(display=False) as counter, torch.no_grad():
        model(x)
    return int(counter.get_total_flops())


def k1_floor_s(pixels: int) -> float:
    """The least time K1 can take over `pixels`: bytes over HBM bandwidth
    (its arithmetic is far below the compute roof)."""
    return pixels * K1_BYTES_PER_PIXEL / HBM_BYTES_PER_S

# the kernels of K1 (hover_net_tpu_torch/csrc/post_proc_tail.cu): one call
# of the post-processing tail launches a sequence of these
K1_KERNELS = frozenset((
    "ccl_local", "ccl_border", "ccl_roots", "count_sizes", "keep_large",
    "energy_dist", "blur_quantize", "border_touch", "fill_enclosed",
    "morph5", "ws_init", "ws_seed", "ws_cost_tiles", "ws_label_tiles",
    "ws_final", "marker_out", "phase1_out"))


def kernel_base(name: str) -> str:
    """A profiler kernel name without its return type, namespace,
    template and argument list; a mangled name (`_Z9ccl_localPKh...`,
    `_ZN3ppt4nameE...`) gives its last identifier."""
    if name.startswith("_Z"):
        rest, ident = name[2:].lstrip("N"), name
        while rest[:1].isdigit():
            n = len(rest) - len(rest.lstrip("0123456789"))
            k = int(rest[:n])
            ident, rest = rest[n:n + k], rest[n + k:]
        return ident
    name = name.replace("(anonymous namespace)::", "")
    name = name.split("(")[0].split("<")[0].strip()
    return name.split(" ")[-1].split("::")[-1]


def k1_seconds(device_by_name: dict) -> float:
    return sum(s for n, s in device_by_name.items()
               if kernel_base(n) in K1_KERNELS)
