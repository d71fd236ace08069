"""Kernel K3: a fused encoder ResidualBlock group (csrc/fused_block.cu),
and its plain PyTorch version.

`fused_block_apply(x, packed, count=, stride=)` maps NHWC bf16
[N, S, S, Cin] to [N, S/stride, S/stride, Cout]: the strided 1x1 shortcut
conv, `count` pre-activation bottleneck units (1x1 -> BN/ReLU -> 3x3
'SAME' -> BN/ReLU -> 1x1) with the rolling shortcut, and the block's
final BN + ReLU, inference BN folded. It replaces the TPU kernel
`_build_block_call` of hover_net_tpu/models/encoder_pallas.py, and takes
the same `packed` dict (models/encoder_fused.pack_block).

- CPU tensors go to `fused_block_reference`, the plain version: the same
  rounding points (f32-accumulated products rounded to bf16, bf16
  residual sums, and each folded BN applied to the bf16 value in float32,
  as the model's own BatchNorms compute, rounded to bf16 once before the
  ReLU).
- CUDA tensors go to the kernel: per residual unit, one call into the
  library that launches its three convolutions (TMA-fed wgmma implicit
  GEMMs; unit 0's strided shortcut runs inside conv3's launch), the conv1
  and conv2 outputs in bf16 scratch maps. The library is built by
  ops/nvcc_build.py at first use; a failed build raises. There is no
  fallback.

`fused_block_apply.launches` counts kernel runs: one per block call.
"""

from __future__ import annotations

import contextlib
import ctypes
from typing import Dict, List, Tuple

import torch
import torch.nn.functional as F

from .nvcc_build import build_library

BF16 = torch.bfloat16
# nvcc's register and spill report goes to the build log beside the library
K3_FLAGS = ("-Xptxas", "-v")


# ------------------------------------------------------ the plain version

@contextlib.contextmanager
def _full_f32_matmul():
    """float32 matmuls in full float32 on the card (no TF32)."""
    prev = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = prev


def _dot(a: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """[..., K] bf16 @ [K, N] bf16: exact products, f32 sums, one bf16
    rounding."""
    return torch.matmul(a.float(), w.float()).to(BF16)


def _bn_relu(y: torch.Tensor, s: torch.Tensor, o: torch.Tensor):
    """relu(y * s + o) of bf16 `y` in the dtype of the scale `s`, rounded
    to bf16: with the float32 affines of `pack_block` (the kernel's) one
    rounding, after the add; with bf16 affines, as the JAX package's TPU
    kernel applies them, one after the multiply and one after the add."""
    return torch.relu((y.to(s.dtype) * s + o.to(s.dtype)).to(BF16))


def _conv3x3(t: torch.Tensor, w2: torch.Tensor, stride: int) -> torch.Tensor:
    """'SAME' 3x3 over NHWC bf16 `t` with taps w2 [9, C, C] (dy * 3 + dx):
    zero padding 1/1 at stride 1, 0 before and 1 after at stride 2 (the TF
    rule), so out[q] = sum_k in[stride * q + k - (stride == 1)]. The nine
    products sum in f32 and round to bf16 once."""
    n, h, w, _ = t.shape
    if stride == 1:
        tp = F.pad(t, (0, 0, 1, 1, 1, 1))
    else:
        tp = F.pad(t, (0, 0, 0, 1, 0, 1))
    ho, wo = h // stride, w // stride
    acc = None
    for dy in range(3):
        for dx in range(3):
            a = tp[:, dy:dy + stride * (ho - 1) + 1:stride,
                   dx:dx + stride * (wo - 1) + 1:stride]
            v = torch.matmul(a.float(), w2[dy * 3 + dx].float())
            acc = v if acc is None else acc + v
    return acc.to(BF16)


def fused_block_reference(x: torch.Tensor, packed: Dict[str, torch.Tensor],
                          *, count: int, stride: int, has_u0: bool = True,
                          final_bn: bool = True) -> torch.Tensor:
    """Plain PyTorch version of the kernel, on any device; the whole map
    at once (no tiles)."""
    with _full_f32_matmul():
        x = x.to(BF16)
        u_rest = count - 1 if has_u0 else count
        if has_u0:
            sc = _dot(x[:, ::stride, ::stride], packed["wsc"])
            t = _bn_relu(_dot(x, packed["w1_0"]), packed["s1_0"],
                         packed["o1_0"])
            y = _bn_relu(_conv3x3(t, packed["w2_0"], stride), packed["s2_0"],
                         packed["o2_0"])
            prev = _dot(y, packed["w3_0"]) + sc
        else:
            prev = x
        for u in range(u_rest):
            a = _bn_relu(prev, packed["ps"][u], packed["po"][u])
            t = _bn_relu(_dot(a, packed["w1r"][u]), packed["s1r"][u],
                         packed["o1r"][u])
            y = _bn_relu(_conv3x3(t, packed["w2r"][9 * u:9 * u + 9], 1),
                         packed["s2r"][u], packed["o2r"][u])
            prev = _dot(y, packed["w3r"][u]) + prev
        if final_bn:
            prev = _bn_relu(prev, packed["sb"], packed["ob"])
        return prev


# ------------------------------------------------------------ the kernel

def _bind(lib: ctypes.CDLL) -> None:
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.hnt_fused_unit.restype = ctypes.c_int
    lib.hnt_fused_unit.argtypes = [p] * 4 + [i] * 8 + [p] * 13
    lib.hnt_fused_error_string.restype = ctypes.c_char_p
    lib.hnt_fused_error_string.argtypes = [ctypes.c_int]


def build() -> ctypes.CDLL:
    """Compile csrc/fused_block.cu (if this source has no library yet)
    and load it. Raises on any failure."""
    return build_library("fused_block", _bind, K3_FLAGS)


def kernel_units(packed: Dict[str, torch.Tensor], device, *, count: int,
                 has_u0: bool = True, final_bn: bool = True
                 ) -> List[Dict[str, torch.Tensor]]:
    """The kernel's layout of `packed`: per-unit weights, K-major as
    [cout][taps][k] (a 1x1 weight [K, N] -> [N, K]; the 3x3 taps [9, K, N]
    -> [N, 9, K]) in bf16, and float32 BN affines, on `device`. Callers
    that run a block many times build it once
    (models/encoder_fused.pack_encoder)."""

    def b(t):
        return t.to(device=device, dtype=BF16).contiguous()

    def f(t):
        return t.to(device=device, dtype=torch.float32).contiguous()

    def wt(w):  # [K, N] -> [N, K]
        return b(w.t())

    def wt3(w):  # [9, K, N] -> [N, 9, K]
        return b(w.permute(2, 0, 1))

    units = []
    if has_u0:
        units.append(dict(wsct=wt(packed["wsc"]), w1t=wt(packed["w1_0"]),
                          s1=f(packed["s1_0"]), o1=f(packed["o1_0"]),
                          w2t=wt3(packed["w2_0"]), s2=f(packed["s2_0"]),
                          o2=f(packed["o2_0"]), w3t=wt(packed["w3_0"])))
    for u in range(count - 1 if has_u0 else count):
        units.append(dict(pre_s=f(packed["ps"][u]), pre_o=f(packed["po"][u]),
                          w1t=wt(packed["w1r"][u]), s1=f(packed["s1r"][u]),
                          o1=f(packed["o1r"][u]),
                          w2t=wt3(packed["w2r"][9 * u:9 * u + 9]),
                          s2=f(packed["s2r"][u]), o2=f(packed["o2r"][u]),
                          w3t=wt(packed["w3r"][u])))
    if final_bn:
        units[-1]["sb"] = f(packed["sb"])
        units[-1]["ob"] = f(packed["ob"])
    return units


def launch_plan(shape, c1: int, cout: int, *, count: int, stride: int,
                has_u0: bool = True, **_) -> List[Tuple[str, int, int]]:
    """(name, FLOPs, bytes) of each kernel launch of one block call on an
    NHWC input of `shape` [n, s, s, cin], in launch order: conv1, conv2
    and conv3 of every unit. Bytes count each input map, weight and
    residual read once and the output written once; unit 0's conv3 reads
    the input pixels its strided shortcut samples in place of a
    residual."""
    n, s, _, cin = shape
    p_out = n * (s // stride) ** 2
    plan = []
    for u in range(count):
        first = u == 0 and has_u0
        c_in, p_in = (cin, n * s * s) if first else (cout, p_out)
        plan.append((f"u{u}.conv1", 2 * p_in * c_in * c1,
                     2 * (p_in * c_in + c_in * c1 + p_in * c1)))
        plan.append((f"u{u}.conv2", 2 * p_out * 9 * c1 * c1,
                     2 * (p_in * c1 + 9 * c1 * c1 + p_out * c1)))
        flops = 2 * p_out * c1 * cout
        nbytes = p_out * c1 + c1 * cout + 2 * p_out * cout
        if first:
            flops += 2 * p_out * cin * cout
            nbytes += p_out * cin + cin * cout - p_out * cout
        plan.append((f"u{u}.conv3" + ("+shortcut" if first else ""), flops,
                     2 * nbytes))
    return plan


def _fused_block_cuda(x, packed, count, stride, has_u0, final_bn, th,
                      units):
    if x.dtype != BF16:
        raise TypeError(f"x must be bfloat16, got {x.dtype}")
    if x.dim() != 4 or x.shape[1] != x.shape[2] or x.shape[1] % stride:
        raise ValueError(f"x must be [N, S, S, C] with S % {stride} == 0, "
                         f"got {tuple(x.shape)}")
    if not x.is_contiguous() or x.data_ptr() % 16:
        raise ValueError("x must be contiguous and 16-byte aligned")
    if stride not in (1, 2) or count < 1 or (stride == 2 and not has_u0):
        raise ValueError(f"unsupported block: count {count}, stride "
                         f"{stride}, has_u0 {has_u0}")
    n, s, _, cin = x.shape
    if units is None:
        units = kernel_units(packed, x.device, count=count, has_u0=has_u0,
                             final_bn=final_bn)
    if len(units) != count or units[0]["w1t"].device != x.device:
        raise ValueError(f"units must hold {count} units on {x.device}")
    c1, cout = units[0]["w1t"].shape[0], units[0]["w3t"].shape[0]
    if units[0]["w1t"].shape[1] != cin:
        raise ValueError(f"x has {cin} channels, the block takes "
                         f"{units[0]['w1t'].shape[1]}")
    if cin % 32 or c1 % 32 or cout % 32:
        raise ValueError(f"channels must be multiples of 32: cin {cin}, "
                         f"c1 {c1}, cout {cout}")
    if not has_u0 and cin != cout:
        raise ValueError("a continuation chain needs cin == cout")
    s_out = s // stride
    lib = build()
    with torch.cuda.device(x.device):
        out = torch.empty((n, s_out, s_out, cout), dtype=BF16,
                          device=x.device)
        # conv1's output at the unit input's size, conv2's at the output's
        t = torch.empty((n, s, s, c1), dtype=BF16, device=x.device)
        y = torch.empty((n, s_out, s_out, c1), dtype=BF16, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        src = x
        for k, u in enumerate(units):
            st = stride if (k == 0 and has_u0) else 1
            ptr = (lambda name: u[name].data_ptr() if name in u else None)
            # units after the first update `out` in place (the rolling
            # shortcut is the unit's own input)
            err = lib.hnt_fused_unit(
                src.data_ptr(), out.data_ptr(), t.data_ptr(), y.data_ptr(),
                n, src.shape[1], s_out, src.shape[-1], c1, cout, st, th,
                ptr("pre_s"), ptr("pre_o"), ptr("w1t"), ptr("s1"), ptr("o1"),
                ptr("w2t"), ptr("s2"), ptr("o2"), ptr("w3t"), ptr("wsct"),
                ptr("sb"), ptr("ob"), stream)
            if err:
                raise RuntimeError("fused-block kernel failed: "
                                   + lib.hnt_fused_error_string(err).decode())
            src = out
    fused_block_apply.launches += 1
    return out


def fused_block_apply(x: torch.Tensor, packed: Dict[str, torch.Tensor], *,
                      count: int, stride: int, has_u0: bool = True,
                      final_bn: bool = True, th: int = 0,
                      units=None) -> torch.Tensor:
    """One fused residual block: NHWC bf16 [N, S, S, Cin] ->
    [N, S/stride, S/stride, Cout]. CUDA tensors run the kernel (`th` > 0
    forces output tiles of th rows x 128 / th columns, and the kernel
    refuses a th that is not a power of two in [1, 128]; 0 picks 8 x 16,
    or fewer columns on a map narrower than 16; `units` is
    `kernel_units(packed, ...)` when the caller keeps it, else it is
    built for this call), CPU tensors the plain version."""
    if x.device.type == "cuda":
        return _fused_block_cuda(x, packed, count, stride, has_u0, final_bn,
                                 th, units)
    if x.device.type != "cpu":
        raise ValueError(f"no fused-block path for {x.device}")
    return fused_block_reference(x, packed, count=count, stride=stride,
                                 has_u0=has_u0, final_bn=final_bn)


fused_block_apply.launches = 0
