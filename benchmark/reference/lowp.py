"""The low-precision control: the reference forward one step below the
precision the configuration states, and the bf16 witness.

The configurations state a bfloat16 body (float32 BatchNorm and heads);
the step below it is fp8. `fp8_e4m3` rounds a convolution's input and
weight to float8 e4m3 with a scale (the activation's per tensor, the
weight's per output channel, each mapping its largest magnitude to
e4m3's largest finite value, 448), then the convolution runs in float32
on the rounded values: what an fp8 tensor-core convolution with float32
accumulation computes. BatchNorm and the heads stay in float32, as the
program keeps them.

`bf16` is not a control but a witness: it rounds a convolution's input and
weight to bfloat16, the precision the configurations state for the body,
and so reads how far bf16 rounding alone moves the float32 reference's
maps on the same tiles and regions.
"""

from __future__ import annotations

import torch

E4M3_MAX = 448.0


def fp8_e4m3(t: torch.Tensor, kind: str) -> torch.Tensor:
    dims = tuple(range(1, t.dim())) if kind == "weight" else None
    amax = (t.abs().amax(dim=dims, keepdim=True) if dims
            else t.abs().amax())
    scale = torch.clamp(amax, min=1e-12) / E4M3_MAX
    return (t / scale).to(torch.float8_e4m3fn).to(t.dtype) * scale


def bf16(t: torch.Tensor, kind: str) -> torch.Tensor:
    return t.to(torch.bfloat16).to(t.dtype)


ROUNDINGS = {"fp8": fp8_e4m3, "bf16": bf16}
