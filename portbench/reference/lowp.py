"""The reference's arithmetic: float32, and the lower-precision control
one step below the bfloat16 the configurations state: float8 e4m3 with a
scale per tensor wherever the program holds bfloat16 (the operands of
every matrix product, the residual stream), products summed in float32.

Two stand-ins read beside the program by calibrate.py, never by a run:
"bfloat16", bfloat16 in those places, and "bfloat16_f32_residual", the
same with the residual stream kept in float32.

A model module takes a `Precision`: `pr.mm(a, b)` for a matrix product
and `pr.act(x)` for the residual stream, which the program stores in its
compute type."""
from __future__ import annotations

import torch

F32 = torch.float32
E4M3_MAX = 448.0


def fp8_round(x):
    """x rounded to float8 e4m3 with one scale for the whole tensor, back
    in float32. The gradient passes straight through."""
    x = x.to(F32)
    amax = x.detach().abs().amax().clamp_min(1e-30)
    scale = E4M3_MAX / amax
    q = (x.detach() * scale).to(torch.float8_e4m3fn).to(F32) / scale
    return x + (q - x.detach())


def bf16_round(x):
    """x rounded to bfloat16, back in float32."""
    x = x.to(F32)
    return x + (x.detach().to(torch.bfloat16).to(F32) - x.detach())


def _f32(x):
    return x.to(F32)


class Precision:
    def __init__(self, rnd, act=None):
        self.rnd, self.act = rnd, act or rnd

    def mm(self, a, b):
        return self.rnd(a) @ self.rnd(b)


FLOAT32 = Precision(_f32)
PRECISIONS = {"float32": FLOAT32, "float8": Precision(fp8_round),
              "bfloat16": Precision(bf16_round),
              "bfloat16_f32_residual": Precision(bf16_round, _f32)}
