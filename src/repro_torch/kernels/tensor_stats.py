"""Fused tensor statistics -- the probe hot path, one kernel per collected
event.

Replaces the Pallas kernel `src/repro/kernels/tensor_stats.py:25`
(`_kernel`, reached through `tensor_stats_pallas`). The CUDA source is
`csrc/tensor_stats.cu`; its plain PyTorch version is `ref.tensor_stats`.

Bound on an H100: bytes -- each element is read once and costs a handful
of operations. Design: a fixed grid of blocks (a function of numel only)
loops over strided shares with 16-byte loads and writes per-block partials
(sum and sum of squares in double, min, max, NaN and Inf counts); a second
pass folds them in block order. No float atomics, so repeated runs give
identical rows; bf16 is widened inside the kernel.
"""
from __future__ import annotations

import ctypes

import torch

from . import build
from .ref import STAT_KEYS

LAUNCHES = 0                  # incremented once per kernel launch
BLOCK = 256                   # threads per block (kThreads in the source)
MAX_GRID = 528                # 4 blocks per SM of an H100
_PER_BLOCK = BLOCK * 16       # elements a block takes before the grid grows
_FN = None


def grid_for(numel: int) -> int:
    return max(1, min(MAX_GRID, -(-numel // _PER_BLOCK)))


def _fn():
    global _FN
    if _FN is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        _FN = build.function("tensor_stats", "repro_tensor_stats",
                             [p, i, ll, i, i, p, p, p, p])
    return _FN


def tensor_stats_cuda(x: torch.Tensor) -> dict:
    """Launch the kernel on a contiguous f32 or bf16 CUDA tensor. Returns
    0-dim tensors: f32 mean/rms/min/max/absmax, i64 nan_cnt/inf_cnt."""
    global LAUNCHES
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"tensor_stats: expected f32 or bf16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("tensor_stats: x must be contiguous")
    build.require(x.view(-1), "tensor_stats x", x.dtype, 1)
    dev = x.device
    n = x.numel()
    grid = grid_for(n)
    part = torch.empty(6 * grid, dtype=torch.float64, device=dev)
    out_f = torch.empty(5, dtype=torch.float32, device=dev)
    out_i = torch.empty(2, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        rc = _fn()(x.data_ptr(), int(x.dtype == torch.bfloat16), n,
                   int(x.data_ptr() % 16 == 0), grid, part.data_ptr(),
                   out_f.data_ptr(), out_i.data_ptr(), build.stream_ptr(dev))
    build.check(rc, "tensor_stats")
    LAUNCHES += 1
    out = {k: out_f[j] for j, k in enumerate(STAT_KEYS)}
    out["nan_cnt"] = out_i[0]
    out["inf_cnt"] = out_i[1]
    return out
