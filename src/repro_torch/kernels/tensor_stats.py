"""Fused tensor statistics -- the probe hot path, one launch per collected
event.

Replaces the Pallas kernel `src/repro/kernels/tensor_stats.py:25`
(`_kernel`, reached through `tensor_stats_pallas`). The CUDA source is
`csrc/tensor_stats.cu`; its plain PyTorch versions are `ref.tensor_stats`
(the dict of stats) and `ref.tensor_stats_row` (the collector's event row).

Bound on an H100: bytes at size -- each element is read once and costs a
handful of operations -- and the launch for the collector's small tensors.
Design: one launch over a grid that is a function of numel only. Up to
ONE_BLOCK_MAX elements one block reduces the whole tensor; above it the
blocks write partial records (sum and sum of squares in double, min, max,
NaN and Inf counts) and the block that draws the last ticket of a
per-device counter folds them in a fixed order. Each all-finite 16-byte
unit is summed in f32 before it enters the double sums. No float atomics, so
repeated runs give identical results; bf16 is widened inside the kernel.
The body streams through 16-byte loads, four in flight per thread. Two
epilogues: the dict entry (`tensor_stats_cuda`) and the row entry
(`tensor_stats_row_cuda`), which writes the whole 16-lane event row.

The partials and the ticket counter are one scratch buffer per device and
stream, kept for the process (`build.device_scratch`): launches on one
stream run in order and leave the ticket at 0, and two streams never share
a buffer, so any stream may call.
"""
from __future__ import annotations

import ctypes

import torch

from .. import telemetry
from . import build
from .ref import STAT_KEYS

LAUNCHES = 0                  # incremented once per kernel launch
BLOCK = 256                   # threads per block (kThreads in the source)
# The grid constants were measured on one H100 80GB HBM3 at 700 W
# (PERF.md §6, the kernel table):
# - one block takes a tensor of up to ONE_BLOCK_MAX elements whole (no
#   partials, no ticket): one block was faster than a 32-block grid at
#   8,192 elements and slower at 16,384;
# - grids are multiples of GRID_MULTIPLE blocks: every grid measured that
#   was not a multiple of 32 (2 to 528 blocks) took 2.0-3.7 us longer than
#   a multiple of 32 at the same size; the cause is not known;
# - MAX_GRID: of the caps measured (264 to 1,024 blocks), 384 was the
#   fastest at 2 Mi f32 and at the training block tensor (7.3 M bf16), and
#   within 1.2 % of the fastest (512) at 64 Mi f32.
ONE_BLOCK_MAX = 12288
GRID_MULTIPLE = 32
MAX_GRID = 384
_PER_BLOCK = 4096             # elements a block takes before the grid grows
SCRATCH_GRID = 1024           # partial records the per-device scratch holds
_SCRATCH_BYTES = 16 + 40 * SCRATCH_GRID
_FN: dict = {}


def grid_for(numel: int) -> int:
    if numel <= ONE_BLOCK_MAX:
        return 1
    grid = -(-numel // _PER_BLOCK)
    return min(MAX_GRID, -(-grid // GRID_MULTIPLE) * GRID_MULTIPLE)


def _fn(symbol: str):
    if symbol not in _FN:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        args = ([p, i, ll, i, p, p, p, p] if symbol == "repro_tensor_stats"
                else [p, i, ll, i, p, ll, ll, ll, p, p])
        _FN[symbol] = build.function("tensor_stats", symbol, args)
    return _FN[symbol]


def _check(x: torch.Tensor):
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"tensor_stats: expected f32 or bf16, got {x.dtype}")
    if not x.is_contiguous():
        raise ValueError("tensor_stats: x must be contiguous")
    if not x.is_cuda:
        raise ValueError(f"tensor_stats x: expected a CUDA tensor, got "
                         f"{x.device}")


def _launch(symbol: str, x: torch.Tensor, grid: int, *tail) -> None:
    global LAUNCHES
    if not 1 <= grid <= SCRATCH_GRID:
        raise ValueError(f"tensor_stats: grid {grid} not in [1, "
                         f"{SCRATCH_GRID}]")
    dev = x.device
    n = x.numel()
    scratch, stream = build.device_scratch("tensor_stats", dev,
                                           _SCRATCH_BYTES)
    with build.device_guard(dev):
        rc = _fn(symbol)(x.data_ptr(), int(x.dtype == torch.bfloat16), n,
                         grid, scratch.data_ptr(), *tail, stream)
    build.check(rc, "tensor_stats")
    LAUNCHES += 1
    telemetry.count("probe.tensor_stats", (symbol, n, x.element_size()))


def tensor_stats_cuda(x: torch.Tensor) -> dict:
    """Launch the kernel on a contiguous f32 or bf16 CUDA tensor. Returns
    0-dim tensors: f32 mean/rms/min/max/absmax, i64 nan_cnt/inf_cnt (views
    of one output buffer)."""
    _check(x)
    out = torch.empty(6, dtype=torch.int64, device=x.device)
    out_f = out[2:].view(torch.float32)
    _launch("repro_tensor_stats", x, grid_for(x.numel()), out_f.data_ptr(),
            out.data_ptr())
    res = {k: out_f[j] for j, k in enumerate(STAT_KEYS)}
    res["nan_cnt"] = out[0]
    res["inf_cnt"] = out[1]
    return res


def tensor_stats_row_cuda(x: torch.Tensor, site_id: int, kind: int,
                          layer: int) -> torch.Tensor:
    """The collector's event row of a contiguous f32 or bf16 CUDA tensor in
    one launch: i64[16] as `ref.tensor_stats_row`."""
    _check(x)
    row = torch.empty(16, dtype=torch.int64, device=x.device)
    _launch("repro_tensor_stats_row", x, grid_for(x.numel()), int(site_id), int(kind),
            int(layer), row.data_ptr())
    return row
