"""Batched ring-buffer emit -- the whole RINGBUF apply of the fused probe
lane in one launch.

Replaces the Pallas kernel `src/repro/kernels/ringbuf_emit.py:17`
(`_kernel`, reached through `ringbuf_emit_batch_pallas`) and the `dropped`
accounting the JAX apply keeps around it
(`src/repro/core/vectorized.py:238-252`). The CUDA source is
`csrc/ringbuf_emit.cu`; its plain PyTorch version is
`ref.ringbuf_emit_batch`. Bit-identical to appending the valid rows one
by one with `maps.t_ringbuf_emit`.

Bound on an H100: latency -- ring and batch are kilobytes. Design: one
block of 1024 threads copies the ring, counts the valid rows, recomputes
each row's rank from warp ballots and scatters row i to (head + rank_i) %
cap; when the batch holds more than `cap` valid rows only the last `cap`
ranks write, so no two threads race for a slot. `dropped` gains the lap
count in closed form. No scratch: the wrapper allocates the three outputs
and nothing else.
"""
from __future__ import annotations

import ctypes

import torch

from .. import telemetry
from . import build

LAUNCHES = 0
_FN = None


def _fn():
    global _FN
    if _FN is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        _FN = build.function("ringbuf_emit", "repro_ringbuf_emit_batch",
                             [p, p, p, p, p, i, i, i, p, p, p, p])
    return _FN


def ringbuf_emit_batch_cuda(data, head, dropped, rows, valid):
    """data i64[cap, W], head and dropped i64[1], rows i64[B, W], valid
    bool[B], all on one CUDA device. Returns new (data, head, dropped); the
    inputs are not written."""
    global LAUNCHES
    dev = data.device
    build.require(data, "ringbuf_emit_batch data", torch.int64, 2, dev)
    build.require(head, "ringbuf_emit_batch head", torch.int64, 1, dev)
    build.require(dropped, "ringbuf_emit_batch dropped", torch.int64, 1, dev)
    build.require(rows, "ringbuf_emit_batch rows", torch.int64, 2, dev)
    build.require(valid, "ringbuf_emit_batch valid", torch.bool, 1, dev)
    cap, w = data.shape
    b = rows.shape[0]
    if head.shape[0] != 1 or dropped.shape[0] != 1 or rows.shape[1] != w \
            or valid.shape[0] != b:
        raise ValueError("ringbuf_emit_batch: shapes do not agree: data "
                         f"{tuple(data.shape)}, head {tuple(head.shape)}, "
                         f"dropped {tuple(dropped.shape)}, rows "
                         f"{tuple(rows.shape)}, valid {tuple(valid.shape)}")
    if not 0 < cap < 2**31 or not 0 < w < 2**31 or b >= 2**31:
        raise ValueError(f"ringbuf_emit_batch: sizes cap={cap}, W={w}, "
                         f"B={b} out of range")
    d = torch.empty_like(data)
    h = torch.empty_like(head)
    dr = torch.empty_like(dropped)
    with build.device_guard(dev):
        rc = _fn()(data.data_ptr(), head.data_ptr(), dropped.data_ptr(),
                   rows.data_ptr(), valid.data_ptr(), cap, w, b,
                   d.data_ptr(), h.data_ptr(), dr.data_ptr(),
                   build.stream_ptr(dev))
    build.check(rc, "ringbuf_emit_batch")
    LAUNCHES += 1
    if telemetry.on():
        telemetry.count("probe.ringbuf_emit", telemetry.shapes(
            data, head, dropped, rows, valid))
    return d, h, dr
