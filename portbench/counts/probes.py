"""Bytes the probe kernels must move: every input byte read once and every
output byte written once (the 16-lane i64 event row, the hash tables, the
ring). Taken per launch from the launch's own tensors."""
from __future__ import annotations

ROW_BYTES = 16 * 8


def tensor_stats_row(x) -> int:
    """The collector's kernel: x in the type it reaches the kernel (f32 or
    bf16; others are converted to f32 first), one event row out."""
    item = x.element_size() if x.dtype.is_floating_point and \
        x.element_size() in (2, 4) else 4
    return x.numel() * item + ROW_BYTES


def hash_fetch_add_batch(keys_tbl, used_tbl, vals_tbl, keys, deltas,
                         valid) -> int:
    tables = sum(t.numel() * t.element_size()
                 for t in (keys_tbl, used_tbl, vals_tbl))
    batch = sum(t.numel() * t.element_size() for t in (keys, deltas, valid))
    return 2 * tables + batch


def ringbuf_emit_batch(data, head, dropped, rows, valid) -> int:
    ring = sum(t.numel() * t.element_size() for t in (data, head, dropped))
    batch = sum(t.numel() * t.element_size() for t in (rows, valid))
    return 2 * ring + batch
