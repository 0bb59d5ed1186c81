"""Batched hash-map fetch-add -- the HASH apply of the fused probe lane.

Replaces the Pallas kernel `src/repro/kernels/hash_update.py:24`
(`_kernel`, reached through `hash_fetch_add_batch_pallas`). The CUDA
source is `csrc/hash_update.cu`; its plain PyTorch version is
`ref.hash_fetch_add_batch`. The end state is bit-identical to applying
the fetch-adds one by one in batch order.

Bound on an H100: latency -- table and batch are kilobytes. Design: in
place of the Pallas kernel's serial loop over all B events, every event
looks its key up in parallel and resident keys add with 64-bit integer
atomicAdd (exact, order-free); only the new keys go through a serial
insert, one warp probing 32 slots per step, in order of first occurrence,
each with its group's total delta. No slot is claimed through CAS races.
"""
from __future__ import annotations

import ctypes

import torch

from . import build

LAUNCHES = 0
_FN = None


def _fn():
    global _FN
    if _FN is None:
        p, i = ctypes.c_void_p, ctypes.c_int
        _FN = build.function("hash_update", "repro_hash_fetch_add_batch",
                             [p, p, p, p, p, p, i, p, p, p, i, p, p, p, p])
    return _FN


def hash_fetch_add_batch_cuda(keys_tbl, used_tbl, vals_tbl, keys, deltas,
                              valid):
    """Tables i64[n], keys/deltas i64[B], valid bool[B], all on one CUDA
    device. Returns new (keys, used, values); the inputs are not written."""
    global LAUNCHES
    dev = keys_tbl.device
    for t, what in ((keys_tbl, "keys table"), (used_tbl, "used table"),
                    (vals_tbl, "values table"), (keys, "keys"),
                    (deltas, "deltas")):
        build.require(t, f"hash_fetch_add_batch {what}", torch.int64, 1, dev)
    build.require(valid, "hash_fetch_add_batch valid", torch.bool, 1, dev)
    n, b = keys_tbl.shape[0], keys.shape[0]
    if used_tbl.shape[0] != n or vals_tbl.shape[0] != n:
        raise ValueError("hash_fetch_add_batch: table arrays differ in size")
    if deltas.shape[0] != b or valid.shape[0] != b:
        raise ValueError("hash_fetch_add_batch: batch arrays differ in size")
    if not 0 < n < 2**31 or b >= 2**31:
        raise ValueError(f"hash_fetch_add_batch: sizes n={n}, B={b} out of "
                         "range")
    kt, ut, vt = (torch.empty_like(keys_tbl), torch.empty_like(used_tbl),
                  torch.empty_like(vals_tbl))
    pending = torch.empty(b, dtype=torch.int32, device=dev)
    leader = torch.empty(b, dtype=torch.int32, device=dev)
    gsum = torch.empty(b, dtype=torch.int64, device=dev)
    with torch.cuda.device(dev):
        rc = _fn()(keys_tbl.data_ptr(), used_tbl.data_ptr(),
                   vals_tbl.data_ptr(), kt.data_ptr(), ut.data_ptr(),
                   vt.data_ptr(), n, keys.data_ptr(), deltas.data_ptr(),
                   valid.data_ptr(), b, pending.data_ptr(), leader.data_ptr(),
                   gsum.data_ptr(), build.stream_ptr(dev))
    build.check(rc, "hash_fetch_add_batch")
    LAUNCHES += 1
    return kt, ut, vt
