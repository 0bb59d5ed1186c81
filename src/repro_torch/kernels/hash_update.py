"""Batched hash-map fetch-add -- the HASH apply of the fused probe lane.

Replaces the Pallas kernel `src/repro/kernels/hash_update.py:24`
(`_kernel`, reached through `hash_fetch_add_batch_pallas`). The CUDA
source is `csrc/hash_update.cu`; its plain PyTorch version is
`ref.hash_fetch_add_batch`. The end state is bit-identical to applying
the fetch-adds one by one in batch order.

Bound on an H100: latency -- table and batch are kilobytes. Design: in
place of the Pallas kernel's serial loop over all B events, every event
looks its key up in parallel and resident keys add with 64-bit integer
atomicAdd (exact, order-free); the other events group by key in O(B)
through a batch-local hash table (least event index and delta sum per
key); only the group leaders go through a serial insert, one warp probing
4 x 32 slots per step, in order of first occurrence -- and, when no
resident key is hidden behind an empty slot, only up to the first free
slot, with no probe at all once the table is full. No slot of the map is
claimed through CAS races.

Routes, picked from n and B alone (`plan`): "shared" keeps the three
tables and the batch table in one block's shared memory -- one launch, no
copy or memset -- whenever they fit in SMEM_MAX bytes; "global" leaves
larger tables in device memory (one launch: a grid copies them and counts
their free slots, the block that draws the last ticket of a counter kept
per device and stream applies the batch), with the batch table in shared
memory when it fits, else in one scratch tensor. The counter is
`build.device_scratch`, one per stream, so any stream may call.
"""
from __future__ import annotations

import ctypes

import torch

from .. import telemetry
from . import build

LAUNCHES = 0
SMEM_MAX = 227 * 1024 - 1024   # dynamic shared memory a block may ask for
                               # (kSmemMax in the source)
ROUTES = ("shared", "global")
_FN = None


def batch_slots(b: int) -> int:
    """Slots of the batch table: a power of two >= 2B, at least 32."""
    m = 32
    while m < 2 * b:
        m *= 2
    return m


def batch_bytes(b: int) -> int:
    """Bytes of the batch table (`batch_bytes` in the source)."""
    m = batch_slots(b)
    return 8 * m + 8 * (m + 1) + 4 * (m + 1) + 4 * b


def max_shared_n(b: int) -> int:
    """The largest table that takes the shared route with a batch of B."""
    return (SMEM_MAX - batch_bytes(b)) // 24


def plan(n: int, b: int, route: str | None = None) -> tuple[str, bool]:
    """(route, batch table in shared memory) for a table of n slots and a
    batch of B events; `route` forces one (the tests reach the global route
    at small sizes with it)."""
    fits = n <= max_shared_n(b)
    if route is None:
        route = "shared" if fits else "global"
    if route not in ROUTES:
        raise ValueError(f"hash_fetch_add_batch: route {route!r} not in "
                         f"{ROUTES}")
    if route == "shared" and not fits:
        raise ValueError(f"hash_fetch_add_batch: n={n}, B={b} does not fit "
                         "the shared route")
    return route, route == "shared" or batch_bytes(b) <= SMEM_MAX


def _fn():
    global _FN
    if _FN is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        _FN = build.function("hash_update", "repro_hash_fetch_add_batch",
                             [p, p, p, p, p, p, ll, p, p, p, i, i, i, p, p,
                              p])
    return _FN


def hash_fetch_add_batch_cuda(keys_tbl, used_tbl, vals_tbl, keys, deltas,
                              valid, route: str | None = None):
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
    if not 0 < n < 2**31 or b >= 2**28:
        raise ValueError(f"hash_fetch_add_batch: sizes n={n}, B={b} out of "
                         "range")
    route, batch_in_smem = plan(n, b, route)
    kt, ut, vt = (torch.empty_like(keys_tbl), torch.empty_like(used_tbl),
                  torch.empty_like(vals_tbl))
    scratch = None if batch_in_smem else \
        torch.empty(batch_bytes(b), dtype=torch.uint8, device=dev)
    counters, stream = build.device_scratch("hash_update", dev, 16)
    with build.device_guard(dev):
        rc = _fn()(keys_tbl.data_ptr(), used_tbl.data_ptr(),
                   vals_tbl.data_ptr(), kt.data_ptr(), ut.data_ptr(),
                   vt.data_ptr(), n, keys.data_ptr(), deltas.data_ptr(),
                   valid.data_ptr(), b, batch_slots(b),
                   int(route == "shared"),
                   None if scratch is None else scratch.data_ptr(),
                   counters.data_ptr(), stream)
    build.check(rc, "hash_fetch_add_batch")
    LAUNCHES += 1
    if telemetry.on():
        telemetry.count("probe.hash_fetch_add", telemetry.shapes(
            keys_tbl, used_tbl, vals_tbl, keys, deltas, valid))
    return kt, ut, vt
