"""eBPF maps: shared state between probe programs, the host control plane
and the model step.

Each map kind has two twin implementations with IDENTICAL semantics:
  * torch ops (predicated, functional) -- used by the bytecode->torch JIT so
    map updates run on the device inside the step;
  * numpy ops (in-place) -- used by the reference interpreter (the "ubpf"
    oracle) and by host-side ("kernel-mode") probes.

Kinds (subset of Linux's bpf_map_type):
  ARRAY         values i64[N], key = index
  HASH          fixed-capacity open-addressing (linear probe), i64 key/value
  PERCPU_ARRAY  values i64[S, N], one row per device shard
  LOG2HIST      64 power-of-two latency-style bins (bcc's log2 histogram)
  RINGBUF       i64[cap, width] records + monotonic head + dropped counter

Values are 64-bit integers, faithful to eBPF's word size. map_lookup returns
the value (not a pointer). HASH `used` is tri-state: 0 empty, 1 occupied,
2 tombstone.

The torch twins take 0-dim int64 tensors for key/value/delta and a 0-dim
bool tensor `pred`, and return new state dicts; the caller's tensors are
never written.
"""
from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np
import torch

from . import u64 as U

_HASH_MULT = U.HASH_MULT
_U64 = U.U64_FULL
I64 = torch.int64


class MapKind(enum.Enum):
    ARRAY = "array"
    HASH = "hash"
    PERCPU_ARRAY = "percpu_array"
    LOG2HIST = "log2hist"
    RINGBUF = "ringbuf"


@dataclass(frozen=True)
class MapSpec:
    name: str
    kind: MapKind
    max_entries: int = 64
    # RINGBUF record width in i64 lanes; PERCPU shard count.
    rec_width: int = 4
    num_shards: int = 1
    flags: dict = field(default_factory=dict)

    def validate(self) -> None:
        if self.max_entries <= 0:
            raise ValueError(f"map {self.name}: max_entries must be > 0")
        if self.kind == MapKind.RINGBUF and self.rec_width <= 0:
            raise ValueError(f"map {self.name}: rec_width must be > 0")


# --------------------------------------------------------------------------
# state construction
# --------------------------------------------------------------------------

def _shapes(spec: MapSpec) -> dict:
    n = spec.max_entries
    if spec.kind == MapKind.ARRAY:
        return {"values": (n,)}
    if spec.kind == MapKind.HASH:
        return {"keys": (n,), "used": (n,), "values": (n,)}
    if spec.kind == MapKind.PERCPU_ARRAY:
        return {"values": (spec.num_shards, n)}
    if spec.kind == MapKind.LOG2HIST:
        return {"bins": (64,)}
    if spec.kind == MapKind.RINGBUF:
        return {"data": (n, spec.rec_width), "head": (1,), "dropped": (1,)}
    raise ValueError(spec.kind)


def init_state(spec: MapSpec, device="cuda") -> dict:
    """The torch state dict for one map, zeroed, on `device`."""
    from ..device import resolve
    dev = resolve(device)
    return {f: torch.zeros(s, dtype=I64, device=dev)
            for f, s in _shapes(spec).items()}


def init_states(specs: list[MapSpec], device="cuda") -> dict:
    from ..device import resolve
    dev = resolve(device)
    for s in specs:
        s.validate()
    return {s.name: init_state(s, dev) for s in specs}


def init_state_np(spec: MapSpec) -> dict:
    """The numpy state dict for one map (host maps, oracle)."""
    return {f: np.zeros(s, np.int64) for f, s in _shapes(spec).items()}


def init_states_np(specs: list[MapSpec]) -> dict:
    for s in specs:
        s.validate()
    return {s.name: init_state_np(s) for s in specs}


# --------------------------------------------------------------------------
# shared helpers
# --------------------------------------------------------------------------

def _np_hash_idx(key: int, n: int) -> int:
    h = (int(key) * _HASH_MULT) & _U64
    return int((h >> 33) % n)


def np_log2_bin(v: int) -> int:
    v = int(v)
    if v <= 0:
        return 0
    return min(63, v.bit_length())


_POW2 = np.array([1 << k for k in range(63)], dtype=np.int64)
_POW2_T: dict = {}


def pow2(device) -> torch.Tensor:
    """The 63 powers of two as an int64 tensor on `device` (cached)."""
    key = torch.device(device)
    if key not in _POW2_T:
        _POW2_T[key] = torch.as_tensor(_POW2, device=key)
    return _POW2_T[key]


def log2_bin(v):
    """bin = min(63, bit_length(v)) for v > 0, else 0; any shape."""
    flat = v.reshape(-1).contiguous()
    b = torch.searchsorted(pow2(v.device), flat, right=True)
    b = torch.where(flat <= 0, torch.zeros_like(b), b.clamp(max=63))
    return b.reshape(v.shape)


# --------------------------------------------------------------------------
# torch ops (functional, predicated). `pred` gates the side effect so the
# JIT can if-convert branches; lookups return 0 when not found / out of
# bounds.
# --------------------------------------------------------------------------

def _zero(like):
    return torch.zeros((), dtype=I64, device=like.device)


def t_array_lookup(st, key, pred):
    v = st["values"]
    n = v.shape[0]
    idx = key.clamp(0, n - 1)
    ok = pred & (key >= 0) & (key < n)
    return torch.where(ok, v[idx], _zero(v))


def t_array_update(st, key, value, pred):
    v = st["values"]
    n = v.shape[0]
    idx = key.clamp(0, n - 1)
    ok = pred & (key >= 0) & (key < n)
    new = v.clone()
    new[idx] = torch.where(ok, value, v[idx])
    return {"values": new}


def t_array_fetch_add(st, key, delta, pred):
    v = st["values"]
    n = v.shape[0]
    idx = key.clamp(0, n - 1)
    ok = pred & (key >= 0) & (key < n)
    old = torch.where(ok, v[idx], _zero(v))
    new = v.clone()
    new[idx] = v[idx] + torch.where(ok, delta, _zero(v))
    return {"values": new}, old


def t_percpu_lookup(st, shard, key, pred):
    v = st["values"]
    s, n = v.shape
    idx = key.clamp(0, n - 1)
    sh = shard.clamp(0, s - 1)
    ok = pred & (key >= 0) & (key < n)
    return torch.where(ok, v[sh, idx], _zero(v))


def t_percpu_fetch_add(st, shard, key, delta, pred):
    v = st["values"]
    s, n = v.shape
    idx = key.clamp(0, n - 1)
    sh = shard.clamp(0, s - 1)
    ok = pred & (key >= 0) & (key < n)
    old = torch.where(ok, v[sh, idx], _zero(v))
    new = v.clone()
    new[sh, idx] = v[sh, idx] + torch.where(ok, delta, _zero(v))
    return {"values": new}, old


def _t_hash_find(st, key):
    """(slot, found, free_slot, has_free) via a full linear probe from the
    home slot -- the twin of the numpy `_n_hash_find`. Probe chains end at
    EMPTY slots only; tombstones keep chains intact; inserts take the
    first tombstone-or-empty slot in probe order."""
    kt, ut = st["keys"], st["used"]
    n = kt.shape[0]
    ar = torch.arange(n, dtype=I64, device=kt.device)
    start = U.hash_home(key, n)
    order = (start + ar) % n
    u = ut[order]
    occupied = u == 1
    match = occupied & (kt[order] == key)
    free = ~occupied
    empty = u == 0
    big = torch.full_like(ar, n)
    first_match = torch.where(match, ar, big).min()
    first_free = torch.where(free, ar, big).min()
    first_empty = torch.where(empty, ar, big).min()
    found = (first_match < n) & (first_match < first_empty)
    has_free = first_free < n
    slot = order[first_match.clamp(0, n - 1)]
    free_slot = order[first_free.clamp(0, n - 1)]
    return slot, found, free_slot, has_free


def t_hash_lookup(st, key, pred):
    slot, found, _, _ = _t_hash_find(st, key)
    v = st["values"]
    return torch.where(pred & found, v[slot], _zero(v))


def _hash_write(st, tgt, ok, key, value):
    kt, ut, vt = st["keys"].clone(), st["used"].clone(), st["values"].clone()
    kt[tgt] = torch.where(ok, key, st["keys"][tgt])
    ut[tgt] = torch.where(ok, torch.ones_like(key), st["used"][tgt])
    vt[tgt] = torch.where(ok, value, st["values"][tgt])
    return {"keys": kt, "used": ut, "values": vt}


def t_hash_update(st, key, value, pred):
    slot, found, free_slot, has_free = _t_hash_find(st, key)
    tgt = torch.where(found, slot, free_slot)
    ok = pred & (found | has_free)
    return _hash_write(st, tgt, ok, key, value), (found | has_free)


def t_hash_fetch_add(st, key, delta, pred):
    slot, found, free_slot, has_free = _t_hash_find(st, key)
    tgt = torch.where(found, slot, free_slot)
    ok = pred & (found | has_free)
    v = st["values"]
    old = torch.where(pred & found, v[slot], _zero(v))
    newv = torch.where(found, v[slot] + delta, delta)
    return _hash_write(st, tgt, ok, key, newv), old


def t_hash_fetch_add_batch(st, keys, deltas, ok):
    """Batched hash fetch-add over a whole event batch: end state is
    bit-identical to applying `t_hash_fetch_add` over the valid lanes in
    batch order (fetch-add results are not produced -- the caller has
    verified they are dead). The work goes through `kernels.ops`: the
    Hopper kernel for a CUDA table, the plain sequential version on the
    CPU."""
    from ..kernels import ops
    kt, ut, vt = ops.hash_fetch_add_batch(st["keys"], st["used"],
                                          st["values"], keys, deltas, ok)
    return {"keys": kt, "used": ut, "values": vt}


def t_hash_delete(st, key, pred):
    # tombstone delete: the slot becomes insertable (used=2) but keeps
    # probe chains intact, so deleting one key never unreaches another
    slot, found, _, _ = _t_hash_find(st, key)
    ok = pred & found
    used = st["used"].clone()
    used[slot] = torch.where(ok, torch.full_like(key, 2), st["used"][slot])
    return {"keys": st["keys"], "used": used, "values": st["values"]}, found


def t_hist_add(st, value, pred):
    b = log2_bin(value)
    bins = st["bins"].clone()
    bins[b] = st["bins"][b] + pred.to(I64)
    return {"bins": bins}


def t_ringbuf_emit(st, record, pred):
    """record: i64[width]. Overwrite mode (head always advances when pred);
    once the head laps capacity each emit overwrites an unread record and
    bumps the `dropped` counter."""
    data = st["data"]
    cap = data.shape[0]
    head = st["head"][0]
    slot = head % cap
    new = data.clone()
    new[slot] = torch.where(pred, record, data[slot])
    p = pred.to(I64)
    return {"data": new, "head": st["head"] + p,
            "dropped": st["dropped"] + (p * (head >= cap).to(I64))}


# --------------------------------------------------------------------------
# numpy twins (in-place) -- oracle + host-side maps
# --------------------------------------------------------------------------

def n_array_lookup(st, key):
    n = st["values"].shape[0]
    return int(st["values"][key]) if 0 <= key < n else 0


def n_array_update(st, key, value):
    n = st["values"].shape[0]
    if 0 <= key < n:
        st["values"][key] = _to_i64(value)


def n_array_fetch_add(st, key, delta):
    n = st["values"].shape[0]
    if not 0 <= key < n:
        return 0
    old = int(st["values"][key])
    st["values"][key] = _to_i64((old + delta))
    return old


def _to_i64(v: int):
    v &= _U64
    return np.int64(v - (1 << 64)) if v >> 63 else np.int64(v)


def _n_hash_find(st, key):
    """`used` is tri-state (0 empty, 1 occupied, 2 tombstone): the match
    scan terminates at the first EMPTY slot only -- tombstones keep probe
    chains intact; the free slot is the first tombstone-or-empty in probe
    order (tombstones are reused by inserts)."""
    n = st["keys"].shape[0]
    start = _np_hash_idx(key, n)
    free = None
    for j in range(n):
        i = (start + j) % n
        u = int(st["used"][i])
        if u == 1:
            if int(st["keys"][i]) == _s64(key):
                return i, None
        elif free is None:
            free = i
        if u == 0:
            return None, free       # chain ends: no match past this point
    return None, free


def _s64(v: int) -> int:
    v &= _U64
    return v - (1 << 64) if v >> 63 else v


def n_hash_lookup(st, key):
    slot, _ = _n_hash_find(st, key)
    return int(st["values"][slot]) if slot is not None else 0


def n_hash_update(st, key, value):
    slot, free = _n_hash_find(st, key)
    tgt = slot if slot is not None else free
    if tgt is None:
        return False
    st["keys"][tgt] = _to_i64(key)
    st["used"][tgt] = 1
    st["values"][tgt] = _to_i64(value)
    return True


def n_hash_fetch_add(st, key, delta):
    slot, free = _n_hash_find(st, key)
    if slot is not None:
        old = int(st["values"][slot])
        st["values"][slot] = _to_i64(old + delta)
        return old
    if free is not None:
        st["keys"][free] = _to_i64(key)
        st["used"][free] = 1
        st["values"][free] = _to_i64(delta)
    return 0


def n_hash_delete(st, key):
    # tombstone delete (used=2), twin of t_hash_delete
    slot, _ = _n_hash_find(st, key)
    if slot is None:
        return False
    st["used"][slot] = 2
    return True


def n_hist_add(st, value):
    st["bins"][np_log2_bin(value)] += 1


def n_ringbuf_emit(st, record):
    cap = st["data"].shape[0]
    head = int(st["head"][0])
    slot = head % cap
    st["data"][slot, :len(record)] = [_to_i64(x) for x in record]
    st["head"][0] += 1
    if head >= cap:                    # lapped: overwrote an unread record
        st["dropped"][0] += 1


def n_ringbuf_drain(st, last_read: int) -> tuple[list[list[int]], int]:
    """Read records in [last_read, head); returns (records, new_cursor).
    Skips overwritten records (reports via dropped semantics)."""
    cap = st["data"].shape[0]
    head = int(st["head"][0])
    lo = max(last_read, head - cap)
    out = [list(map(int, st["data"][i % cap])) for i in range(lo, head)]
    return out, head


def _np_hash_idx_vec(keys: np.ndarray, n: int) -> np.ndarray:
    with np.errstate(over="ignore"):
        h = keys.astype(np.uint64) * np.uint64(_HASH_MULT)
    return ((h >> np.uint64(33)) % np.uint64(n)).astype(np.int64)


def _np_next_free_dist(used: np.ndarray) -> np.ndarray:
    """Probe-order distance from every start position to the first free
    slot (>= n when the table is full)."""
    n = used.shape[0]
    free2 = np.concatenate([~used, ~used])
    pos = np.arange(2 * n)
    cand = np.where(free2, pos, 2 * n)
    suffix_min = np.minimum.accumulate(cand[::-1])[::-1]
    return (suffix_min[:n] - np.arange(n)).astype(np.int64)


def n_hash_slots(st) -> dict[int, int]:
    """{key: slot} for every probe-REACHABLE entry. Entry j holding key k
    is lookup-visible iff its probe distance (j - hash(k)) mod n is below
    the first-free distance from hash(k); duplicate keys (broken chains)
    resolve to the smallest probe distance, exactly as a sequential probe
    would find them."""
    kt = np.asarray(st["keys"], np.int64)
    u = np.asarray(st["used"], np.int64)
    occupied = u == 1
    nonempty = u != 0                   # occupied or tombstone: chain lives on
    n = kt.shape[0]
    if not occupied.any():
        return {}
    j = np.arange(n)
    start = _np_hash_idx_vec(kt, n)
    dist = (j - start) % n
    reach = occupied & (dist < _np_next_free_dist(nonempty)[start])
    out: dict[int, int] = {}
    for idx in np.lexsort((dist, kt)):
        if reach[idx]:
            k = int(kt[idx])
            if k not in out:
                out[k] = int(idx)
    return out


def n_hash_items(st) -> dict[int, int]:
    """Lookup-visible content of a hash table: {key: value}."""
    vals = np.asarray(st["values"], np.int64)
    return {k: int(vals[s]) for k, s in n_hash_slots(st).items()}


def n_hash_fetch_add_batch(st, keys, deltas, ok=None) -> None:
    """numpy twin of t_hash_fetch_add_batch (in-place): end state is
    bit-identical to applying n_hash_fetch_add sequentially over the valid
    lanes in batch order. Two phases: resident keys via one reachable slot
    lookup + accumulate; missing keys inserted in first-occurrence order
    with group-summed deltas, re-probing after each insert."""
    keys = np.asarray(keys, np.int64)
    deltas = np.asarray(deltas, np.int64)
    B = keys.shape[0]
    ok = np.ones(B, bool) if ok is None else np.asarray(ok, bool)
    if not ok.any():
        return
    slot_of = n_hash_slots(st)
    slots = np.array([slot_of.get(int(k), -1) for k in keys])
    resident = ok & (slots >= 0)
    with np.errstate(over="ignore"):
        np.add.at(st["values"], slots[resident], deltas[resident])
    pending = ok & ~resident
    for i in range(B):
        if not pending[i]:
            continue
        k = int(keys[i])
        group = ok & (keys == keys[i])
        with np.errstate(over="ignore"):
            d = int(np.sum(deltas[group], dtype=np.int64))
        slot, free = _n_hash_find(st, k)
        tgt = slot if slot is not None else free
        if tgt is not None:                        # table full -> drop
            old = int(st["values"][tgt]) if slot is not None else 0
            st["keys"][tgt] = _to_i64(k)
            st["used"][tgt] = 1
            st["values"][tgt] = _to_i64(old + d)
        pending &= ~group


# --------------------------------------------------------------------------
# interprocess merge plane (DESIGN.md §10): per-kind DELTA extraction and
# COMMUTATIVE merge twins. Worker processes publish cumulative seqlocked
# snapshots; the aggregation engine extracts per-cycle deltas against its
# last-seen baseline and folds them into one global view. Merges commute
# across workers for the ops the differential harness admits:
#   * ARRAY / PERCPU_ARRAY / LOG2HIST -- element-wise delta-sum (adds
#     commute unconditionally);
#   * HASH -- content delta over probe-REACHABLE entries, merged by the
#     batched first-occurrence machinery of n_hash_fetch_add_batch; per-key
#     sums commute, and non-commutative ops (update/delete) commute across
#     workers iff each key is owned by one worker -- the sharded-aggregation
#     contract;
#   * RINGBUF -- records are tagged (step, wid, seq) and interleaved by that
#     key; the global order is a deterministic merge-sort of per-worker
#     streams, with dropped counts derived from the global head.
# The torch twins (t_summary_*, t_hash_coalesce, t_group_summary_fold*) run
# the node-level folds on a device; they return host arrays bit for bit the
# numpy twins'.
# --------------------------------------------------------------------------

SUMMARY_FIELDS = {
    MapKind.ARRAY: ("values",),
    MapKind.PERCPU_ARRAY: ("values",),
    MapKind.LOG2HIST: ("bins",),
}


def is_summary_kind(kind: MapKind) -> bool:
    return kind in SUMMARY_FIELDS


def n_summary_delta(spec: MapSpec, cur: dict, base: dict) -> dict:
    """Element-wise delta of two cumulative snapshots (wrapping i64)."""
    return {f: np.asarray(cur[f], np.int64) - np.asarray(base[f], np.int64)
            for f in SUMMARY_FIELDS[spec.kind]}


def n_summary_merge(spec: MapSpec, acc: dict, delta: dict) -> None:
    """In-place commutative fold of one delta into the accumulator."""
    for f in SUMMARY_FIELDS[spec.kind]:
        acc[f] += delta[f]


def _on(a, dev) -> torch.Tensor:
    return torch.as_tensor(a, dtype=I64, device=dev)


def t_summary_delta(spec: MapSpec, cur: dict, base: dict,
                    device="cuda") -> dict:
    """torch twin of n_summary_delta: int64 tensors on `device`."""
    from ..device import resolve
    dev = resolve(device)
    return {f: _on(cur[f], dev) - _on(base[f], dev)
            for f in SUMMARY_FIELDS[spec.kind]}


def t_summary_merge(spec: MapSpec, acc: dict, delta: dict,
                    device="cuda") -> dict:
    """torch twin of n_summary_merge, functional: new tensors on
    `device`; the accumulator is not written."""
    from ..device import resolve
    dev = resolve(device)
    return {f: _on(acc[f], dev) + _on(delta[f], dev)
            for f in SUMMARY_FIELDS[spec.kind]}


def n_hash_delta(cur_items: dict, base_items: dict
                 ) -> tuple[list[tuple[int, int]], list[int]]:
    """Content delta between two cumulative snapshots of one worker's hash
    map: (adds, dels). adds = (key, value-delta) for new or changed keys
    (new keys are included even at delta 0 so inserts propagate); dels =
    keys the worker deleted since the baseline. Sorted by key so a given
    (cur, base) pair always yields the same batch."""
    adds = []
    for k in sorted(cur_items):
        d = cur_items[k] - base_items.get(k, 0)
        if d != 0 or k not in base_items:
            adds.append((k, d))
    dels = sorted(k for k in base_items if k not in cur_items)
    return adds, dels


def n_hash_canonical(spec: MapSpec, items: dict) -> dict:
    """Deterministic table layout for a given content: rebuild by inserting
    keys in sorted order. Published global hash maps use this form, so the
    merged view is bit-stable regardless of worker poll order; the
    differential harness compares it against the canonicalized oracle."""
    st = init_state_np(spec)
    for k in sorted(items):
        n_hash_update(st, k, items[k])
    return st


# ---- ringbuf: tagged drain + deterministic global interleave

def n_ringbuf_tagged(st, wid, lo: int = 0, step_lane: int | None = None
                     ) -> tuple[list[tuple[tuple, np.ndarray]], int]:
    """Drain retained records with monotonic position >= lo, each tagged
    with its global interleave key (step, wid, seq): seq is the record's
    position in this worker's stream; step comes from the record lane the
    map spec designates (flags={'step_lane': k}), else 0 -- reducing the
    interleave to concatenation by wid."""
    cap = st["data"].shape[0]
    head = int(st["head"][0])
    start = max(lo, head - cap)
    out = []
    for i in range(start, head):
        rec = np.array(st["data"][i % cap])
        step = int(rec[step_lane]) if step_lane is not None else 0
        out.append(((step, wid, i), rec))
    return out, head


# ---- tree aggregation plane (DESIGN.md §15): vectorized content twins,
# ---- batched group folds, and hash keyspace sharding

_EMPTY_I64 = np.zeros(0, np.int64)


def n_hash_content(st) -> tuple[np.ndarray, np.ndarray]:
    """Vectorized twin of n_hash_items: the lookup-visible content of a hash
    table as sorted parallel arrays (keys, values) -- no per-entry Python
    loop, so a node aggregator can extract its whole group's content at
    numpy speed. dict(zip(*n_hash_content(st))) == n_hash_items(st)."""
    kt = np.asarray(st["keys"], np.int64)
    u = np.asarray(st["used"], np.int64)
    occupied = u == 1
    nonempty = u != 0
    n = kt.shape[0]
    if not occupied.any():
        return _EMPTY_I64, _EMPTY_I64
    j = np.arange(n)
    start = _np_hash_idx_vec(kt, n)
    dist = (j - start) % n
    reach = occupied & (dist < _np_next_free_dist(nonempty)[start])
    idx = np.nonzero(reach)[0]
    if idx.size == 0:
        return _EMPTY_I64, _EMPTY_I64
    # duplicate keys (broken chains) resolve to the smallest probe
    # distance, exactly like n_hash_slots' sequential scan
    order = np.lexsort((dist[idx], kt[idx]))
    sk = kt[idx][order]
    first = np.concatenate([[True], sk[1:] != sk[:-1]])
    sel = idx[order][first]
    return kt[sel], np.asarray(st["values"], np.int64)[sel]


def n_hash_delta_arrays(cur_k: np.ndarray, cur_v: np.ndarray,
                        base_k: np.ndarray, base_v: np.ndarray
                        ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Vectorized twin of n_hash_delta over sorted content arrays:
    (add_keys, add_deltas, del_keys). New keys are included even at delta 0
    (inserts must propagate); all outputs sorted by key."""
    cur_k = np.asarray(cur_k, np.int64)
    base_k = np.asarray(base_k, np.int64)
    if base_k.size == 0:
        return cur_k, np.asarray(cur_v, np.int64), _EMPTY_I64
    pos = np.searchsorted(base_k, cur_k)
    posc = np.minimum(pos, base_k.size - 1)
    in_base = (pos < base_k.size) & (base_k[posc] == cur_k)
    with np.errstate(over="ignore"):
        d = np.asarray(cur_v, np.int64) - \
            np.where(in_base, np.asarray(base_v, np.int64)[posc], 0)
    keep = (d != 0) | ~in_base
    if cur_k.size == 0:
        return _EMPTY_I64, _EMPTY_I64, base_k
    bpos = np.searchsorted(cur_k, base_k)
    bposc = np.minimum(bpos, cur_k.size - 1)
    in_cur = (bpos < cur_k.size) & (cur_k[bposc] == base_k)
    return cur_k[keep], d[keep], base_k[~in_cur]


def n_hash_coalesce(keys: np.ndarray, deltas: np.ndarray
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Commutative coalesce of a fetch-add batch: per-key delta sums, keys
    sorted. Zero-sum keys are KEPT -- an insert at delta 0 must still
    propagate up the tree. The numpy twin of t_hash_coalesce."""
    keys = np.asarray(keys, np.int64)
    deltas = np.asarray(deltas, np.int64)
    if keys.size == 0:
        return _EMPTY_I64, _EMPTY_I64
    uk, inv = np.unique(keys, return_inverse=True)
    ud = np.zeros(uk.size, np.int64)
    with np.errstate(over="ignore"):
        np.add.at(ud, inv, deltas)
    return uk, ud


def t_hash_coalesce(keys, deltas, device="cuda"
                    ) -> tuple[np.ndarray, np.ndarray]:
    """Device-side coalesce (sorted unique + int64 segment sum) of a whole
    worker group's concatenated fetch-add batch. Returns compacted host
    arrays, bit for bit n_hash_coalesce: keys ascending, zero-sum keys
    kept, sums wrapping in i64."""
    from ..device import resolve
    dev = resolve(device)
    keys = np.asarray(keys, np.int64)
    deltas = np.asarray(deltas, np.int64)
    if keys.size == 0:
        return _EMPTY_I64, _EMPTY_I64
    kd = torch.from_numpy(np.stack([keys, deltas])).to(dev)
    uk, inv = torch.unique(kd[0], sorted=True, return_inverse=True)
    sums = torch.zeros(uk.shape[0], dtype=I64, device=dev)
    sums.index_add_(0, inv, kd[1])
    out = torch.cat([uk, sums]).cpu().numpy()
    return out[:uk.shape[0]], out[uk.shape[0]:]


def n_group_summary_fold(spec: MapSpec, acc: dict, cur_stack: dict,
                         base_stack: dict) -> dict:
    """numpy twin of t_group_summary_fold (wrapping i64)."""
    out = {}
    for f in SUMMARY_FIELDS[spec.kind]:
        with np.errstate(over="ignore"):
            out[f] = acc[f] + np.sum(
                np.asarray(cur_stack[f], np.int64)
                - np.asarray(base_stack[f], np.int64), axis=0)
    return out


def n_group_summary_fold_multi(stacks: dict) -> dict:
    """numpy twin of t_group_summary_fold_multi (wrapping i64)."""
    out: dict = {}
    for n, d in stacks.items():
        out[n] = {}
        for f, (acc, cur, base) in d.items():
            with np.errstate(over="ignore"):
                out[n][f] = np.asarray(acc, np.int64) + np.sum(
                    np.asarray(cur, np.int64)
                    - np.asarray(base, np.int64), axis=0)
    return out


def t_group_summary_fold_multi(stacks: dict, device="cuda") -> dict:
    """ONE device pass folds every summary spec's worker-group delta:
    stacks[name][field] = (acc, cur_stack, base_stack) with (W, *shape)
    stacks. Every leaf is packed into one int64 host buffer -- per group
    size W a [1 + 2W, N] block: row 0 the accumulators, rows 1..W the
    current snapshots, rows W+1..2W the baselines, leaves side by side --
    copied to the device once, folded as acc + sum_w(cur - base), and
    copied back once. Returns {name: {field: host array}}, bit for bit
    n_group_summary_fold_multi."""
    from ..device import resolve
    dev = resolve(device)
    groups: dict[int, list] = {}
    for n, d in stacks.items():
        for f, (acc, cur, base) in d.items():
            cur = np.asarray(cur, np.int64)
            groups.setdefault(cur.shape[0], []).append(
                (n, f, np.asarray(acc, np.int64), cur,
                 np.asarray(base, np.int64)))
    out: dict = {n: {} for n in stacks}
    if not groups:
        return out
    blocks, layout, col = [], [], 0
    for w, grp in groups.items():
        blk = np.empty((1 + 2 * w, sum(g[2].size for g in grp)), np.int64)
        c = 0
        for n, f, acc, cur, base in grp:
            k = acc.size
            blk[0, c:c + k] = acc.reshape(-1)
            blk[1:1 + w, c:c + k] = cur.reshape(w, k)
            blk[1 + w:, c:c + k] = base.reshape(w, k)
            layout.append((n, f, acc.shape, col + c, k))
            c += k
        blocks.append(blk)
        col += c
    packed = torch.from_numpy(np.concatenate(
        [b.reshape(-1) for b in blocks])).to(dev)
    folded, start = [], 0
    for blk in blocks:
        p = packed[start:start + blk.size].view(blk.shape)
        w = (blk.shape[0] - 1) // 2
        folded.append(p[0] + (p[1:1 + w] - p[1 + w:]).sum(0))
        start += blk.size
    host = torch.cat(folded).cpu().numpy()
    for n, f, shape, c, k in layout:
        out[n][f] = host[c:c + k].reshape(shape)
    return out


def t_group_summary_fold(spec: MapSpec, acc: dict, cur_stack: dict,
                         base_stack: dict, device="cuda") -> dict:
    """torch twin of n_group_summary_fold: acc[f] + sum_w(cur[w][f] -
    base[w][f]) in one device pass; returns host arrays."""
    return t_group_summary_fold_multi(
        {spec.name: {f: (acc[f], cur_stack[f], base_stack[f])
                     for f in SUMMARY_FIELDS[spec.kind]}}, device)[spec.name]


def n_shard_of_keys(keys: np.ndarray, n: int, n_shards: int) -> np.ndarray:
    """Keyspace partition for sharded global views: a key's shard is its
    home slot (the same splitmix64 probe start every lookup uses) mod the
    shard count -- every key lands in exactly one shard, and co-homed keys
    stay together."""
    keys = np.asarray(keys, np.int64)
    if keys.size == 0:
        return _EMPTY_I64
    return (_np_hash_idx_vec(keys, n) % n_shards).astype(np.int64)


def n_shard_of_key(key: int, n: int, n_shards: int) -> int:
    return _np_hash_idx(key, n) % n_shards


def ringbuf_merge_global(spec: MapSpec, tagged: list, total: int) -> dict:
    """Build the global ringbuf state from every worker's retained tagged
    records. The merged order sorts by (step, wid, seq); the global state is
    exactly what one ring of the same capacity would hold after emitting the
    merged sequence: data holds the last `cap` records at their global
    rank mod cap, head counts every emit, dropped counts emits that
    overwrote an unread record (total - cap, clamped at 0).

    Window argument (DESIGN.md §10): each worker's sort key is monotone in
    its emit order, so the global tail's restriction to worker w is a suffix
    of w's stream of length <= cap -- always within what w's own ring still
    retains. The tail of the retained union therefore IS the global tail."""
    st = init_state_np(spec)
    cap = spec.max_entries
    recs = sorted(tagged, key=lambda t: t[0])
    tail = recs[-cap:]
    k = len(tail)
    for i, (_, rec) in enumerate(tail):
        rank = total - k + i
        st["data"][rank % cap, :] = rec
    st["head"][0] = total
    st["dropped"][0] = max(0, total - cap)
    return st
