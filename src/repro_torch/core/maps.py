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
