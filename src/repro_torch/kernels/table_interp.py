"""The live lane's program-table interpreter as one kernel launch.

No Pallas kernel precedes it: in the JAX package the interpreter is jnp/lax
inside the compiled step (`src/repro/core/table_interp.py`, `_build_core`
:88 and `_build_batched_core` :573). The CUDA source is
`csrc/table_interp.cu`; its plain PyTorch version is
`core.table_interp.run_plain`, which the CPU takes.

Bound on an H100: latency -- the table, the tape and the maps are
kilobytes; the time is the instruction walk. Design: one block. Copy-in
decodes the packed table into one 32-byte record per instruction in shared
memory; thread 0 walks the sequential slots over the tape with its register
file and frame in shared memory; each vec lane runs free on a thread, with
exact 64-bit atomics for the commutative adds, and pauses only at a HASH
fetch-add, which warp 0 applies in (machine step, lane) order, one barrier
round per distinct step. The kernel writes every map state and the aux
block to outputs this wrapper allocates, so the inputs (the state a step
started from) are never written.

Routes (`layout`, from the map universe and the table's and the tape's
shapes, never the table's contents): the map states sit in shared memory
during the launch when they fit beside the records and the lanes
("shared"), else in device memory ("global"); the tape sits in shared
memory when it fits after them ("shared"), else the sequential walk stages
its rows ahead through a ring ("ring").
"""
from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from . import build

LAUNCHES = 0
MAX_MAPS = 24
LANE_WORDS = 32
AUX_WORDS = 23
THREADS = 512                 # kThreads
VEC_WORDS = 19                # a running vec lane's registers and stack
RING_ROWS = 8                 # kRing
REC_WORDS = 4                 # a decoded instruction record
SEQ_WORDS = 80                # the sequential sub-lane's registers, frame
SMEM_MAX = 227 * 1024 - 4096       # the block's shared memory, less static
# map kind -> the kernel's code and its state fields, in the kernel's order
KINDS = {"array": (0, ("values",)), "hash": (1, ("keys", "used", "values")),
         "percpu_array": (2, ("values",)), "log2hist": (3, ("bins",)),
         "ringbuf": (4, ("data", "head", "dropped"))}
AUX_IN = ("time_ns", "cpu", "pid", "rand", "override_set", "override_val",
          "printk_buf", "printk_n")

_p = ctypes.c_void_p
# the kernel's Params as i64 words: table, rows, aux_in[8], aux_out, r0,
# lanes, P, N, E, ctx_words, nmaps, match_all, maps_shared,
# tape_shared, sm_meta, sm_slots, sm_lanes, lane_stride, sm_maps, sm_tape;
# then per map: kind, n, width, shards, len[3], in[3], out[3]
HEAD_WORDS = 27
DESC_WORDS = 13
PARAMS_WORDS = HEAD_WORDS + DESC_WORDS * MAX_MAPS
(W_TABLE, W_ROWS, W_AUX_IN, W_AUX_OUT, W_R0, W_LANES, W_P, W_N, W_E, W_CW,
 W_NMAPS, W_MATCH_ALL, W_MAPS_SHARED, W_TAPE_SHARED,
 W_SM_META) = (0, 1, 2, 10, 11, 12, 13, 14, 15, 16, 17, 18, 19, 20, 21)


_FN = None


def _fn():
    global _FN
    if _FN is None:
        sizes = build.function("table_interp", "repro_table_interp_sizes",
                               [_p] * 9)
        vals = [ctypes.c_int() for _ in range(9)]
        sizes(*[ctypes.byref(v) for v in vals])
        want = (8 * PARAMS_WORDS, MAX_MAPS, LANE_WORDS, AUX_WORDS, THREADS,
                VEC_WORDS, RING_ROWS, REC_WORDS, SEQ_WORDS)
        if tuple(v.value for v in vals) != want:
            raise RuntimeError("table_interp: the kernel's parameter layout "
                               f"{[v.value for v in vals]} differs from the "
                               f"wrapper's {list(want)}")
        _FN = build.function("table_interp", "repro_table_interp",
                             [_p, ctypes.c_int, _p])
    return _FN


@functools.lru_cache(maxsize=1)
def _check_helper_order():
    from ..core.helpers import HELPERS
    names = [HELPERS[h].name for h in sorted(HELPERS)]
    if names != ["map_lookup_elem", "map_update_elem", "map_delete_elem",
                 "ktime_get_ns", "trace_printk", "get_prandom_u32",
                 "get_smp_processor_id", "get_current_pid_tgid",
                 "ringbuf_output", "map_fetch_add", "log2",
                 "override_return", "hist_add", "percpu_fetch_add"]:
        raise RuntimeError(f"table_interp: helper order {names} differs from "
                           "the kernel's H_* indices")


def aux_views(buf) -> dict:
    """The aux dict over the kernel's packed aux output."""
    return {"time_ns": buf[0], "cpu": buf[1], "pid": buf[2], "rand": buf[3],
            "override_set": buf[4], "override_val": buf[5],
            "printk_n": buf[6], "printk_buf": buf[7:23].view(8, 2)}


@functools.lru_cache(maxsize=32)
def _plan(spec_key):
    """Everything about a launch that only the map universe decides, built
    once: the parameter words with each map's kind, sizes and field
    lengths; the words that take each input and output pointer; each
    field's offset in the output allocation and its shape."""
    from ..core.maps import _shapes
    from ..core.table_interp import _specs_from_key
    if len(spec_key) > MAX_MAPS:
        raise ValueError(f"table_interp: {len(spec_key)} maps, the kernel "
                         f"takes at most {MAX_MAPS}")
    _check_helper_order()
    words = np.zeros(PARAMS_WORDS, np.int64)
    words[W_NMAPS] = len(spec_key)
    fields, in_w, out_w, offsets = [], [], [], []
    off = 0
    for fd, spec in enumerate(_specs_from_key(spec_key)):
        base = HEAD_WORDS + DESC_WORDS * fd
        words[base:base + 4] = (KINDS[spec.kind.value][0], spec.max_entries,
                                spec.rec_width, spec.num_shards)
        for j, (f, shape) in enumerate(_shapes(spec).items()):
            n = int(np.prod(shape))
            words[base + 4 + j] = n
            fields.append((spec.name, f, shape, n))
            in_w.append(base + 7 + j)
            out_w.append(base + 10 + j)
            offsets.append(8 * off)
            off += n
    return (words, tuple(fields), np.array(in_w), np.array(out_w),
            np.array(offsets, np.int64), off)


@functools.lru_cache(maxsize=64)
def layout(map_words: int, P: int, N: int, E: int, cw: int) -> dict:
    """The launch's dynamic shared memory, in words: the sequential
    sub-lane's registers and frame, the records, meta, the sequential slot
    list, the running vec lanes (one column per thread that has a lane),
    the map states on the shared route, and the tape or the walk's ring;
    with the routes and the bytes asked for. It
    depends on the map universe's size and the table's and the tape's
    shapes only. Raises when the records and the lanes alone do not fit."""
    stride = min(E, THREADS)
    sm_meta = SEQ_WORDS + REC_WORDS * P * N
    sm_slots = sm_meta + 6 * P
    sm_lanes = sm_slots + 4 * P
    end = sm_lanes + VEC_WORDS * stride
    ring = RING_ROWS * cw
    if 8 * (end + ring) > SMEM_MAX:
        raise ValueError(f"table_interp: a table of {P} x {N} rows needs "
                         f"{8 * (end + ring)} B of shared memory with its "
                         f"lanes, more than the {SMEM_MAX} B a block has")
    maps_shared = 8 * (end + map_words + ring) <= SMEM_MAX
    sm_maps = end
    if maps_shared:
        end += map_words
    tape_shared = 8 * (end + E * cw) <= SMEM_MAX
    sm_tape = end
    end += E * cw if tape_shared else ring
    return {"maps": "shared" if maps_shared else "global",
            "tape": "shared" if tape_shared else "ring",
            "words": (sm_meta, sm_slots, sm_lanes, stride, sm_maps, sm_tape),
            "smem_bytes": 8 * end}


def plan(spec_key, P: int, N: int, E: int, cw: int) -> dict:
    """`layout` for the map universe `spec_key`."""
    return layout(_plan(spec_key)[-1], P, N, E, cw)


def table_interp_cuda(spec_key, table, rows, maps, aux, *,
                      match_all: bool = False, want_r0: bool = False):
    """One launch of the interpreter over `rows` i64[E, ctx_words] on a CUDA
    device. spec_key: the live table's map universe ((name, kind,
    max_entries, rec_width, num_shards) per fd); table: its device state
    ("packed" plus views); maps: {name: state} of those maps. Returns new
    (maps, aux, r0 i64[P, E] or None). The new map states, the aux block
    and the vec sub-lane's lane scratch are views of one allocation."""
    global LAUNCHES
    dev = rows.device
    build.require(rows, "table_interp rows", torch.int64, 2, dev)
    packed = table["packed"]
    build.require(packed, "table_interp table", torch.int64, 1, dev)
    P, N = table["hcls"].shape
    E, cw = rows.shape
    if not 0 < E < 2**31 or cw < 2:
        raise ValueError(f"table_interp: tape of shape {tuple(rows.shape)}")
    template, fields, in_w, out_w, offsets, total = _plan(spec_key)
    lay = layout(total, P, N, E, cw)
    ins = []
    for name, f, shape, _ in fields:
        t = maps[name][f]
        if t.device != dev or t.dtype != torch.int64 or \
                tuple(t.shape) != shape or not t.is_contiguous():
            raise ValueError(f"table_interp {name}.{f}: expected a "
                             f"contiguous int64 tensor of shape {shape} on "
                             f"{dev}, got {t.dtype} {tuple(t.shape)} on "
                             f"{t.device}")
        ins.append(t.data_ptr())
    words = template.copy()
    for j, f in enumerate(AUX_IN):
        t = aux[f]
        if t.device != dev or t.dtype != torch.int64 or \
                t.numel() != (16 if f == "printk_buf" else 1) or \
                not t.is_contiguous():
            raise ValueError(f"table_interp aux {f}: expected a contiguous "
                             f"int64 tensor on {dev}")
        words[W_AUX_IN + j] = t.data_ptr()
    scratch = E * LANE_WORDS + -(-E // 64)
    out = torch.empty(total + AUX_WORDS + scratch, dtype=torch.int64,
                      device=dev)
    base = out.data_ptr()
    words[in_w] = ins
    words[out_w] = base + offsets
    r0 = torch.zeros((P, E), dtype=torch.int64, device=dev) \
        if want_r0 else None
    words[W_TABLE], words[W_ROWS] = packed.data_ptr(), rows.data_ptr()
    words[W_AUX_OUT] = base + 8 * total
    words[W_LANES] = base + 8 * (total + AUX_WORDS)
    words[W_R0] = r0.data_ptr() if r0 is not None else 0
    words[W_P:W_CW + 1] = (P, N, E, cw)
    words[W_MATCH_ALL] = int(match_all)
    words[W_MAPS_SHARED] = int(lay["maps"] == "shared")
    words[W_TAPE_SHARED] = int(lay["tape"] == "shared")
    words[W_SM_META:W_SM_META + 6] = lay["words"]
    with build.device_guard(dev):
        rc = _fn()(words.ctypes.data, lay["smem_bytes"],
                   build.stream_ptr(dev))
    build.check(rc, "table_interp")
    LAUNCHES += 1
    parts = out.split([n for *_, n in fields] + [AUX_WORDS, scratch])
    out_maps: dict = {}
    for (name, f, shape, _), t in zip(fields, parts):
        out_maps.setdefault(name, {})[f] = t.view(shape) if len(shape) > 1 \
            else t
    return out_maps, aux_views(parts[len(fields)]), r0
