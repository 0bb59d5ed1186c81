"""Device-resident program-table interpreter -- live attach/detach without
rebuilding the step (the dispatch-as-data tier).

The fused/scan lanes (vectorized.py, jit.py) specialise the probe stage to
the attached program SET. This module runs ONE generic eBPF interpreter
whose behaviour is driven entirely by tensor DATA:

  * verified bytecode is packed by `isa.encode_table_program` into flat i64
    arrays (handler class, regs, immediates, pre-resolved jump targets,
    helper branch indices) and padded into a `max_programs x max_insns`
    table that rides inside the step's map state (`__live_table__`);
  * on a CUDA tape the interpreter is one kernel launch
    (`kernels/csrc/table_interp.cu` through `kernels.ops.table_interp_run`)
    whose launch arguments never depend on the table's contents;
  * on a CPU tape it is the plain PyTorch version below: `_seq_core`, a
    transcription of the JAX package's `_build_core` (fuel-bounded pc
    loop, handler classes, the helpers, the map switch), and
    `_batched_core`, a transcription of `_build_batched_core` (the
    lockstep machine over [B] lanes). The host steps both loops.

`BpftimeRuntime.attach(mode="table")` / `detach` only write table rows and
a generation counter; `sync_live_table` pushes them into the device buffers
in place, and the running step picks them up on its next call.

Semantics are bit-identical to scan mode (`jit.run_over_events`): the same
maps.t_* twins, the same predication, the same aux handling.
"""
from __future__ import annotations

import numpy as np
import torch

from . import isa, jit as J, maps as M, u64 as U
from .helpers import HELPERS
from .isa import TABLE_FIELDS, TH_EXIT, STACK_BASE, STACK_SIZE, CTX_BASE
from .verifier import (COMMUTATIVE_HELPERS, MapFootprint, VerifiedProgram,
                       footprints_disjoint)

I64 = torch.int64
_MASK32 = 0xFFFFFFFF

# stable helper branch order for TH_CALL dispatch (encode-time index)
TABLE_HELPER_IDS = tuple(sorted(HELPERS))
TABLE_HELPER_INDEX = {hid: i for i, hid in enumerate(TABLE_HELPER_IDS)}

# per-program metadata rows carried next to the packed insn arrays.
# "vec" routes the slot to the batched lockstep machine (still DATA -- the
# scheduling decision rides in the table, so flipping it never rebuilds).
META_FIELDS = ("active", "site", "kind", "n_insns", "fuel", "vec")

# ALU handler order -- index == (op & OP_MASK) >> 4
_ALU_ORDER = (isa.BPF_ADD, isa.BPF_SUB, isa.BPF_MUL, isa.BPF_DIV, isa.BPF_OR,
              isa.BPF_AND, isa.BPF_LSH, isa.BPF_RSH, isa.BPF_NEG, isa.BPF_MOD,
              isa.BPF_XOR, isa.BPF_MOV, isa.BPF_ARSH)
# cond-jump ops by (op & OP_MASK) >> 4 slot; None slots (ja/call/exit) are
# structurally present so the encoded index addresses the tuple directly
_COND_ORDER = (None, isa.BPF_JEQ, isa.BPF_JGT, isa.BPF_JGE, isa.BPF_JSET,
               isa.BPF_JNE, isa.BPF_JSGT, isa.BPF_JSGE, None, None,
               isa.BPF_JLT, isa.BPF_JLE, isa.BPF_JSLT, isa.BPF_JSLE)


def _spec_key(specs) -> tuple:
    """Hashable identity of a map universe (flags don't affect dispatch)."""
    return tuple((s.name, s.kind.value, s.max_entries, s.rec_width,
                  s.num_shards) for s in specs)


def _specs_from_key(key):
    return [M.MapSpec(name=n, kind=M.MapKind(k), max_entries=me,
                      rec_width=rw, num_shards=ns)
            for n, k, me, rw, ns in key]


def table_layout(max_programs: int, max_insns: int):
    """[(field, offset, shape)] of the packed table: TABLE_FIELDS as
    [P, N], then META_FIELDS as [P], then the generation counter [1]. The
    interpreter kernel reads the same layout."""
    out, off = [], 0
    for f in TABLE_FIELDS:
        out.append((f, off, (max_programs, max_insns)))
        off += max_programs * max_insns
    for f in META_FIELDS:
        out.append((f, off, (max_programs,)))
        off += max_programs
    out.append(("gen", off, (1,)))
    return out, off + 1


# --------------------------------------------------------------------------
# the plain sequential core: one (program, event) at a time
# --------------------------------------------------------------------------
#
# The host steps this loop one instruction per iteration, so the register
# file and the 64-word stack are Python ints (each kept in the signed
# 64-bit range by `U.s64`, the unsigned readings written out as in
# `core/u64.py`); the maps stay tensors and change only through the same
# `maps.t_*` twins the scan lane uses.

_U64 = U.U64_FULL

# instructions the plain version has executed: sequential steps, vec lane
# steps and vec machine steps (the interpreter kernel's per-instruction
# times are read against these)
COUNTS = {"seq_insns": 0, "vec_lane_insns": 0, "vec_machine_steps": 0}


def _s32(x: int) -> int:
    lo = x & _MASK32
    return lo - (1 << 32) if lo >> 31 else lo


def _alu_int(op: int, d: int, s: int, is64: bool) -> int:
    """`jit._alu` on one lane of ints: 32-bit ops work on the low 32 bits
    and zero-extend."""
    if not is64:
        d &= _MASK32
        s &= _MASK32
    bits = 63 if is64 else 31
    ud, us = d & _U64, s & _U64
    if op == isa.BPF_ADD:
        r = ud + us
    elif op == isa.BPF_SUB:
        r = ud - us
    elif op == isa.BPF_MUL:
        r = ud * us
    elif op == isa.BPF_DIV:
        r = 0 if us == 0 else ud // us
    elif op == isa.BPF_MOD:
        r = ud if us == 0 else ud % us
    elif op == isa.BPF_OR:
        r = ud | us
    elif op == isa.BPF_AND:
        r = ud & us
    elif op == isa.BPF_XOR:
        r = ud ^ us
    elif op == isa.BPF_LSH:
        r = ud << (us & bits)
    elif op == isa.BPF_RSH:
        r = ud >> (us & bits)
    elif op == isa.BPF_ARSH:
        r = (U.s64(d) if is64 else _s32(d)) >> (us & bits)
    elif op == isa.BPF_MOV:
        r = us
    elif op == isa.BPF_NEG:
        r = -ud
    else:
        raise AssertionError(f"alu op {op:#x}")
    return r & _MASK32 if not is64 else U.s64(r)


def _jmp_int(op: int, lhs: int, rhs: int, is64: bool) -> bool:
    """`jit._jmp_cond` on one lane of ints."""
    if is64:
        ul, ur, sl, sr = lhs & _U64, rhs & _U64, U.s64(lhs), U.s64(rhs)
    else:
        ul, ur, sl, sr = lhs & _MASK32, rhs & _MASK32, _s32(lhs), _s32(rhs)
    return {isa.BPF_JEQ: ul == ur, isa.BPF_JNE: ul != ur,
            isa.BPF_JGT: ul > ur, isa.BPF_JGE: ul >= ur,
            isa.BPF_JLT: ul < ur, isa.BPF_JLE: ul <= ur,
            isa.BPF_JSGT: sl > sr, isa.BPF_JSGE: sl >= sr,
            isa.BPF_JSLT: sl < sr, isa.BPF_JSLE: sl <= sr,
            isa.BPF_JSET: (ul & ur) != 0}[op]


def _low_mask(nbytes: int) -> int:
    return _U64 if nbytes >= 8 else (1 << ((8 * nbytes) & 63)) - 1


def _word_load(words: list, off: int, size: int) -> int:
    """`jit.dyn_word_load` on a list of int words."""
    n = len(words)
    w0 = min(max(off >> 3, 0), n - 1)
    w1 = min(w0 + 1, n - 1)
    rb = off & 7
    lo = (words[w0] & _U64) >> (8 * rb)
    hi = 0 if rb == 0 else ((words[w1] & _U64) << ((64 - 8 * rb) & 63)) \
        & _U64
    return U.s64((lo | hi) & _low_mask(size))


def _word_store(words: list, off: int, size: int, val: int) -> None:
    """`jit.dyn_word_store` on a list of int words, in place (word1 first,
    so a clipped w1 == w0 cannot clobber the word0 write)."""
    n = len(words)
    w0 = min(max(off >> 3, 0), n - 1)
    w1 = min(w0 + 1, n - 1)
    rb = off & 7
    v = val & _low_mask(size)
    m0 = (_low_mask(min(size, 8 - rb)) << (8 * rb)) & _U64
    old0, old1 = words[w0] & _U64, words[w1] & _U64
    new0 = (old0 & ~m0 & _U64) | ((v << (8 * rb)) & m0)
    m1 = (1 << (8 * min(max(rb + size - 8, 0), 7))) - 1
    new1 = (old1 & ~m1 & _U64) | ((v >> ((8 * (8 - rb)) & 63)) & m1)
    words[w1] = U.s64(new1 if rb + size > 8 else old1)
    words[w0] = U.s64(new0)


def _seq_core(specs, prog: dict, fuel: int, ctx_row: list, ms, aux):
    """Run one slot's program on one ctx row (a list of ints) with pred =
    True; returns (r0, ms, aux). prog: {field: list[int]} of the slot's
    padded rows. The twin of the JAX `_build_core`'s `core(...)` with pred
    True: the pc loop runs while not done and fuel > 0; a pc on a padded
    row halts (TH_EXIT); only the selected handler is computed."""
    nmaps = len(specs)
    n_pad = len(prog["hcls"])
    dev = aux["cpu"].device
    true = torch.ones((), dtype=torch.bool, device=dev)
    regs = [0] * 11
    regs[isa.R1] = CTX_BASE
    regs[isa.R10] = STACK_BASE + STACK_SIZE
    stack = [0] * J.STACK_WORDS

    def t(v: int):
        return torch.full((), v, dtype=I64, device=dev)

    def key_at(ptr: int):
        return t(_word_load(stack, ptr - STACK_BASE, 8))

    def call(name: str) -> int:
        nonlocal ms, aux
        if name in ("map_lookup_elem", "map_update_elem", "map_delete_elem",
                    "map_fetch_add", "percpu_fetch_add", "hist_add",
                    "ringbuf_output"):
            if nmaps == 0:
                return 0
            sp = specs[min(max(regs[1], 0), nmaps - 1)]
            st = ms[sp.name]
        if name == "map_lookup_elem":
            key = key_at(regs[2])
            if sp.kind == M.MapKind.ARRAY:
                return int(M.t_array_lookup(st, key, true))
            if sp.kind == M.MapKind.PERCPU_ARRAY:
                return int(M.t_percpu_lookup(st, aux["cpu"], key, true))
            if sp.kind == M.MapKind.HASH:
                return int(M.t_hash_lookup(st, key, true))
            return 0
        if name == "map_update_elem":
            key, val = key_at(regs[2]), key_at(regs[3])
            if sp.kind == M.MapKind.ARRAY:
                ms = {**ms, sp.name: M.t_array_update(st, key, val, true)}
                return 0
            if sp.kind == M.MapKind.HASH:
                new, ok = M.t_hash_update(st, key, val, true)
                ms = {**ms, sp.name: new}
                return 0 if bool(ok) else -7
            return 0
        if name == "map_delete_elem":
            if sp.kind != M.MapKind.HASH:
                return 0
            new, found = M.t_hash_delete(st, key_at(regs[2]), true)
            ms = {**ms, sp.name: new}
            return 0 if bool(found) else -2
        if name == "map_fetch_add":
            key = key_at(regs[2])
            if sp.kind == M.MapKind.ARRAY:
                new, old = M.t_array_fetch_add(st, key, t(regs[3]), true)
            elif sp.kind == M.MapKind.HASH:
                new, old = M.t_hash_fetch_add(st, key, t(regs[3]), true)
            else:
                return 0
            ms = {**ms, sp.name: new}
            return int(old)
        if name == "percpu_fetch_add":
            if sp.kind != M.MapKind.PERCPU_ARRAY:
                return 0
            new, old = M.t_percpu_fetch_add(st, aux["cpu"], key_at(regs[2]),
                                            t(regs[3]), true)
            ms = {**ms, sp.name: new}
            return int(old)
        if name == "hist_add":
            if sp.kind == M.MapKind.LOG2HIST:
                ms = {**ms, sp.name: M.t_hist_add(st, t(regs[2]), true)}
            return 0
        if name == "ringbuf_output":
            if sp.kind != M.MapKind.RINGBUF:
                return 0
            # read rec_width lanes, zero those beyond the dynamic size --
            # the scan lane's zero padding exactly
            rec = [_word_load(stack, regs[2] - STACK_BASE + 8 * i, 8)
                   if 8 * i < regs[3] else 0 for i in range(sp.rec_width)]
            ms = {**ms, sp.name: M.t_ringbuf_emit(
                st, torch.tensor(rec, dtype=I64, device=dev), true)}
            return 0
        if name == "ktime_get_ns":
            return int(aux["time_ns"])
        if name == "get_smp_processor_id":
            return int(aux["cpu"])
        if name == "get_current_pid_tgid":
            return int(aux["pid"])
        if name == "log2":
            return M.np_log2_bin(regs[1])
        if name == "get_prandom_u32":
            x = int(aux["rand"]) & _MASK32
            x = x or 1
            x = (x ^ (x << 13)) & _MASK32
            x = x ^ (x >> 17)
            x = (x ^ (x << 5)) & _MASK32
            aux = {**aux, "rand": t(x)}
            return x
        if name == "trace_printk":
            slot = min(max(int(aux["printk_n"]), 0), 7)
            buf = aux["printk_buf"].clone()
            buf[slot] = torch.tensor([regs[1], regs[2]], dtype=I64,
                                     device=dev)
            aux = {**aux, "printk_buf": buf,
                   "printk_n": aux["printk_n"] + 1}
            return 0
        if name == "override_return":
            aux = {**aux, "override_set": t(1), "override_val": t(regs[1])}
            return 0
        raise AssertionError(name)

    pc, done, steps = 0, False, 0
    while not done and fuel > 0:
        i = min(max(pc, 0), n_pad - 1)
        hcls = min(max(prog["hcls"][i], 0), TH_EXIT)
        dst, src = prog["dst"][i], prog["src"][i]
        off, imm = prog["off"][i], prog["imm"][i]
        taken = True
        if hcls in (isa.TH_ALU64, isa.TH_ALU32):
            s = imm if prog["use_imm"][i] else regs[src]
            op = _ALU_ORDER[min(max(prog["aluop"][i], 0), 12)]
            regs[dst] = _alu_int(op, regs[dst], s, hcls == isa.TH_ALU64)
        elif hcls == isa.TH_LDDW:
            regs[dst] = imm
        elif hcls == isa.TH_LDX:
            addr = regs[src] + off
            regs[dst] = (_word_load(ctx_row, addr - CTX_BASE,
                                    prog["size"][i]) if addr >= CTX_BASE
                         else _word_load(stack, addr - STACK_BASE,
                                         prog["size"][i]))
        elif hcls in (isa.TH_ST, isa.TH_STX):
            _word_store(stack, regs[dst] + off - STACK_BASE, prog["size"][i],
                        regs[src] if hcls == isa.TH_STX else imm)
        elif hcls in (isa.TH_JCOND64, isa.TH_JCOND32):
            op = _COND_ORDER[min(max(prog["aluop"][i], 0),
                                 len(_COND_ORDER) - 1)]
            rhs = imm if prog["use_imm"][i] else regs[src]
            taken = op is not None and _jmp_int(op, regs[dst], rhs,
                                                hcls == isa.TH_JCOND64)
        elif hcls == isa.TH_CALL:
            hidx = min(max(prog["hid"][i], 0), len(TABLE_HELPER_IDS) - 1)
            regs[0] = U.s64(call(HELPERS[TABLE_HELPER_IDS[hidx]].name))
            regs[1:6] = [0] * 5
        # TH_JA and TH_EXIT: nop (ja's target is pre-resolved in tgt)
        pc = prog["tgt"][i] if taken else pc + 1
        fuel -= 1
        done = hcls == TH_EXIT
        steps += 1
    COUNTS["seq_insns"] += steps
    return regs[0], ms, aux


# --------------------------------------------------------------------------
# batched lockstep machine -- the vectorized interpreter lane
# --------------------------------------------------------------------------
#
# The sequential core scans the tape one event at a time. The batched
# machine runs ONE slot's program over ALL matching events in lockstep SIMT
# style: machine state is per LANE (pc[B], fuel[B], regs[B,11],
# stack[B,8], done[B]); each machine step gathers the instruction fields at
# every lane's pc and executes all handler classes compute-all-then-select.
# Map side effects collapse to batched primitives (scatter-add,
# t_hash_fetch_add_batch in lane order, log2 bins).
#
# Bit-identity contract (vs the sequential scan order):
#   * only programs whose helper calls are pure or commutative-effect
#     (fetch-add family, hist_add) are eligible (`batched_encodable`);
#     fetch-add results must be dead -- integer adds commute;
#   * HASH fetch_add additionally changes table LAYOUT at each key's first
#     insert, which is order-sensitive: a hash-touching program is eligible
#     only if it has no conditional branches (every live lane reaches the
#     call at the same machine step, inserted in lane = event order) or its
#     static keys are home-slot collision-free;
#   * cross-slot sharing is resolved host-side (`LiveTable._recompute_vec`).

# effectful helpers whose map writes commute (candidates for batching)
_BATCH_EFFECT = COMMUTATIVE_HELPERS

# observability: how often the footprint proofs fired
WIDEN_STATS = {"batched_hash_widened": 0, "seq_disjoint_widened": 0}

# The batched machine carries a NARROW per-lane stack -- the top
# `_BATCH_STACK_WORDS` words of the 512-byte frame. Probe programs keep
# keys/scratch at r10-8..r10-64, so eligibility (`_fits_batch_stack`)
# checks the verifier's static offsets.
_BATCH_STACK_WORDS = 8


def _fits_batch_stack(vprog: VerifiedProgram) -> bool:
    """True iff every verified stack access (loads/stores and helper key
    pointers) lands in the top `_BATCH_STACK_WORDS * 8` bytes of the frame
    -- the only region the batched machine materializes."""
    from .verifier import CallAnn, MemAnn
    floor = STACK_SIZE - 8 * _BATCH_STACK_WORDS
    for ann in vprog.anns.values():
        if isinstance(ann, MemAnn):
            if ann.region == "stack" and ann.off < floor:
                return False
        elif isinstance(ann, CallAnn):
            sig = HELPERS[ann.hid]
            for i, kind in enumerate(sig.args):
                if kind == "kptr" and ann.statics[i] is not None \
                        and ann.statics[i] < floor:
                    return False
    return True


def _has_cond_branch(vprog: VerifiedProgram) -> bool:
    for ins in vprog.insns:
        if ins.cls in (isa.BPF_JMP, isa.BPF_JMP32):
            op = ins.op & isa.OP_MASK
            if op not in (isa.BPF_JA, isa.BPF_CALL, isa.BPF_EXIT):
                return True
    return False


def _hash_fp_order_free(fp: MapFootprint | None) -> bool:
    """A hash footprint whose touches cannot observe insert order by
    themselves: only map_fetch_add (no deletes -> no tombstones) with
    fully-static keys."""
    return (fp is not None and fp.static_keys is not None
            and fp.ops <= {"map_fetch_add"})


def _home_slots_distinct(keys, max_entries: int) -> bool:
    """True iff every distinct key lands on its own home slot under the
    open-addressing hash -- no probe chains, so the physical layout is the
    same for ANY insert order (and values are commutative sums)."""
    homes: dict[int, int] = {}
    for k in keys:
        h = M._np_hash_idx(k, max_entries)
        if homes.setdefault(h, k) != k:
            return False
    return True


def _self_hash_collision_free(vprog: VerifiedProgram) -> bool:
    """Widening rule 3: a program whose every HASH touch is fetch_add on
    static, home-slot-distinct keys produces the same table layout under
    any per-lane execution order -- lockstep divergence (conditional
    branches) stops being observable."""
    for fp in vprog.footprints.values():
        if fp.kind != M.MapKind.HASH:
            continue
        if not (_hash_fp_order_free(fp)
                and _home_slots_distinct(fp.static_keys, fp.max_entries)):
            return False
    return True


def batched_encodable(vprog: VerifiedProgram) -> bool:
    """True iff this program may run on the batched lockstep machine with
    end states bit-identical to the sequential scan order. Loops are fine
    (the machine steps diverged lanes independently); the constraints are
    commutative-only effects, dead fetch-add results, stack traffic within
    the machine's narrow frame, and -- for HASH fetch_add, whose insert
    order shapes the table layout -- either perfect lockstep (no
    conditional branches) or a footprint PROOF that the program's static
    key set is home-slot collision-free (widening rule 3)."""
    from .vectorized import _PURE, _r0_dead_after
    from .verifier import CallAnn
    if not _fits_batch_stack(vprog):
        return False
    touches_hash = False
    for pc, ann in vprog.anns.items():
        if not isinstance(ann, CallAnn):
            continue
        if ann.name in _PURE:
            continue
        if ann.name not in _BATCH_EFFECT:
            return False
        if ann.name in ("map_fetch_add", "percpu_fetch_add") and \
                not _r0_dead_after(vprog, pc):
            return False
        if ann.name == "map_fetch_add" and \
                vprog.map_specs[ann.statics[0]].kind == M.MapKind.HASH:
            touches_hash = True
    if touches_hash and _has_cond_branch(vprog) \
            and not _self_hash_collision_free(vprog):
        return False
    return True


def _slot_resources(vprog: VerifiedProgram):
    """({map_name: commutative-by-this-program}, {hash map names touched})
    -- the host-side footprint `_recompute_vec` resolves conflicts with."""
    from .verifier import CallAnn
    res: dict[str, bool] = {}
    hashes: set[str] = set()
    for ann in vprog.anns.values():
        if not isinstance(ann, CallAnn):
            continue
        sig = HELPERS[ann.hid]
        comm = sig.name in _BATCH_EFFECT
        for i, kind in enumerate(sig.args):
            if kind == "mapfd":
                sp = vprog.map_specs[ann.statics[i]]
                res[sp.name] = res.get(sp.name, True) and comm
                if sp.kind == M.MapKind.HASH:
                    hashes.add(sp.name)
    return res, hashes


def _sel(rows, idx, hi: int):
    """compute-all-then-select: rows is a list of [B] tensors, idx a [B]
    selector clipped to [0, hi]."""
    return torch.stack(rows).gather(0, idx.clamp(0, hi).unsqueeze(0))[0]


def _apply_fetch_add(specs, ms, fds, keys, deltas, m):
    nmaps = len(specs)
    if nmaps == 0:
        return ms
    fdix = fds.clamp(0, nmaps - 1)
    for si, sp in enumerate(specs):
        mm = m & (fdix == si)
        if not bool(mm.any()):
            continue
        st = ms[sp.name]
        if sp.kind == M.MapKind.ARRAY:
            n = sp.max_entries
            inb = mm & (keys >= 0) & (keys < n)
            vals = st["values"].index_add(
                0, keys.clamp(0, n - 1),
                torch.where(inb, deltas, torch.zeros_like(deltas)))
            ms = {**ms, sp.name: {"values": vals}}
        elif sp.kind == M.MapKind.HASH:
            ms = {**ms, sp.name: M.t_hash_fetch_add_batch(st, keys, deltas,
                                                          mm)}
    return ms


def _apply_percpu_fetch_add(specs, ms, aux, fds, keys, deltas, m):
    nmaps = len(specs)
    if nmaps == 0:
        return ms
    fdix = fds.clamp(0, nmaps - 1)
    for si, sp in enumerate(specs):
        if sp.kind != M.MapKind.PERCPU_ARRAY:
            continue
        mm = m & (fdix == si)
        if not bool(mm.any()):
            continue
        st = ms[sp.name]
        n = sp.max_entries
        inb = mm & (keys >= 0) & (keys < n)
        sh = aux["cpu"].clamp(0, sp.num_shards - 1)
        flat = st["values"].reshape(-1).index_add(
            0, sh * n + keys.clamp(0, n - 1),
            torch.where(inb, deltas, torch.zeros_like(deltas)))
        ms = {**ms, sp.name: {"values": flat.reshape(st["values"].shape)}}
    return ms


def _apply_hist_add(specs, ms, fds, values, m):
    nmaps = len(specs)
    if nmaps == 0:
        return ms
    fdix = fds.clamp(0, nmaps - 1)
    for si, sp in enumerate(specs):
        if sp.kind != M.MapKind.LOG2HIST:
            continue
        mm = m & (fdix == si)
        if not bool(mm.any()):
            continue
        bins = ms[sp.name]["bins"].index_add(0, M.log2_bin(values),
                                             mm.to(I64))
        ms = {**ms, sp.name: {"bins": bins}}
    return ms


def _batched_core(specs, prog: dict, fuel, ctx_rows, ms, aux, preds):
    """Run ONE table slot over a whole event batch in lockstep; returns
    (r0[B], ms). prog: {field: i64[N]} of the slot's padded rows. The twin
    of the JAX `_build_batched_core`'s `bcore(...)`."""
    hnames = [HELPERS[hid].name for hid in TABLE_HELPER_IDS]
    dev = ctx_rows.device
    n_pad = prog["hcls"].shape[0]
    B = ctx_rows.shape[0]
    col = torch.arange(11, dtype=I64, device=dev)[None, :]
    # byte address of the narrow stack's word 0 (top of the real frame)
    sbase = STACK_BASE + STACK_SIZE - 8 * _BATCH_STACK_WORDS
    zeros = torch.zeros(B, dtype=I64, device=dev)
    pc = zeros.clone()
    fuel = torch.full((B,), int(fuel), dtype=I64, device=dev)
    regs = torch.zeros((B, 11), dtype=I64, device=dev)
    regs[:, isa.R1] = CTX_BASE
    regs[:, isa.R10] = STACK_BASE + STACK_SIZE
    stacks = torch.zeros((B, _BATCH_STACK_WORDS), dtype=I64, device=dev)
    done = ~preds
    while True:
        live = (~done) & (fuel > 0)
        n_live = int(live.sum())
        if not n_live:
            break
        COUNTS["vec_machine_steps"] += 1
        COUNTS["vec_lane_insns"] += n_live
        i = pc.clamp(0, n_pad - 1)
        g = {f: prog[f][i] for f in TABLE_FIELDS}     # [B] field gathers
        hcls = g["hcls"]
        dst = g["dst"].clamp(0, 10)
        src = g["src"].clamp(0, 10)
        d = regs.gather(1, dst[:, None])[:, 0]
        sreg = regs.gather(1, src[:, None])[:, 0]
        s = torch.where(g["use_imm"] != 0, g["imm"], sreg)

        # ALU, both widths -- compute-all-then-select, elementwise [B]
        v64 = _sel([J._alu(op, d, s, True) for op in _ALU_ORDER],
                   g["aluop"], 12)
        v32 = _sel([J._alu(op, d, s, False) for op in _ALU_ORDER],
                   g["aluop"], 12)

        # LDX -- per-lane dynamic loads from stack or ctx row
        addr = sreg + g["off"]
        v_st = J.dyn_word_load(stacks, addr - sbase, g["size"])
        v_cx = J.dyn_word_load(ctx_rows, addr - CTX_BASE, g["size"])
        v_ldx = torch.where(addr >= CTX_BASE, v_cx, v_st)

        # register writeback (alu / lddw / ldx)
        wval = v64
        wval = torch.where(hcls == isa.TH_ALU32, v32, wval)
        wval = torch.where(hcls == isa.TH_LDDW, g["imm"], wval)
        wval = torch.where(hcls == isa.TH_LDX, v_ldx, wval)
        wmask = live & ((hcls == isa.TH_ALU64) | (hcls == isa.TH_ALU32)
                        | (hcls == isa.TH_LDDW) | (hcls == isa.TH_LDX))
        regs = torch.where(wmask[:, None] & (col == dst[:, None]),
                           wval[:, None], regs)

        # stores (ST imm / STX reg) -- d is the pre-write base pointer;
        # masked lanes store with size 0 (their words come back unchanged)
        st_mask = live & ((hcls == isa.TH_ST) | (hcls == isa.TH_STX))
        stval = torch.where(hcls == isa.TH_STX, sreg, g["imm"])
        stacks = J.dyn_word_store(
            stacks, d + g["off"] - sbase,
            torch.where(st_mask, g["size"], zeros), stval)

        # helper calls -- masked batched applies, one per (helper, spec)
        at_call = live & (hcls == isa.TH_CALL)
        r1, r2, r3 = regs[:, 1], regs[:, 2], regs[:, 3]
        keys8 = J.dyn_word_load(stacks, r2 - sbase, torch.full_like(r2, 8))
        r0c = zeros
        if bool(at_call.any()):
            for hi, name in enumerate(hnames):
                m = at_call & (g["hid"] == hi)
                if name == "ktime_get_ns":
                    r0c = torch.where(m, aux["time_ns"], r0c)
                elif name == "get_smp_processor_id":
                    r0c = torch.where(m, aux["cpu"], r0c)
                elif name == "get_current_pid_tgid":
                    r0c = torch.where(m, aux["pid"], r0c)
                elif name == "log2":
                    r0c = torch.where(m, M.log2_bin(r1), r0c)
                elif name == "map_fetch_add":
                    # r0 is verified dead (batched_encodable) -> stays 0
                    ms = _apply_fetch_add(specs, ms, r1, keys8, r3, m)
                elif name == "percpu_fetch_add":
                    ms = _apply_percpu_fetch_add(specs, ms, aux, r1, keys8,
                                                 r3, m)
                elif name == "hist_add":
                    ms = _apply_hist_add(specs, ms, r1, r2, m)
                # any other helper is unreachable in a vec slot
                # (batched_encodable gates encoding) -- r0 stays 0
        regs = torch.where(at_call[:, None] & (col == 0), r0c[:, None], regs)
        regs = torch.where(at_call[:, None] & (col >= 1) & (col <= 5),
                           torch.zeros_like(regs), regs)

        # control flow: cond-jumps select, everything else falls through
        # to the pre-resolved tgt (ja) or pc+1
        false = torch.zeros(B, dtype=torch.bool, device=dev)
        c64 = _sel([false if op is None else J._jmp_cond(op, d, s, True)
                    for op in _COND_ORDER], g["aluop"], len(_COND_ORDER) - 1)
        c32 = _sel([false if op is None else J._jmp_cond(op, d, s, False)
                    for op in _COND_ORDER], g["aluop"], len(_COND_ORDER) - 1)
        taken = torch.where(hcls == isa.TH_JCOND64, c64,
                            torch.where(hcls == isa.TH_JCOND32, c32,
                                        torch.ones_like(false)))
        nxt = torch.where(taken, g["tgt"], pc + 1)
        pc = torch.where(live, nxt, pc)
        fuel = torch.where(live, fuel - 1, fuel)
        done = done | (live & (hcls == TH_EXIT))
    return regs[:, 0], ms


def run_plain(spec_key: tuple, table_state: dict, event_rows, maps_state,
              aux, *, match_all: bool = False, want_r0: bool = False):
    """The plain PyTorch interpreter lane over a tape: first the sequential
    slots (vec == 0) event by event, slots in order within each event; then
    each vec slot over the whole tape in slot order -- the JAX package's
    `LiveTable.run` order. match_all: every active slot takes every event
    (the differential entry points), else a slot takes the events of its
    (site, kind). Returns (maps, aux, r0 i64[P, E] or None)."""
    specs = _specs_from_key(spec_key)
    host = {f: table_state[f].tolist() for f in (*TABLE_FIELDS,
                                                 *META_FIELDS)}
    P = len(host["active"])
    E = event_rows.shape[0]
    r0_out = torch.zeros((P, E), dtype=I64, device=event_rows.device) \
        if want_r0 else None
    tape = event_rows.tolist() if any(
        host["active"][p] and not host["vec"][p] for p in range(P)) else []
    sites = event_rows[:, 0].tolist()
    kinds = event_rows[:, 1].tolist()

    def takes(p, e):
        return match_all or (sites[e] == host["site"][p]
                             and kinds[e] == host["kind"][p])

    seq = [p for p in range(P) if host["active"][p] and not host["vec"][p]]
    if seq:
        for e in range(E):
            for p in seq:
                if not takes(p, e):
                    continue
                prog = {f: host[f][p] for f in TABLE_FIELDS}
                r0, maps_state, aux = _seq_core(specs, prog,
                                                host["fuel"][p], tape[e],
                                                maps_state, aux)
                if want_r0:
                    r0_out[p, e] = r0
    for p in range(P):
        if not (host["active"][p] and host["vec"][p]):
            continue
        preds = torch.tensor([takes(p, e) for e in range(E)],
                             dtype=torch.bool, device=event_rows.device)
        if not bool(preds.any()):
            continue
        prog = {f: table_state[f][p] for f in TABLE_FIELDS}
        r0, maps_state = _batched_core(specs, prog, host["fuel"][p],
                                       event_rows, maps_state, aux, preds)
        if want_r0:
            r0_out[p] = torch.where(preds, r0, r0_out[p])
    return maps_state, aux, r0_out


# --------------------------------------------------------------------------
# the live table (host-side owner + in-step lane driver)
# --------------------------------------------------------------------------

class LiveTable:
    """Host-side owner of the device-resident program table.

    Encoding/clearing mutates numpy arrays here and bumps the generation
    counter; `BpftimeRuntime.sync_live_table` pushes the arrays into the
    step's map state (`__live_table__`), in place. The device copy is
    read-only in the step."""

    def __init__(self, map_specs, ctx_words: int = 16, max_programs: int = 4,
                 max_insns: int = 64):
        self.spec_key = _spec_key(map_specs)
        self.n_maps = len(self.spec_key)
        self.ctx_words = ctx_words
        self.max_programs = max_programs
        self.max_insns = max_insns
        self.host: dict[str, np.ndarray] = {
            f: np.zeros((max_programs, max_insns), np.int64)
            for f in TABLE_FIELDS}
        # padded rows halt immediately if a (verified-impossible) runaway pc
        # ever lands on them
        self.host["hcls"][:, :] = TH_EXIT
        for f in META_FIELDS:
            self.host[f] = np.zeros((max_programs,), np.int64)
        self.host["gen"] = np.zeros((1,), np.int64)
        self.slot_pid: list[int | None] = [None] * max_programs
        # host-side scheduling inputs for the batched lane
        self._slot_vec_ok: list[bool] = [False] * max_programs
        self._slot_res: list[dict] = [{}] * max_programs
        self._slot_hash: list[set] = [set()] * max_programs
        # per-slot effect footprints by map name (verifier.MapFootprint) --
        # what _recompute_vec's widening rules prove commutativity from
        self._slot_fp: list[dict] = [{}] * max_programs

    # ------------------------------------------------------------- host side
    def packed(self) -> np.ndarray:
        """A fresh copy of the host arrays in the packed layout
        (`table_layout`)."""
        layout, n = table_layout(self.max_programs, self.max_insns)
        out = np.empty((n,), np.int64)
        for f, off, shape in layout:
            out[off:off + int(np.prod(shape))] = self.host[f].reshape(-1)
        return out

    def device_state(self, device="cuda") -> dict:
        """The table on `device`: {"packed": i64[...], field: view}."""
        buf = torch.from_numpy(self.packed()).to(device)
        return self.views(buf)

    def views(self, buf) -> dict:
        layout, _ = table_layout(self.max_programs, self.max_insns)
        out = {"packed": buf}
        for f, off, shape in layout:
            out[f] = buf[off:off + int(np.prod(shape))].view(shape)
        return out

    def free_slot(self) -> int | None:
        for p in range(self.max_programs):
            if not self.host["active"][p]:
                return p
        return None

    @staticmethod
    def image_key(vprog: VerifiedProgram) -> str:
        """Content address of one encoded table image: the insn blob plus
        the helper-dispatch order the encoding bakes in. Table dims don't
        enter -- padding happens at slot-write time."""
        from .layout import program_digest
        blob = b"".join(i.encode() for i in vprog.insns)
        blob += repr(TABLE_HELPER_IDS).encode()
        return f"tblimg-{program_digest(blob)}"

    def _encoded_image(self, vprog: VerifiedProgram, cache) -> dict:
        """The packed insn arrays. The fleet artifact cache that shares
        them across workers comes with the fleet plane (ROADMAP A11)."""
        if cache is not None:
            raise NotImplementedError("the artifact cache comes with the "
                                      "fleet slice (ROADMAP A11)")
        return isa.encode_table_program(vprog.insns, TABLE_HELPER_INDEX)

    def encode_slot(self, slot: int, vprog: VerifiedProgram, site_id: int,
                    kind: int, pid: int = 0, cache=None) -> None:
        tp = self._encoded_image(vprog, cache)
        n = len(vprog.insns)
        for f in TABLE_FIELDS:
            self.host[f][slot, :] = TH_EXIT if f == "hcls" else 0
            self.host[f][slot, :n] = tp[f]
        self.host["active"][slot] = 1
        self.host["site"][slot] = site_id
        self.host["kind"][slot] = kind
        self.host["n_insns"][slot] = n
        # fuel in INSN steps. The scan-lane T2 budget is vprog.max_insns
        # BLOCK-dispatch steps (jit.compile_t2); scale by the longest block
        # so any execution that completes within the scan lane's budget also
        # completes here.
        max_block = max((b.end - b.start for b in vprog.blocks), default=1)
        self.host["fuel"][slot] = vprog.max_insns * max(1, max_block)
        self._slot_vec_ok[slot] = batched_encodable(vprog)
        self._slot_res[slot], self._slot_hash[slot] = _slot_resources(vprog)
        self._slot_fp[slot] = {fp.name: fp
                               for fp in vprog.footprints.values()}
        self._recompute_vec()
        self.host["gen"][0] += 1
        self.slot_pid[slot] = pid

    def clear_slot(self, slot: int) -> None:
        self.host["active"][slot] = 0
        self._slot_vec_ok[slot] = False
        self._slot_res[slot] = {}
        self._slot_hash[slot] = set()
        self._slot_fp[slot] = {}
        self._recompute_vec()
        self.host["gen"][0] += 1
        self.slot_pid[slot] = None

    def _hash_sharing_widened(self, mname: str) -> bool:
        """Widening rule 2: a HASH map shared across slots stays batchable
        when EVERY active slot touching it does so only via map_fetch_add
        with fully-static keys, and the UNION of those keys is home-slot
        collision-free -- every insert lands in its home slot whatever the
        order, so the physical layout is identical and values are
        commutative sums."""
        keys: set[int] = set()
        n = None
        for q in range(self.max_programs):
            if not self.host["active"][q] or \
                    mname not in self._slot_res[q]:
                continue
            fp = self._slot_fp[q].get(mname)
            if not _hash_fp_order_free(fp):
                return False
            keys |= fp.static_keys
            n = fp.max_entries
        if n is None or not _home_slots_distinct(keys, n):
            return False
        WIDEN_STATS["batched_hash_widened"] += 1
        return True

    def _recompute_vec(self) -> None:
        """Resolve which active slots run on the batched machine. A slot
        starts from its program's own eligibility (`batched_encodable`) and
        is demoted to the sequential lane when cross-slot sharing would make
        the batched interleave observable:

          * it touches a HASH map that ANY other active slot also touches
            -- UNLESS the union footprint is provably order-free
            (`_hash_sharing_widened`, widening rule 2);
          * it shares a map with a sequential slot that touches it
            NON-commutatively -- UNLESS the two footprints address provably
            disjoint static cells of a positional map (widening rule 1).

        Demotions only remove batched slots, so the fixpoint is reached in
        one or two sweeps. The result is written into the `vec` meta row --
        pure table DATA."""
        P = self.max_programs
        eff = [bool(self.host["active"][p]) and self._slot_vec_ok[p]
               for p in range(P)]
        changed = True
        while changed:
            changed = False
            for p in range(P):
                if not eff[p]:
                    continue
                for q in range(P):
                    if q == p or not self.host["active"][q]:
                        continue
                    shared = set(self._slot_res[p]) & set(self._slot_res[q])
                    for mname in shared:
                        if mname in self._slot_hash[p]:
                            if self._hash_sharing_widened(mname):
                                continue
                            eff[p] = False
                            changed = True
                            break
                        if not eff[q] and not self._slot_res[q][mname]:
                            if footprints_disjoint(
                                    self._slot_fp[p].get(mname),
                                    self._slot_fp[q].get(mname)):
                                WIDEN_STATS["seq_disjoint_widened"] += 1
                                continue
                            eff[p] = False
                            changed = True
                            break
                    if not eff[p]:
                        break
        for p in range(P):
            self.host["vec"][p] = 1 if eff[p] else 0

    # ------------------------------------------------------------- device side
    def run(self, table_state: dict, event_rows, maps_state, aux):
        """The interpreter lane over one tape: the sequential slots
        (vec == 0) event by event, then each vec slot over the whole tape,
        in slot order. A CUDA tape is one launch of the interpreter kernel,
        whatever the table holds; a CPU tape takes the plain version. The
        maps this table does not know (created after enable) pass
        through."""
        from ..kernels import ops
        known = {k: maps_state[k] for k, *_ in self.spec_key}
        ms, aux, _ = ops.table_interp_run(self.spec_key, table_state,
                                          event_rows, known, aux)
        return {**maps_state, **ms}, aux


# --------------------------------------------------------------------------
# differential-test entry points
# --------------------------------------------------------------------------

def _one_slot_table(vprog: VerifiedProgram, pad_insns: int, device):
    lt = LiveTable(vprog.map_specs, ctx_words=vprog.ctx_words,
                   max_programs=1,
                   max_insns=max(pad_insns, len(vprog.insns)))
    lt.encode_slot(0, vprog, site_id=0, kind=0)
    return lt, lt.device_state(device)


def run_program(vprog: VerifiedProgram, ctx_row, maps_state, aux,
                pad_insns: int = 128):
    """Run ONE verified program through the table interpreter on a single
    ctx row with pred = True -- the differential-test twin of
    `jit.compile_program`. Forced onto the sequential sub-lane. Returns
    (r0, maps_state, aux)."""
    from ..kernels import ops
    lt, tbl = _one_slot_table(vprog, pad_insns, ctx_row.device)
    tbl["vec"].zero_()
    ms, aux, r0 = ops.table_interp_run(
        lt.spec_key, tbl, ctx_row.reshape(1, -1).to(I64), maps_state, aux,
        match_all=True, want_r0=True)
    return r0[0, 0], ms, aux


def run_program_batched(vprog: VerifiedProgram, ctx_rows, maps_state, aux,
                        pad_insns: int = 128):
    """Run ONE batched-eligible program through the lockstep machine over a
    [B, ctx_words] batch with every lane valid -- the differential twin of
    the vec sub-lane (`(r0[B], maps_state)`). Callers gate on
    `batched_encodable(vprog)`."""
    from ..kernels import ops
    lt, tbl = _one_slot_table(vprog, pad_insns, ctx_rows.device)
    tbl["vec"].fill_(1)
    ms, _aux, r0 = ops.table_interp_run(
        lt.spec_key, tbl, ctx_rows.to(I64), maps_state, aux, match_all=True,
        want_r0=True)
    return r0[0], ms
