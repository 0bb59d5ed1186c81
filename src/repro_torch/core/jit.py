"""Bytecode -> torch JIT: verified eBPF programs become torch ops that run
on the device inside the step (the "inline in the target process"
property that gives bpftime its speed).

Two tiers, selected by the verifier's CFG analysis:

  T1 ("dag")  : programs whose CFG is acyclic are fully if-converted into
                straight-line predicated dataflow. Registers/stack are merged
                per-block with selects; map/aux side effects are gated by the
                block's arrival predicate and threaded linearly (disjoint
                predicates make the order across sibling branches
                irrelevant). T1 is emitted over a leading batch dimension:
                registers are i64[B], the stack i64[B, 64], so one program
                pass covers a whole event batch (the shadow pass of the
                vectorized lane) or one event (B = 1, the scan lanes).
  T2 ("loop") : programs with (fuel-bounded) loops run one event at a time
                through a basic-block dispatcher driven from the host.

The verifier has already proven every memory access static and in-bounds,
so codegen performs NO runtime checks -- verify once, run fast.

Values are int64; the unsigned readings the ISA needs come from `u64`.
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

from . import isa, maps as M, u64 as U
from .isa import (BPF_ALU, BPF_ALU64, BPF_JMP, BPF_JMP32, BPF_LDX, BPF_ST,
                  BPF_STX, CTX_BASE, OP_MASK, SIZE_BYTES, SIZE_MASK, SRC_MASK,
                  STACK_BASE, STACK_SIZE)
from .verifier import CallAnn, MemAnn, VerifiedProgram

I64 = torch.int64

# word-oriented stack: 512 bytes modelled as 64 little-endian i64 lanes.
# Verifier-proven aligned 8-byte accesses are one column read/write;
# unaligned and sub-word accesses keep byte-exact semantics via static
# shift/mask codegen over at most two words.
STACK_WORDS = STACK_SIZE // 8
_MASK32 = 0xFFFFFFFF


def make_aux(time_ns=0, cpu=0, pid=0, rand=0x12345678, device="cuda"):
    """Per-call aux block: 0-dim i64 tensors plus the printk buffer."""
    from ..device import resolve
    dev = resolve(device)

    def c(v):
        if isinstance(v, torch.Tensor):
            return v.to(device=dev, dtype=I64).reshape(())
        return torch.full((), U.s64(int(v)), dtype=I64, device=dev)

    return {
        "time_ns": c(time_ns),
        "cpu": c(cpu),
        "pid": c(pid),
        "rand": c(rand),
        "override_set": c(0),
        "override_val": c(0),
        "printk_buf": torch.zeros((8, 2), dtype=I64, device=dev),
        "printk_n": c(0),
    }


# --------------------------------------------------------------------------
# shared machinery over i64[B] lanes
# --------------------------------------------------------------------------

def _full(like, v: int):
    return torch.full_like(like, U.s64(v))


def _alu(op: int, d, s, is64: bool):
    """d, s: i64[B]. 32-bit ops work on the low 32 bits, zero-extend."""
    if not is64:
        d = d & _MASK32
        s = s & _MASK32
    bits = 63 if is64 else 31
    if op == isa.BPF_ADD:
        r = d + s
    elif op == isa.BPF_SUB:
        r = d - s
    elif op == isa.BPF_MUL:
        r = d * s
    elif op in (isa.BPF_DIV, isa.BPF_MOD):
        zero = s == 0
        q, rem = U.udivmod(d, torch.where(zero, torch.ones_like(s), s))
        if op == isa.BPF_DIV:
            r = torch.where(zero, torch.zeros_like(d), q)
        else:
            r = torch.where(zero, d, rem)
    elif op == isa.BPF_OR:
        r = d | s
    elif op == isa.BPF_AND:
        r = d & s
    elif op == isa.BPF_XOR:
        r = d ^ s
    elif op == isa.BPF_LSH:
        r = U.shl(d, s & bits)
    elif op == isa.BPF_RSH:
        r = U.lshr(d, s & bits)
    elif op == isa.BPF_ARSH:
        r = (d if is64 else _s32_view(d)) >> (s & bits)
    elif op == isa.BPF_MOV:
        r = s
    elif op == isa.BPF_NEG:
        r = -d
    else:
        raise AssertionError(f"alu op {op:#x}")
    if not is64:
        r = r & _MASK32
    return r


def _s32_view(x):
    """low 32 bits of i64, sign-extended (as i64)."""
    lo = x & _MASK32
    return torch.where((lo >> 31) != 0, lo - (1 << 32), lo)


def _jmp_cond(op: int, lhs, rhs, is64: bool):
    if is64:
        ul, ur = lhs, rhs
        sl, sr = lhs, rhs
    else:
        ul, ur = lhs & _MASK32, rhs & _MASK32
        sl, sr = _s32_view(lhs), _s32_view(rhs)
    if op == isa.BPF_JEQ:
        return ul == ur
    if op == isa.BPF_JNE:
        return ul != ur
    if op == isa.BPF_JGT:
        return U.ugt(ul, ur)
    if op == isa.BPF_JGE:
        return U.uge(ul, ur)
    if op == isa.BPF_JLT:
        return U.ult(ul, ur)
    if op == isa.BPF_JLE:
        return U.ule(ul, ur)
    if op == isa.BPF_JSGT:
        return sl > sr
    if op == isa.BPF_JSGE:
        return sl >= sr
    if op == isa.BPF_JSLT:
        return sl < sr
    if op == isa.BPF_JSLE:
        return sl <= sr
    if op == isa.BPF_JSET:
        return (ul & ur) != 0
    raise AssertionError(f"jmp op {op:#x}")


def _stack_load(stack, off: int, size: int, aligned: bool | None = None):
    """Static-offset little-endian load from the i64-word stack [B, 64],
    zero-extended. `aligned` is the verifier's proof of natural 8-byte
    alignment; that path is one column read, the general path reads the
    one or two covering words and shifts/masks with constant amounts."""
    if aligned is None:
        aligned = off % 8 == 0 and size == 8
    w0, rb = divmod(off, 8)
    if aligned:
        return stack[:, w0]
    lo = U.lshr(stack[:, w0], 8 * rb)
    if rb + size > 8:                       # spans into the next word
        lo = lo | U.shl(stack[:, w0 + 1], 8 * (8 - rb))
    if size < 8:
        lo = lo & ((1 << (8 * size)) - 1)
    return lo


def _stack_store(stack, off: int, size: int, val, aligned: bool | None = None):
    """Static-offset little-endian store of the low `size` bytes of `val`
    into a copy of the stack; the general path read-modify-writes the one
    or two covering words."""
    if aligned is None:
        aligned = off % 8 == 0 and size == 8
    stack = stack.clone()
    if aligned:
        stack[:, off // 8] = val
        return stack
    w0, rb = divmod(off, 8)
    v = val
    if size < 8:
        v = v & ((1 << (8 * size)) - 1)
    nb0 = min(size, 8 - rb)                 # bytes landing in word0
    m0 = ((1 << (8 * nb0)) - 1) << (8 * rb)
    stack[:, w0] = ((stack[:, w0] & U.s64(m0 ^ U.U64_FULL))
                    | (U.shl(v, 8 * rb) & U.s64(m0)))
    if rb + size > 8:
        m1 = (1 << (8 * (rb + size - 8))) - 1
        stack[:, w0 + 1] = ((stack[:, w0 + 1] & U.s64(m1 ^ U.U64_FULL))
                            | (U.lshr(v, 8 * (8 - rb)) & m1))
    return stack


def _col(words, idx):
    """words[..., idx[...]]: one word per lane at a per-lane index."""
    return words.gather(-1, idx.unsqueeze(-1)).squeeze(-1)


def _low_mask(nbits):
    """(1 << nbits) - 1 for nbits in [0, 63], elementwise."""
    return (torch.ones_like(nbits) << nbits) - 1


def dyn_word_load(words, off, size):
    """Little-endian load of `size` bytes at DYNAMIC byte offset `off` from
    an i64 word array -- the traced-offset twin of `_stack_load`, used by
    the program-table interpreter where offsets are data, not constants.
    words [..., W], off and size i64[...] (one per lane). The verifier has
    proven accesses in bounds before a program is table-encoded; indices
    are clipped only to keep the gathers well-defined. Shift amounts are
    masked to [0, 63] with guards for the rb == 0 / size == 8 edges."""
    nwords = words.shape[-1]
    w0 = (off >> 3).clamp(0, nwords - 1)
    w1 = (w0 + 1).clamp(max=nwords - 1)
    rb = off & 7
    lo = U.lshr(_col(words, w0), 8 * rb)
    hi_sh = (64 - 8 * rb) & 63
    hi = torch.where(rb == 0, torch.zeros_like(lo),
                     U.shl(_col(words, w1), hi_sh))
    mask = torch.where(size >= 8, torch.full_like(size, -1),
                       _low_mask((8 * size) & 63))
    return (lo | hi) & mask


def dyn_word_store(words, off, size, val):
    """Little-endian store of the low `size` bytes of `val` at DYNAMIC byte
    offset `off` into a copy of `words` -- the traced-offset twin of
    `_stack_store`. Read-modify-writes the one or two covering words; the
    second-word write is a self-assignment when the access doesn't span,
    and it is written first, so it cannot clobber the word0 write even if
    w1 was clipped onto w0. A lane with size 0 writes its words back
    unchanged."""
    nwords = words.shape[-1]
    w0 = (off >> 3).clamp(0, nwords - 1)
    w1 = (w0 + 1).clamp(max=nwords - 1)
    rb = off & 7
    v = torch.where(size >= 8, val, val & _low_mask((8 * size) & 63))
    nb0 = torch.minimum(size, 8 - rb)             # bytes landing in word0
    m0 = U.shl(torch.where(nb0 >= 8, torch.full_like(nb0, -1),
                           _low_mask((8 * nb0) & 63)), 8 * rb)
    old0, old1 = _col(words, w0), _col(words, w1)
    new0 = (old0 & ~m0) | (U.shl(v, 8 * rb) & m0)
    spans = (rb + size) > 8
    m1 = _low_mask(8 * (rb + size - 8).clamp(0, 7))
    sh1 = (8 * (8 - rb)) & 63
    new1 = (old1 & ~m1) | (U.lshr(v, sh1) & m1)
    out = words.clone()
    out.scatter_(-1, w1.unsqueeze(-1),
                 torch.where(spans, new1, old1).unsqueeze(-1))
    out.scatter_(-1, w0.unsqueeze(-1), new0.unsqueeze(-1))
    return out


@dataclass
class _Machine:
    regs: list          # 11 i64[B] tensors
    stack: object       # i64[B, STACK_WORDS] (little-endian byte semantics)


def _imm(ins, is64: bool) -> int:
    return ins.imm if is64 else ins.imm & _MASK32   # s32 -> s64 when 64-bit


def _exec_straightline(vprog: VerifiedProgram, lo: int, hi: int, m: _Machine,
                       maps_state, aux, pred, ctx, helper_cb=None):
    """Execute insns [lo, hi) except a trailing terminator handled by the
    caller. Side effects gated by `pred` (bool[B]). helper_cb overrides
    helper execution (used by the vectorized shadow pass)."""
    helper_cb = helper_cb or _exec_helper
    zero = m.regs[0]
    for pc in range(lo, hi):
        ins = vprog.insns[pc]
        cls = ins.cls
        if ins.is_lddw():
            m.regs[ins.dst] = _full(zero, isa.s64(ins.imm64 or 0))
        elif cls in (BPF_ALU64, BPF_ALU):
            op = ins.op & OP_MASK
            is64 = cls == BPF_ALU64
            if op == isa.BPF_NEG:
                m.regs[ins.dst] = _alu(op, m.regs[ins.dst],
                                       torch.zeros_like(zero), is64)
            else:
                s = (m.regs[ins.src] if ins.op & SRC_MASK
                     else _full(zero, _imm(ins, is64)))
                m.regs[ins.dst] = _alu(op, m.regs[ins.dst], s, is64)
        elif cls == BPF_LDX:
            ann: MemAnn = vprog.anns[pc]
            size = SIZE_BYTES[ins.op & SIZE_MASK]
            if ann.region == "stack":
                m.regs[ins.dst] = _stack_load(m.stack, ann.off, size,
                                              aligned=ann.aligned)
            else:  # ctx -- i64 word array, static offset
                word, rem = divmod(ann.off, 8)
                v = ctx[:, word]
                if rem or size != 8:
                    v = v >> (8 * rem)
                    if size < 8:
                        v = v & ((1 << (8 * size)) - 1)
                m.regs[ins.dst] = v
        elif cls in (BPF_STX, BPF_ST):
            ann = vprog.anns[pc]
            size = SIZE_BYTES[ins.op & SIZE_MASK]
            # ST: imm sign-extended, low `size` bytes written (oracle parity)
            val = m.regs[ins.src] if cls == BPF_STX else _full(zero, ins.imm)
            m.stack = _stack_store(m.stack, ann.off, size, val,
                                   aligned=ann.aligned)
        elif cls in (BPF_JMP, BPF_JMP32) and (ins.op & OP_MASK) == isa.BPF_CALL:
            ann = vprog.anns[pc]
            r0, maps_state, aux = helper_cb(vprog, ann, m, maps_state,
                                            aux, pred)
            m.regs[0] = r0
            for r in range(1, 6):
                m.regs[r] = torch.zeros_like(r0)
        else:
            raise AssertionError(f"terminator {pc} inside straight-line run")
    return m, maps_state, aux


def _lane(v):
    """i64 value for the (single) event of a B = 1 run, as a 0-dim tensor."""
    return v.reshape(-1)[0]


def _exec_helper(vprog, ann: CallAnn, m: _Machine, maps_state, aux, pred):
    """Full helper execution for one event (B = 1): the map twins take
    0-dim operands; r0 comes back as i64[1]."""
    name, st_args = ann.name, ann.statics
    specs = vprog.map_specs
    assert pred.shape[0] == 1, "full helpers run one event at a time"
    p = pred[0]

    def load_key(off):
        return _lane(_stack_load(m.stack, off, 8))

    def ret(v):
        return v.reshape(1)

    zero = torch.zeros_like(aux["time_ns"])

    if name == "map_lookup_elem":
        fd, koff = st_args
        sp = specs[fd]
        key = load_key(koff)
        mstate = maps_state[sp.name]
        if sp.kind == M.MapKind.ARRAY:
            r0 = M.t_array_lookup(mstate, key, p)
        elif sp.kind == M.MapKind.PERCPU_ARRAY:
            r0 = M.t_percpu_lookup(mstate, aux["cpu"], key, p)
        else:
            r0 = M.t_hash_lookup(mstate, key, p)
        return ret(r0), maps_state, aux

    if name == "map_update_elem":
        fd, koff, voff, _ = st_args
        sp = specs[fd]
        key, val = load_key(koff), load_key(voff)
        mstate = maps_state[sp.name]
        if sp.kind == M.MapKind.ARRAY:
            new = M.t_array_update(mstate, key, val, p)
            r0 = zero
        else:
            new, ok = M.t_hash_update(mstate, key, val, p)
            r0 = torch.where(ok, zero, zero - 7)
        return ret(r0), {**maps_state, sp.name: new}, aux

    if name == "map_delete_elem":
        fd, koff = st_args
        sp = specs[fd]
        new, found = M.t_hash_delete(maps_state[sp.name], load_key(koff), p)
        r0 = torch.where(found, zero, zero - 2)
        return ret(r0), {**maps_state, sp.name: new}, aux

    if name == "map_fetch_add":
        fd, koff, _ = st_args
        sp = specs[fd]
        key, delta = load_key(koff), _lane(m.regs[3])
        mstate = maps_state[sp.name]
        if sp.kind == M.MapKind.ARRAY:
            new, old = M.t_array_fetch_add(mstate, key, delta, p)
        else:
            new, old = M.t_hash_fetch_add(mstate, key, delta, p)
        return ret(old), {**maps_state, sp.name: new}, aux

    if name == "percpu_fetch_add":
        fd, koff, _ = st_args
        sp = specs[fd]
        new, old = M.t_percpu_fetch_add(maps_state[sp.name], aux["cpu"],
                                        load_key(koff), _lane(m.regs[3]), p)
        return ret(old), {**maps_state, sp.name: new}, aux

    if name == "hist_add":
        fd, _ = st_args
        sp = specs[fd]
        new = M.t_hist_add(maps_state[sp.name], _lane(m.regs[2]), p)
        return ret(zero), {**maps_state, sp.name: new}, aux

    if name == "ringbuf_output":
        fd, doff, size, _ = st_args
        sp = specs[fd]
        rec = [_lane(_stack_load(m.stack, doff + 8 * i, 8))
               for i in range(size // 8)]
        rec += [zero] * (sp.rec_width - len(rec))
        new = M.t_ringbuf_emit(maps_state[sp.name], torch.stack(rec), p)
        return ret(zero), {**maps_state, sp.name: new}, aux

    if name == "ktime_get_ns":
        return ret(aux["time_ns"]), maps_state, aux
    if name == "get_smp_processor_id":
        return ret(aux["cpu"]), maps_state, aux
    if name == "get_current_pid_tgid":
        return ret(aux["pid"]), maps_state, aux
    if name == "log2":
        return M.log2_bin(m.regs[1]), maps_state, aux
    if name == "get_prandom_u32":
        x = aux["rand"] & _MASK32
        x = torch.where(x == 0, torch.ones_like(x), x)
        x = (x ^ (x << 13)) & _MASK32
        x = x ^ (x >> 17)
        x = (x ^ (x << 5)) & _MASK32
        new_rand = torch.where(p, x, aux["rand"])
        return ret(torch.where(p, x, zero)), maps_state, \
            {**aux, "rand": new_rand}
    if name == "trace_printk":
        slot = aux["printk_n"].clamp(0, 7)
        row = torch.stack([_lane(m.regs[1]), _lane(m.regs[2])])
        buf = aux["printk_buf"].clone()
        buf[slot] = torch.where(p, row, aux["printk_buf"][slot])
        n = aux["printk_n"] + p.to(I64)
        return ret(zero), maps_state, {**aux, "printk_buf": buf,
                                       "printk_n": n}
    if name == "override_return":
        ov_s = torch.where(p, torch.ones_like(zero), aux["override_set"])
        ov_v = torch.where(p, _lane(m.regs[1]), aux["override_val"])
        return ret(zero), maps_state, {**aux, "override_set": ov_s,
                                       "override_val": ov_v}
    raise AssertionError(f"helper {name} not implemented in JIT")


# --------------------------------------------------------------------------
# Tier 1: DAG if-conversion over [B] lanes
# --------------------------------------------------------------------------

def _topo_order(vprog: VerifiedProgram) -> list[int]:
    """Kahn's algorithm from the entry block; unreachable blocks excluded."""
    from collections import deque
    n = len(vprog.blocks)
    indeg = [0] * n
    for b in vprog.blocks:
        for s in b.succ:
            indeg[s] += 1
    dq = deque([0])
    seen = {0}
    out: list[int] = []
    while dq:
        u = dq.popleft()
        out.append(u)
        for s in vprog.blocks[u].succ:
            indeg[s] -= 1
            if indeg[s] <= 0 and s not in seen:
                seen.add(s)
                dq.append(s)
    return out


def _entry_regs(zero):
    regs = [zero] * 11
    regs[isa.R1] = _full(zero, CTX_BASE)
    regs[isa.R10] = _full(zero, STACK_BASE + STACK_SIZE)
    return regs


def compile_t1(vprog: VerifiedProgram, helper_cb=None):
    assert vprog.tier == "dag"
    order = _topo_order(vprog)

    def run(ctx, maps_state, aux, entry_pred=None):
        """ctx: i64[B, ctx_words]; returns (r0 i64[B], maps_state, aux).
        `entry_pred` (bool[B]) is folded into the entry block's arrival
        predicate: every side effect in the program is already gated on its
        block predicate, so an invalid event becomes a complete no-op with
        NO post-hoc state select -- the fused pipeline's per-event gate."""
        B = ctx.shape[0]
        zero = torch.zeros(B, dtype=I64, device=ctx.device)
        p0 = (torch.ones(B, dtype=torch.bool, device=ctx.device)
              if entry_pred is None else entry_pred)
        stack0 = torch.zeros((B, STACK_WORDS), dtype=I64, device=ctx.device)
        incoming: dict[int, tuple] = {0: (p0, _entry_regs(zero), stack0)}
        exits = []  # (pred, r0)

        for bid in order:
            if bid not in incoming:
                continue
            pred, regs, stack = incoming.pop(bid)
            m = _Machine(list(regs), stack)
            blk = vprog.blocks[bid]
            term_pc = blk.end - 1
            body_hi = blk.end if blk.term == "fall" else term_pc
            m, maps_state, aux = _exec_straightline(
                vprog, blk.start, body_hi, m, maps_state, aux, pred, ctx,
                helper_cb)

            def send(tgt: int, p, mm):
                if tgt in incoming:
                    p_old, regs_old, st_old = incoming[tgt]
                    merged = [a if a is b else torch.where(p, a, b)
                              for a, b in zip(mm.regs, regs_old)]
                    st = (mm.stack if mm.stack is st_old else
                          torch.where(p[:, None], mm.stack, st_old))
                    incoming[tgt] = (p_old | p, merged, st)
                else:
                    incoming[tgt] = (p, list(mm.regs), mm.stack)

            if blk.term in ("fall", "ja"):
                send(blk.succ[0], pred, m)
            elif blk.term == "exit":
                exits.append((pred, m.regs[0]))
            else:  # cond
                ins = vprog.insns[term_pc]
                is64 = ins.cls == BPF_JMP
                lhs = m.regs[ins.dst]
                rhs = (m.regs[ins.src] if ins.op & SRC_MASK
                       else _full(zero, _imm(ins, is64)))
                c = _jmp_cond(ins.op & OP_MASK, lhs, rhs, is64)
                send(blk.succ[0], pred & c, m)
                send(blk.succ[1], pred & ~c, m)

        r0 = zero
        for p, v in exits:
            r0 = torch.where(p, v, r0)
        return r0, maps_state, aux

    return run


# --------------------------------------------------------------------------
# Tier 2: host-driven block dispatcher, one event at a time
# --------------------------------------------------------------------------

def compile_t2(vprog: VerifiedProgram):
    nblocks = len(vprog.blocks)

    def run(ctx, maps_state, aux):
        """ctx: i64[1, ctx_words]; returns (r0 i64[1], maps_state, aux).
        Each step executes one basic block and reads the branch outcome on
        the host; `max_insns` steps of fuel bound the loop."""
        zero = torch.zeros(1, dtype=I64, device=ctx.device)
        pred = torch.ones(1, dtype=torch.bool, device=ctx.device)
        m = _Machine(_entry_regs(zero),
                     torch.zeros((1, STACK_WORDS), dtype=I64,
                                 device=ctx.device))
        r0 = zero
        bid, fuel = 0, vprog.max_insns
        while bid < nblocks and fuel > 0:
            blk = vprog.blocks[bid]
            term_pc = blk.end - 1
            body_hi = blk.end if blk.term == "fall" else term_pc
            m, maps_state, aux = _exec_straightline(
                vprog, blk.start, body_hi, m, maps_state, aux, pred, ctx)
            if blk.term == "exit":
                r0 = m.regs[0]
                bid = nblocks                       # sentinel: done
            elif blk.term in ("ja", "fall"):
                bid = blk.succ[0]
            else:
                ins = vprog.insns[term_pc]
                is64 = ins.cls == BPF_JMP
                lhs = m.regs[ins.dst]
                rhs = (m.regs[ins.src] if ins.op & SRC_MASK
                       else _full(zero, _imm(ins, is64)))
                c = bool(_jmp_cond(ins.op & OP_MASK, lhs, rhs, is64)[0])
                bid = blk.succ[0] if c else blk.succ[1]
            fuel -= 1
        return r0, maps_state, aux

    return run


def compile_program(vprog: VerifiedProgram):
    """Probe function: (ctx i64[B, W], maps, aux) -> (r0 i64[B], maps,
    aux); B must be 1 unless the helpers are replaced (shadow pass)."""
    return compile_t1(vprog) if vprog.tier == "dag" else compile_t2(vprog)


def run_over_events(vprog: VerifiedProgram, ctxs, valid, maps_state, aux):
    """Sequentially-consistent execution over event rows, one event at a
    time. ctxs: i64[N, W]; valid: bool[N]. Invalid rows are no-ops; their
    r0 is reported as 0. The validity mask is read on the host once."""
    prog = compile_program(vprog)
    r0s = torch.zeros(ctxs.shape[0], dtype=I64, device=ctxs.device)
    for i, ok in enumerate(valid.tolist()):
        if not ok:
            continue
        r0, maps_state, aux = prog(ctxs[i:i + 1], maps_state, aux)
        r0s[i] = r0[0]
    return r0s, maps_state, aux


def run_fused_scan(entries, ctxs, maps_state, aux):
    """ONE combined pass over the event tape for every scan-lane
    attachment -- the fused pipeline's fallback lane.

    entries: [(site_id, kind, vprog)]. For each row, in tape order, every
    program whose (site, kind) matches the row runs on it. The (site,
    kind) columns are read on the host once; a row a program does not
    match is skipped, which is the no-op the predicated form computes."""
    compiled = [(sid, kind, compile_program(vp)) for sid, kind, vp in entries]
    heads = ctxs[:, :2].tolist()
    for i, (sid_i, kind_i) in enumerate(heads):
        for sid, kind, prog in compiled:
            if sid_i == sid and kind_i == kind:
                _r0, maps_state, aux = prog(ctxs[i:i + 1], maps_state, aux)
    return maps_state, aux
