"""Reference eBPF interpreter — the "ubpf" analogue and differential-testing
oracle for the JAX JIT. Executes on python ints + numpy map states, with the
same memory model the verifier reasons about (bounds-checked at runtime here;
proven statically for the JIT).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass, field

import numpy as np

from . import isa, maps as M
from .helpers import HELPERS
from .isa import (BPF_ALU, BPF_ALU64, BPF_JMP, BPF_JMP32, BPF_LDX, BPF_ST,
                  BPF_STX, CTX_BASE, Insn, OP_MASK, SIZE_BYTES, SIZE_MASK,
                  SRC_MASK, STACK_BASE, STACK_SIZE, s32, s64, u32, u64)


class VMError(RuntimeError):
    pass


@dataclass
class Aux:
    time_ns: int = 0
    cpu: int = 0
    pid: int = 0
    rand_state: int = 0x12345678
    override_set: int = 0
    override_val: int = 0
    printk: list = field(default_factory=list)


@dataclass
class VMResult:
    r0: int
    aux: Aux
    insns_executed: int


def run(insns: list[Insn], ctx: bytes, map_specs: list[M.MapSpec],
        map_states: dict, aux: Aux | None = None,
        max_insns: int = 1 << 20) -> VMResult:
    """Execute. map_states (numpy pytrees) are mutated in place."""
    aux = aux or Aux()
    slots = isa.insn_slots(insns)
    slot2idx = {s: i for i, s in enumerate(slots)}
    regs = [0] * 11
    regs[isa.R1] = CTX_BASE
    regs[isa.R10] = STACK_BASE + STACK_SIZE
    stack = bytearray(STACK_SIZE)
    executed = 0
    pc = 0  # index into insns

    def mem_read(addr: int, size: int) -> int:
        if STACK_BASE <= addr and addr + size <= STACK_BASE + STACK_SIZE:
            off = addr - STACK_BASE
            return int.from_bytes(stack[off:off + size], "little")
        if CTX_BASE <= addr and addr + size <= CTX_BASE + len(ctx):
            off = addr - CTX_BASE
            return int.from_bytes(ctx[off:off + size], "little")
        raise VMError(f"oob read @{addr:#x} size {size}")

    def mem_write(addr: int, size: int, val: int) -> None:
        if STACK_BASE <= addr and addr + size <= STACK_BASE + STACK_SIZE:
            off = addr - STACK_BASE
            stack[off:off + size] = u64(val).to_bytes(8, "little")[:size]
            return
        raise VMError(f"oob write @{addr:#x} size {size}")

    def helper_call(hid: int) -> int:
        sig = HELPERS.get(hid)
        if sig is None:
            raise VMError(f"unknown helper {hid}")
        a = [regs[i] for i in range(1, 6)]

        def key_at(ptr):
            return s64(mem_read(ptr, 8))

        def spec_state(fd):
            if not 0 <= fd < len(map_specs):
                raise VMError(f"bad map fd {fd}")
            sp = map_specs[fd]
            return sp, map_states[sp.name]

        name = sig.name
        if name == "map_lookup_elem":
            sp, st = spec_state(a[0])
            k = key_at(a[1])
            if sp.kind == M.MapKind.ARRAY:
                return u64(M.n_array_lookup(st, k))
            if sp.kind == M.MapKind.PERCPU_ARRAY:
                row = {"values": st["values"][aux.cpu % sp.num_shards]}
                return u64(M.n_array_lookup(row, k))
            return u64(M.n_hash_lookup(st, k))
        if name == "map_update_elem":
            sp, st = spec_state(a[0])
            k, v = key_at(a[1]), s64(mem_read(a[2], 8))
            if sp.kind == M.MapKind.ARRAY:
                M.n_array_update(st, k, v)
                return 0
            return 0 if M.n_hash_update(st, k, v) else u64(-7)  # E2BIG
        if name == "map_delete_elem":
            _, st = spec_state(a[0])
            return 0 if M.n_hash_delete(st, key_at(a[1])) else u64(-2)
        if name == "map_fetch_add":
            sp, st = spec_state(a[0])
            k = key_at(a[1])
            d = s64(a[2])
            if sp.kind == M.MapKind.ARRAY:
                return u64(M.n_array_fetch_add(st, k, d))
            return u64(M.n_hash_fetch_add(st, k, d))
        if name == "percpu_fetch_add":
            sp, st = spec_state(a[0])
            row = {"values": st["values"][aux.cpu % sp.num_shards]}
            return u64(M.n_array_fetch_add(row, key_at(a[1]), s64(a[2])))
        if name == "hist_add":
            _, st = spec_state(a[0])
            M.n_hist_add(st, s64(a[1]))
            return 0
        if name == "ringbuf_output":
            sp, st = spec_state(a[0])
            size = a[2]
            if size % 8 or size == 0 or size > 8 * sp.rec_width:
                raise VMError(f"bad ringbuf size {size}")
            rec = [s64(mem_read(a[1] + 8 * i, 8)) for i in range(size // 8)]
            rec += [0] * (sp.rec_width - len(rec))
            M.n_ringbuf_emit(st, rec)
            return 0
        if name == "ktime_get_ns":
            return u64(aux.time_ns)
        if name == "get_smp_processor_id":
            return u64(aux.cpu)
        if name == "get_current_pid_tgid":
            return u64(aux.pid)
        if name == "get_prandom_u32":
            # xorshift32, deterministic given aux seed (reproducible traces)
            x = aux.rand_state & 0xFFFFFFFF or 1
            x ^= (x << 13) & 0xFFFFFFFF
            x ^= x >> 17
            x ^= (x << 5) & 0xFFFFFFFF
            aux.rand_state = x
            return x
        if name == "trace_printk":
            aux.printk.append((s64(a[0]), s64(a[1])))
            return 0
        if name == "log2":
            return M.np_log2_bin(s64(a[0]))
        if name == "override_return":
            aux.override_set = 1
            aux.override_val = u64(a[0])
            return 0
        raise VMError(f"unimplemented helper {name}")

    while True:
        if pc >= len(insns):
            raise VMError("fell off end of program")
        executed += 1
        if executed > max_insns:
            raise VMError("instruction budget exceeded")
        ins = insns[pc]
        cls = ins.cls
        nxt = pc + 1

        if ins.is_lddw():
            regs[ins.dst] = u64(ins.imm64 or 0)
        elif cls in (BPF_ALU64, BPF_ALU):
            op = ins.op & OP_MASK
            is64 = cls == BPF_ALU64
            if op == isa.BPF_NEG:
                v = regs[ins.dst]
                regs[ins.dst] = u64(-s64(v)) if is64 else u32(-s32(v))
            else:
                if ins.op & SRC_MASK:
                    src = regs[ins.src]
                else:
                    src = u64(ins.imm) if is64 else u32(ins.imm)
                d = regs[ins.dst]
                if not is64:
                    d, src = u32(d), u32(src)
                regs[ins.dst] = _alu(op, d, src, is64)
        elif cls == BPF_LDX:
            size = SIZE_BYTES[ins.op & SIZE_MASK]
            regs[ins.dst] = mem_read(u64(regs[ins.src] + ins.off), size)
        elif cls == BPF_STX:
            size = SIZE_BYTES[ins.op & SIZE_MASK]
            mem_write(u64(regs[ins.dst] + ins.off), size, regs[ins.src])
        elif cls == BPF_ST:
            size = SIZE_BYTES[ins.op & SIZE_MASK]
            mem_write(u64(regs[ins.dst] + ins.off), size, u64(ins.imm))
        elif cls in (BPF_JMP, BPF_JMP32):
            op = ins.op & OP_MASK
            if op == isa.BPF_EXIT:
                return VMResult(regs[0], aux, executed)
            if op == isa.BPF_CALL:
                regs[0] = u64(helper_call(ins.imm))
                regs[1] = regs[2] = regs[3] = regs[4] = regs[5] = 0
            elif op == isa.BPF_JA:
                nxt = slot2idx[slots[pc] + 1 + ins.off]
            else:
                is64 = cls == BPF_JMP
                lhs = regs[ins.dst]
                rhs = regs[ins.src] if ins.op & SRC_MASK else u64(ins.imm)
                if not is64:
                    lhs, rhs = u32(lhs), u32(rhs)
                if _jmp_taken(op, lhs, rhs, is64):
                    nxt = slot2idx[slots[pc] + 1 + ins.off]
        else:
            raise VMError(f"bad insn class {cls:#x} at {pc}")
        pc = nxt


def _alu(op: int, d: int, s: int, is64: bool) -> int:
    mask = u64 if is64 else u32
    bits = 63 if is64 else 31
    if op == isa.BPF_ADD:
        return mask(d + s)
    if op == isa.BPF_SUB:
        return mask(d - s)
    if op == isa.BPF_MUL:
        return mask(d * s)
    if op == isa.BPF_DIV:
        return mask(d // s) if s else 0
    if op == isa.BPF_MOD:
        return mask(d % s) if s else mask(d)
    if op == isa.BPF_OR:
        return mask(d | s)
    if op == isa.BPF_AND:
        return mask(d & s)
    if op == isa.BPF_XOR:
        return mask(d ^ s)
    if op == isa.BPF_LSH:
        return mask(d << (s & bits))
    if op == isa.BPF_RSH:
        return mask(d >> (s & bits))
    if op == isa.BPF_ARSH:
        sv = s64(d) if is64 else s32(d)
        return mask(sv >> (s & bits))
    if op == isa.BPF_MOV:
        return mask(s)
    if op == isa.BPF_NEG:
        return mask(-(s64(d) if is64 else s32(d)))
    raise VMError(f"bad alu op {op:#x}")


def _jmp_taken(op: int, lhs: int, rhs: int, is64: bool) -> bool:
    sl = s64(lhs) if is64 else s32(lhs)
    sr = s64(rhs) if is64 else s32(rhs)
    if op == isa.BPF_JEQ:
        return lhs == rhs
    if op == isa.BPF_JNE:
        return lhs != rhs
    if op == isa.BPF_JGT:
        return lhs > rhs
    if op == isa.BPF_JGE:
        return lhs >= rhs
    if op == isa.BPF_JLT:
        return lhs < rhs
    if op == isa.BPF_JLE:
        return lhs <= rhs
    if op == isa.BPF_JSGT:
        return sl > sr
    if op == isa.BPF_JSGE:
        return sl >= sr
    if op == isa.BPF_JSLT:
        return sl < sr
    if op == isa.BPF_JSLE:
        return sl <= sr
    if op == isa.BPF_JSET:
        return (lhs & rhs) != 0
    raise VMError(f"bad jmp op {op:#x}")


def pack_ctx(words: list[int]) -> bytes:
    """Pack i64 words into a little-endian ctx blob (read via ldxdw [r1+8i])."""
    return b"".join(struct.pack("<q", s64(u64(w))) for w in words)
