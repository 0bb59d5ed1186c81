"""eBPF-subset ISA: faithful 8-byte instruction encoding (Linux uapi layout).

Instruction layout (little-endian, struct '<BBhi'):
    opcode:u8 | dst_reg:4,src_reg:4 | off:s16 | imm:s32
LDDW (BPF_LD|BPF_IMM|BPF_DW) is the only 16-byte insn; the second slot
carries the high 32 bits of the 64-bit immediate in its imm field.

Registers: r0 (return value), r1-r5 (helper args, caller-saved),
r6-r9 (callee-saved), r10 (read-only frame pointer).
"""
from __future__ import annotations

import struct
from dataclasses import dataclass

# ---------------------------------------------------------------- classes
BPF_LD = 0x00
BPF_LDX = 0x01
BPF_ST = 0x02
BPF_STX = 0x03
BPF_ALU = 0x04
BPF_JMP = 0x05
BPF_JMP32 = 0x06
BPF_ALU64 = 0x07

CLS_MASK = 0x07

# ---------------------------------------------------------------- sizes (ld/st)
BPF_W = 0x00   # u32
BPF_H = 0x08   # u16
BPF_B = 0x10   # u8
BPF_DW = 0x18  # u64
SIZE_MASK = 0x18
SIZE_BYTES = {BPF_W: 4, BPF_H: 2, BPF_B: 1, BPF_DW: 8}

# ---------------------------------------------------------------- modes (ld/st)
BPF_IMM = 0x00
BPF_MEM = 0x60
MODE_MASK = 0xE0

# ---------------------------------------------------------------- alu/jmp source
BPF_K = 0x00   # use imm
BPF_X = 0x08   # use src reg
SRC_MASK = 0x08

# ---------------------------------------------------------------- alu ops
BPF_ADD = 0x00
BPF_SUB = 0x10
BPF_MUL = 0x20
BPF_DIV = 0x30
BPF_OR = 0x40
BPF_AND = 0x50
BPF_LSH = 0x60
BPF_RSH = 0x70
BPF_NEG = 0x80
BPF_MOD = 0x90
BPF_XOR = 0xA0
BPF_MOV = 0xB0
BPF_ARSH = 0xC0
OP_MASK = 0xF0

ALU_OP_NAMES = {
    BPF_ADD: "add", BPF_SUB: "sub", BPF_MUL: "mul", BPF_DIV: "div",
    BPF_OR: "or", BPF_AND: "and", BPF_LSH: "lsh", BPF_RSH: "rsh",
    BPF_NEG: "neg", BPF_MOD: "mod", BPF_XOR: "xor", BPF_MOV: "mov",
    BPF_ARSH: "arsh",
}

# ---------------------------------------------------------------- jmp ops
BPF_JA = 0x00
BPF_JEQ = 0x10
BPF_JGT = 0x20
BPF_JGE = 0x30
BPF_JSET = 0x40
BPF_JNE = 0x50
BPF_JSGT = 0x60
BPF_JSGE = 0x70
BPF_CALL = 0x80
BPF_EXIT = 0x90
BPF_JLT = 0xA0
BPF_JLE = 0xB0
BPF_JSLT = 0xC0
BPF_JSLE = 0xD0

JMP_OP_NAMES = {
    BPF_JA: "ja", BPF_JEQ: "jeq", BPF_JGT: "jgt", BPF_JGE: "jge",
    BPF_JSET: "jset", BPF_JNE: "jne", BPF_JSGT: "jsgt", BPF_JSGE: "jsge",
    BPF_CALL: "call", BPF_EXIT: "exit", BPF_JLT: "jlt", BPF_JLE: "jle",
    BPF_JSLT: "jslt", BPF_JSLE: "jsle",
}
COND_JMP_OPS = (BPF_JEQ, BPF_JGT, BPF_JGE, BPF_JSET, BPF_JNE, BPF_JSGT,
                BPF_JSGE, BPF_JLT, BPF_JLE, BPF_JSLT, BPF_JSLE)

# ---------------------------------------------------------------- memory map
# Pointer values are plain 64-bit integers; regions are carved out of the
# address space so both the interpreter and verifier can classify them.
STACK_SIZE = 512
STACK_BASE = 0x1_0000_0000          # r10 == STACK_BASE + STACK_SIZE
CTX_BASE = 0x2_0000_0000            # r1 at entry (read-only)
MAX_CTX_BYTES = 512

NUM_REGS = 11
R0, R1, R2, R3, R4, R5, R6, R7, R8, R9, R10 = range(11)

U64 = (1 << 64) - 1
U32 = (1 << 32) - 1


def u64(x: int) -> int:
    return x & U64


def s64(x: int) -> int:
    x &= U64
    return x - (1 << 64) if x >> 63 else x


def u32(x: int) -> int:
    return x & U32


def s32(x: int) -> int:
    x &= U32
    return x - (1 << 32) if x >> 31 else x


@dataclass(frozen=True)
class Insn:
    op: int
    dst: int = 0
    src: int = 0
    off: int = 0
    imm: int = 0
    # imm64 is only meaningful for LDDW; carried unencoded for convenience.
    imm64: int | None = None

    @property
    def cls(self) -> int:
        return self.op & CLS_MASK

    def is_lddw(self) -> bool:
        return self.op == (BPF_LD | BPF_IMM | BPF_DW)

    def encode(self) -> bytes:
        regs = ((self.src & 0xF) << 4) | (self.dst & 0xF)
        if self.is_lddw():
            v = u64(self.imm64 if self.imm64 is not None else self.imm)
            lo = v & U32
            hi = (v >> 32) & U32
            return (struct.pack("<BBhi", self.op, regs, self.off, s32(lo))
                    + struct.pack("<BBhi", 0, 0, 0, s32(hi)))
        return struct.pack("<BBhi", self.op, regs, self.off, s32(self.imm))

    def __repr__(self) -> str:  # pragma: no cover - debug aid
        return disasm_one(self)


def encode_program(insns: list[Insn]) -> bytes:
    return b"".join(i.encode() for i in insns)


def decode_program(blob: bytes) -> list[Insn]:
    if len(blob) % 8:
        raise ValueError("program length not a multiple of 8")
    raw = [struct.unpack_from("<BBhi", blob, i) for i in range(0, len(blob), 8)]
    out: list[Insn] = []
    i = 0
    while i < len(raw):
        op, regs, off, imm = raw[i]
        dst, src = regs & 0xF, (regs >> 4) & 0xF
        if op == (BPF_LD | BPF_IMM | BPF_DW):
            if i + 1 >= len(raw):
                raise ValueError("truncated lddw")
            _, _, _, hi = raw[i + 1]
            imm64 = u64((u32(hi) << 32) | u32(imm))
            out.append(Insn(op, dst, src, off, imm, imm64=imm64))
            i += 2
            continue
        out.append(Insn(op, dst, src, off, imm))
        i += 1
    return out


def insn_slots(insns: list[Insn]) -> list[int]:
    """Slot index (in 8-byte units) of each decoded insn — jump offsets are
    expressed in slots, and LDDW occupies two."""
    slots, cur = [], 0
    for ins in insns:
        slots.append(cur)
        cur += 2 if ins.is_lddw() else 1
    return slots


# ---------------------------------------------------------------- table form
# Handler classes for the device-resident program-table interpreter
# (table_interp.py): every decoded insn maps to one of these at ENCODE time,
# so the in-graph interpreter dispatches on a small data-driven switch
# instead of decoding opcodes with tensor bit arithmetic.
(TH_ALU64, TH_ALU32, TH_LDDW, TH_LDX, TH_ST, TH_STX, TH_JA, TH_JCOND64,
 TH_JCOND32, TH_CALL, TH_EXIT) = range(11)

# Fields of the packed form, one flat i64 array per field (length = n insns):
#   hcls     handler class (TH_*)
#   dst/src  register numbers
#   off      s16 memory offset (jump offsets are pre-resolved into `tgt`)
#   imm      sign-extended immediate; full s64 value for LDDW
#   aluop    (op & OP_MASK) >> 4 — ALU op index, or cond-jump op index
#   use_imm  1 when the K (immediate) source form is used
#   size     access width in bytes for ld/st
#   tgt      next insn INDEX when the insn transfers control (ja/taken cond);
#            i + 1 for everything else, so `tgt` is the universal "taken" pc
#   hid      helper BRANCH index (via helper_index) for TH_CALL
TABLE_FIELDS = ("hcls", "dst", "src", "off", "imm", "aluop", "use_imm",
                "size", "tgt", "hid")


def encode_table_program(insns: list[Insn],
                         helper_index: dict[int, int] | None = None) -> dict:
    """Pack decoded (already verified) bytecode into fixed-layout i64 arrays
    for the table interpreter. Jump targets are resolved from slot units to
    decoded-insn indices here, so the interpreter never touches slot math.
    Returns {field: list[int]} of equal length (see TABLE_FIELDS)."""
    n = len(insns)
    slots = insn_slots(insns)
    slot2idx = {s: i for i, s in enumerate(slots)}
    out = {f: [0] * n for f in TABLE_FIELDS}

    def jump_target(i: int) -> int:
        tgt_slot = slots[i] + 1 + insns[i].off
        if tgt_slot not in slot2idx:
            raise ValueError(f"insn {i}: jump to invalid slot {tgt_slot}")
        return slot2idx[tgt_slot]

    for i, ins in enumerate(insns):
        cls = ins.cls
        out["dst"][i] = ins.dst
        out["src"][i] = ins.src
        out["off"][i] = ins.off
        out["tgt"][i] = i + 1
        if ins.is_lddw():
            out["hcls"][i] = TH_LDDW
            out["imm"][i] = s64(ins.imm64 or 0)
        elif cls in (BPF_ALU64, BPF_ALU):
            out["hcls"][i] = TH_ALU64 if cls == BPF_ALU64 else TH_ALU32
            out["aluop"][i] = (ins.op & OP_MASK) >> 4
            out["use_imm"][i] = 0 if ins.op & SRC_MASK else 1
            out["imm"][i] = ins.imm
        elif cls == BPF_LDX:
            out["hcls"][i] = TH_LDX
            out["size"][i] = SIZE_BYTES[ins.op & SIZE_MASK]
        elif cls in (BPF_ST, BPF_STX):
            out["hcls"][i] = TH_ST if cls == BPF_ST else TH_STX
            out["size"][i] = SIZE_BYTES[ins.op & SIZE_MASK]
            out["imm"][i] = ins.imm
        elif cls in (BPF_JMP, BPF_JMP32):
            jop = ins.op & OP_MASK
            if jop == BPF_EXIT:
                out["hcls"][i] = TH_EXIT
            elif jop == BPF_JA:
                out["hcls"][i] = TH_JA
                out["tgt"][i] = jump_target(i)
            elif jop == BPF_CALL:
                out["hcls"][i] = TH_CALL
                out["hid"][i] = (helper_index[ins.imm] if helper_index
                                 else ins.imm)
            else:
                out["hcls"][i] = (TH_JCOND64 if cls == BPF_JMP
                                  else TH_JCOND32)
                out["aluop"][i] = jop >> 4
                out["use_imm"][i] = 0 if ins.op & SRC_MASK else 1
                out["imm"][i] = ins.imm
                out["tgt"][i] = jump_target(i)
        else:
            raise ValueError(f"insn {i}: unknown class {cls:#x}")
    return out


def disasm_one(ins: Insn) -> str:
    cls = ins.cls
    if ins.is_lddw():
        return f"lddw r{ins.dst}, {ins.imm64:#x}"
    if cls in (BPF_ALU, BPF_ALU64):
        name = ALU_OP_NAMES.get(ins.op & OP_MASK, "?")
        w = "" if cls == BPF_ALU64 else "32"
        if (ins.op & OP_MASK) == BPF_NEG:
            return f"neg{w} r{ins.dst}"
        src = f"r{ins.src}" if ins.op & BPF_X else f"{ins.imm}"
        return f"{name}{w} r{ins.dst}, {src}"
    if cls in (BPF_JMP, BPF_JMP32):
        jop = ins.op & OP_MASK
        name = JMP_OP_NAMES.get(jop, "?")
        if jop == BPF_EXIT:
            return "exit"
        if jop == BPF_CALL:
            return f"call {ins.imm}"
        if jop == BPF_JA:
            return f"ja +{ins.off}"
        src = f"r{ins.src}" if ins.op & BPF_X else f"{ins.imm}"
        w = "" if cls == BPF_JMP else "32"
        return f"{name}{w} r{ins.dst}, {src}, +{ins.off}"
    if cls in (BPF_LDX, BPF_ST, BPF_STX):
        sz = {BPF_W: "w", BPF_H: "h", BPF_B: "b", BPF_DW: "dw"}[ins.op & SIZE_MASK]
        if cls == BPF_LDX:
            return f"ldx{sz} r{ins.dst}, [r{ins.src}{ins.off:+d}]"
        if cls == BPF_STX:
            return f"stx{sz} [r{ins.dst}{ins.off:+d}], r{ins.src}"
        return f"st{sz} [r{ins.dst}{ins.off:+d}], {ins.imm}"
    return f"raw op={ins.op:#x}"


def disasm(insns: list[Insn]) -> str:
    return "\n".join(f"{i:4d}: {disasm_one(x)}" for i, x in enumerate(insns))
