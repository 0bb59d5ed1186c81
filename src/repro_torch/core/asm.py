"""Tiny eBPF assembler — the `clang -target bpf` stand-in.

Syntax (one insn per line, `;` comments, `label:` lines):

    mov   r6, 0            ; alu64 imm
    add32 r6, r7           ; alu32 reg
    lddw  r1, map:counts   ; 64-bit imm w/ symbolic map relocation
    ldxdw r2, [r1+8]       ; loads/stores: b/h/w/dw
    stxdw [r10-8], r2
    jeq   r2, 0, out       ; cond jumps take a label
    call  map_fetch_add    ; helper by name or id
    exit
    out:
    exit

`lddw rX, map:NAME` emits a relocation entry ("CO-RE-lite"): the loader
patches the imm64 with the bound map fd at load time.
"""
from __future__ import annotations

from dataclasses import dataclass, field

from . import isa
from .isa import Insn


class AsmError(ValueError):
    pass


@dataclass
class Assembled:
    insns: list[Insn]
    # relocations: insn index -> symbolic map name (patched by the loader)
    map_relocs: dict[int, str] = field(default_factory=dict)
    # insn index -> 0-based source line number in the assembled text; lets
    # the loader map textual `ctx:FIELD` substitutions back onto the insn
    # they landed in (CO-RE ctx relocation records)
    src_lines: list[int] = field(default_factory=list)


_ALU_OPS = {
    "add": isa.BPF_ADD, "sub": isa.BPF_SUB, "mul": isa.BPF_MUL,
    "div": isa.BPF_DIV, "or": isa.BPF_OR, "and": isa.BPF_AND,
    "lsh": isa.BPF_LSH, "rsh": isa.BPF_RSH, "mod": isa.BPF_MOD,
    "xor": isa.BPF_XOR, "mov": isa.BPF_MOV, "arsh": isa.BPF_ARSH,
}
_JMP_OPS = {
    "jeq": isa.BPF_JEQ, "jgt": isa.BPF_JGT, "jge": isa.BPF_JGE,
    "jset": isa.BPF_JSET, "jne": isa.BPF_JNE, "jsgt": isa.BPF_JSGT,
    "jsge": isa.BPF_JSGE, "jlt": isa.BPF_JLT, "jle": isa.BPF_JLE,
    "jslt": isa.BPF_JSLT, "jsle": isa.BPF_JSLE,
}
_SIZES = {"b": isa.BPF_B, "h": isa.BPF_H, "w": isa.BPF_W, "dw": isa.BPF_DW}


def _reg(tok: str) -> int:
    tok = tok.strip().rstrip(",")
    if not tok.startswith("r") or not tok[1:].isdigit():
        raise AsmError(f"expected register, got {tok!r}")
    n = int(tok[1:])
    if not 0 <= n <= 10:
        raise AsmError(f"bad register r{n}")
    return n


def _int(tok: str) -> int:
    tok = tok.strip().rstrip(",")
    try:
        return int(tok, 0)
    except ValueError as e:
        raise AsmError(f"expected integer, got {tok!r}") from e


def _mem(tok: str) -> tuple[int, int]:
    """parse `[rX+off]` / `[rX-off]` / `[rX]` -> (reg, off)"""
    tok = tok.strip().rstrip(",")
    if not (tok.startswith("[") and tok.endswith("]")):
        raise AsmError(f"expected [rX+off], got {tok!r}")
    body = tok[1:-1].replace(" ", "")
    for sep in ("+", "-"):
        if sep in body[1:]:
            i = body.index(sep, 1)
            off = int(body[i:], 0)
            return _reg(body[:i]), off
    return _reg(body), 0


def assemble(text: str, helper_ids: dict[str, int] | None = None) -> Assembled:
    from .helpers import HELPER_IDS  # late import to avoid cycle
    helper_ids = {**HELPER_IDS, **(helper_ids or {})}

    lines: list[tuple[int, str, list[str]]] = []
    for lineno, raw in enumerate(text.splitlines()):
        line = raw.split(";")[0].split("//")[0].strip()
        if not line:
            continue
        parts = line.replace(",", " , ").split()
        parts = [p for p in parts if p != ","]
        lines.append((lineno, line, parts))

    # pass 1: label -> slot index
    labels: dict[str, int] = {}
    slot = 0
    for _, line, parts in lines:
        if len(parts) == 1 and parts[0].endswith(":"):
            name = parts[0][:-1]
            if name in labels:
                raise AsmError(f"duplicate label {name}")
            labels[name] = slot
            continue
        slot += 2 if parts[0] == "lddw" else 1

    # pass 2: emit
    out = Assembled(insns=[])
    slot = 0
    for lineno, line, parts in lines:
        if len(parts) == 1 and parts[0].endswith(":"):
            continue
        mn = parts[0].lower()
        args = parts[1:]
        try:
            ins, reloc = _emit(mn, args, labels, slot, helper_ids)
        except AsmError as e:
            raise AsmError(f"{e} in line: {line!r}") from None
        if reloc is not None:
            out.map_relocs[len(out.insns)] = reloc
        out.insns.append(ins)
        out.src_lines.append(lineno)
        slot += 2 if ins.is_lddw() else 1
    return out


def _emit(mn: str, a: list[str], labels: dict[str, int], slot: int,
          helper_ids: dict[str, int]) -> tuple[Insn, str | None]:
    def label_off(tok: str) -> int:
        tok = tok.strip()
        if tok in labels:
            return labels[tok] - slot - 1
        return _int(tok)

    if mn == "lddw":
        dst = _reg(a[0])
        tok = a[1].strip()
        if tok.startswith("map:"):
            return Insn(isa.BPF_LD | isa.BPF_IMM | isa.BPF_DW, dst=dst,
                        imm=0, imm64=0), tok[4:]
        return Insn(isa.BPF_LD | isa.BPF_IMM | isa.BPF_DW, dst=dst,
                    imm=0, imm64=isa.u64(_int(tok))), None

    if mn in ("exit", "ret"):
        return Insn(isa.BPF_JMP | isa.BPF_EXIT), None

    if mn == "call":
        tok = a[0].strip()
        hid = helper_ids.get(tok)
        if hid is None:
            hid = _int(tok)
        return Insn(isa.BPF_JMP | isa.BPF_CALL, imm=hid), None

    if mn == "ja":
        return Insn(isa.BPF_JMP | isa.BPF_JA, off=label_off(a[0])), None

    w32 = mn.endswith("32")
    base = mn[:-2] if w32 else mn

    if base in ("neg",):
        cls = isa.BPF_ALU if w32 else isa.BPF_ALU64
        return Insn(cls | isa.BPF_NEG, dst=_reg(a[0])), None

    if base in _ALU_OPS:
        cls = isa.BPF_ALU if w32 else isa.BPF_ALU64
        dst = _reg(a[0])
        srctok = a[1].strip()
        if srctok.startswith("r") and srctok[1:].isdigit():
            return Insn(cls | _ALU_OPS[base] | isa.BPF_X, dst=dst,
                        src=_reg(srctok)), None
        return Insn(cls | _ALU_OPS[base] | isa.BPF_K, dst=dst,
                    imm=_int(srctok)), None

    if base in _JMP_OPS:
        cls = isa.BPF_JMP32 if w32 else isa.BPF_JMP
        dst = _reg(a[0])
        srctok = a[1].strip()
        off = label_off(a[2])
        if srctok.startswith("r") and srctok[1:].isdigit():
            return Insn(cls | _JMP_OPS[base] | isa.BPF_X, dst=dst,
                        src=_reg(srctok), off=off), None
        return Insn(cls | _JMP_OPS[base] | isa.BPF_K, dst=dst,
                    imm=_int(srctok), off=off), None

    if base.startswith("ldx"):
        sz = _SIZES[base[3:]]
        dst = _reg(a[0])
        src, off = _mem(a[1])
        return Insn(isa.BPF_LDX | isa.BPF_MEM | sz, dst=dst, src=src,
                    off=off), None

    if base.startswith("stx"):
        sz = _SIZES[base[3:]]
        dst, off = _mem(a[0])
        src = _reg(a[1])
        return Insn(isa.BPF_STX | isa.BPF_MEM | sz, dst=dst, src=src,
                    off=off), None

    if base.startswith("st"):
        sz = _SIZES[base[2:]]
        dst, off = _mem(a[0])
        return Insn(isa.BPF_ST | isa.BPF_MEM | sz, dst=dst, off=off,
                    imm=_int(a[1])), None

    raise AsmError(f"unknown mnemonic {mn!r}")
