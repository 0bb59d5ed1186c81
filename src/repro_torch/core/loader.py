"""Program-object loader — the libbpf/CO-RE analogue.

A ProgramObject is the serialized unit a control plane ships around (the
".o" file): bytecode + map specs + symbolic relocations + attach metadata.
Programs reference maps ONLY via `lddw rX, map:NAME` relocations; the
runtime binds NAME -> global map fd at load time and patches the imm64
(exactly how libbpf fixes up BPF_PSEUDO_MAP_FD). Map specs are unified by
name across objects — two tools declaring map "counts" share one map, the
paper's cross-process aggregation story.
"""
from __future__ import annotations

import json
from dataclasses import asdict, dataclass, field

from . import asm, isa
from .isa import Insn
from .layout import EVENT_BTF, SYSCALL_BTF  # canonical tables live in layout
from .maps import MapKind, MapSpec


class LoadError(ValueError):
    pass


@dataclass
class ProgramObject:
    name: str
    prog_type: str                  # uprobe|uretprobe|tracepoint|filter
    insns_hex: str
    maps: list[dict]                # serialized MapSpecs (object-local order)
    relocs: dict[str, str] = field(default_factory=dict)   # insn idx -> map name
    ctx_words: int = 16
    attach_to: str | None = None    # default target, e.g. "uprobe:mlp"
    btf: dict | None = None         # ctx field names -> word index (CO-RE-lite)
    # insn idx -> ctx field name: which insns took their `off` operand from a
    # `ctx:FIELD` substitution, so the program can be re-offset onto another
    # ctx layout without re-assembly (core/reloc.py).  Default {} keeps old
    # serialized objects loading unchanged.
    ctx_relocs: dict[str, str] = field(default_factory=dict)

    def to_json(self) -> str:
        return json.dumps(asdict(self), indent=1)

    @staticmethod
    def from_json(s: str) -> "ProgramObject":
        d = json.loads(s)
        return ProgramObject(**d)

    def decode_insns(self) -> list[Insn]:
        return isa.decode_program(bytes.fromhex(self.insns_hex))

    def map_specs(self) -> list[MapSpec]:
        out = []
        for m in self.maps:
            m = dict(m)
            m["kind"] = MapKind(m["kind"]) if not isinstance(m["kind"], MapKind) else m["kind"]
            out.append(MapSpec(**m))
        return out


def _spec_dict(s: MapSpec) -> dict:
    return {"name": s.name, "kind": s.kind.value,
            "max_entries": s.max_entries, "rec_width": s.rec_width,
            "num_shards": s.num_shards}


def build_object(name: str, text: str, maps: list[MapSpec],
                 prog_type: str = "uprobe", attach_to: str | None = None,
                 ctx_words: int = 16, btf: dict | None = None) -> ProgramObject:
    """Assemble source with CO-RE-lite field substitution.

    Occurrences of `ctx:FIELD` in ldx offsets are replaced using the btf
    table (defaults to the event layout), so programs survive event-layout
    changes by re-assembly — the relocation story of CO-RE.
    """
    table = btf or (SYSCALL_BTF if prog_type in ("tracepoint", "filter")
                    else EVENT_BTF)
    out_lines = []
    line_fields: dict[int, list[str]] = {}   # source line -> ctx fields used
    for lineno, line in enumerate(text.splitlines()):
        while "ctx:" in line:
            pre, rest = line.split("ctx:", 1)
            fieldname = ""
            for ch in rest:
                if ch.isalnum() or ch == "_":
                    fieldname += ch
                else:
                    break
            if fieldname not in table:
                raise LoadError(f"unknown ctx field {fieldname!r}")
            line_fields.setdefault(lineno, []).append(fieldname)
            line = pre + str(8 * table[fieldname]) + rest[len(fieldname):]
        out_lines.append(line)
    a = asm.assemble("\n".join(out_lines))
    local_names = [m.name for m in maps]
    for idx, mname in a.map_relocs.items():
        if mname not in local_names:
            raise LoadError(f"program references undeclared map {mname!r}")
    # map each ctx substitution back onto the insn its line assembled into
    ctx_relocs: dict[str, str] = {}
    for idx, lineno in enumerate(a.src_lines):
        fields = line_fields.get(lineno)
        if not fields:
            continue
        if len(fields) > 1:
            raise LoadError(
                f"line {lineno}: multiple ctx: references in one insn are "
                f"not relocatable")
        ctx_relocs[str(idx)] = fields[0]
    return ProgramObject(
        name=name, prog_type=prog_type,
        insns_hex=isa.encode_program(a.insns).hex(),
        maps=[_spec_dict(m) for m in maps],
        relocs={str(k): v for k, v in a.map_relocs.items()},
        ctx_words=ctx_words, attach_to=attach_to, btf=table,
        ctx_relocs=ctx_relocs)


def relocate(obj: ProgramObject, fd_of: dict[str, int]) -> list[Insn]:
    """Patch lddw map relocations with bound global fds."""
    insns = obj.decode_insns()
    for k, mname in obj.relocs.items():
        idx = int(k)
        if mname not in fd_of:
            raise LoadError(f"unbound map {mname!r}")
        old = insns[idx]
        if not old.is_lddw():
            raise LoadError(f"reloc target insn {idx} is not lddw")
        insns[idx] = Insn(old.op, old.dst, old.src, old.off,
                          imm=fd_of[mname] & 0xFFFFFFFF, imm64=fd_of[mname])
    return insns
