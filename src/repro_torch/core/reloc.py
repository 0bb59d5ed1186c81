"""Load-time relocation — the CO-RE resolver (verify once, relocate anywhere).

A program verified in abstract mode (verifier.verify with map_refs /
ctx_refs) carries a :class:`RelocRecord`: which insns hold symbolic map
references, which insns took their ctx offset from a named field, and
the layouts they were verified against.  :func:`resolve` binds that
program to ANY concrete world — a map registry (name -> fd) and a target
ctx layout — without re-running the verifier fixpoint:

  * `lddw rX, map:NAME`  : imm64 patched local-index -> concrete fd, and
    every CallAnn mapfd static remapped the same way (the verifier's
    MAPVAL lattice kind guarantees those are the ONLY places a map
    reference can flow, so positional rebinding is sound);
  * ctx loads            : `off` re-offset from the source layout's byte
    of the field to the target layout's, with the MemAnn moved by the
    same delta and re-bounds/alignment-checked against the target width.

Everything verification actually proved — bounded execution, typed
helper args, initialized stack reads — is layout-independent and carries
over verbatim; relocation re-checks only the cheap structural facts
(symbol exists, kind matches, field in bounds).  All failures raise
:class:`RelocationError` BEFORE any output is built, so a bad target
world leaves nothing half-bound (the live-table generation counter is
never touched by a failed attach).
"""
from __future__ import annotations

from dataclasses import dataclass, replace as _dc_replace

from . import isa
from .isa import Insn
from .layout import CtxLayout, MapLayout
from .maps import MapSpec
from .verifier import CallAnn, MemAnn, VerifiedProgram
from .helpers import HELPERS


class RelocationError(ValueError):
    pass


@dataclass(frozen=True)
class RelocRecord:
    """insn index -> symbolic ref, plus the world verified against.

    ``map_layouts`` is the declared object-local map list (local index =
    position); ``map_lddw`` maps lddw insn idx -> local map index;
    ``ctx_refs`` maps ldx insn idx -> ctx field name; ``ctx_layout`` is
    the layout those offsets were assembled against (None when the
    program reads no named ctx fields).  ``resolved`` marks a record
    carried on an already-bound program (display only — re-resolving
    always starts from the abstract program)."""
    map_layouts: tuple[MapLayout, ...]
    map_lddw: dict[int, int]
    ctx_refs: dict[int, str]
    ctx_layout: CtxLayout | None = None
    resolved: bool = False

    def map_name(self, local: int) -> str:
        return self.map_layouts[local].name

    def symbols(self) -> tuple[str, ...]:
        return tuple(ml.name for ml in self.map_layouts)


def resolve(vabs: VerifiedProgram, fd_of: dict[str, int],
            concrete_specs: list[MapSpec],
            ctx_layout: CtxLayout | None = None,
            ctx_words: int | None = None) -> VerifiedProgram:
    """Bind an abstract VerifiedProgram to a concrete world.

    ``fd_of``/``concrete_specs`` describe the target registry (fd order);
    ``ctx_layout`` the target event-row layout (defaults to the source
    layout — pure map rebinding); ``ctx_words`` the target row width
    (defaults to the target layout's, else the program's). Returns a NEW
    runnable VerifiedProgram; ``vabs`` is never mutated, and on any
    error nothing is produced at all."""
    rec = vabs.reloc
    if not isinstance(rec, RelocRecord):
        raise RelocationError("program was not verified in abstract mode "
                              "(no relocation record)")
    if rec.resolved:
        raise RelocationError("program is already resolved — relocate from "
                              "the abstract original")

    # ---- phase 1: validate the whole binding, touching nothing ----------
    local_fd: dict[int, int] = {}
    for li, ml in enumerate(rec.map_layouts):
        fd = fd_of.get(ml.name)
        if fd is None:
            raise RelocationError(f"missing map symbol {ml.name!r} in target "
                                  f"registry (has {sorted(fd_of)})")
        if not 0 <= fd < len(concrete_specs):
            raise RelocationError(f"map {ml.name!r}: fd {fd} out of range "
                                  f"for registry of {len(concrete_specs)}")
        why = ml.compatible(concrete_specs[fd])
        if why:
            raise RelocationError(why)
        local_fd[li] = fd

    src_layout = rec.ctx_layout
    tgt_layout = ctx_layout or src_layout
    if ctx_words is None:
        ctx_words = tgt_layout.words if tgt_layout is not None else vabs.ctx_words
    ctx_bytes = 8 * ctx_words
    if rec.ctx_refs and (src_layout is None or tgt_layout is None):
        raise RelocationError("program has ctx relocations but no ctx layout")

    ctx_patch: dict[int, int] = {}   # insn idx -> new byte offset
    for idx, fld in rec.ctx_refs.items():
        if not tgt_layout.has(fld):
            raise RelocationError(
                f"insn {idx}: ctx field {fld!r} missing from target layout "
                f"{tgt_layout.name!r}")
        ann = vabs.anns.get(idx)
        assert isinstance(ann, MemAnn) and ann.region == "ctx"
        delta = tgt_layout.byte_of(fld) - src_layout.byte_of(fld)
        new_off = ann.off + delta
        if new_off < 0 or new_off + ann.size > ctx_bytes:
            raise RelocationError(
                f"insn {idx}: ctx field {fld!r} relocates to "
                f"[{new_off},{new_off + ann.size}) outside target ctx "
                f"({ctx_bytes}B)")
        if new_off % ann.size:
            raise RelocationError(
                f"insn {idx}: ctx field {fld!r} relocates to unaligned "
                f"offset {new_off} (size {ann.size})")
        ctx_patch[idx] = delta

    # non-relocated ctx accesses must still fit the (possibly narrower)
    # target row: their offsets are layout constants the program hard-coded
    for idx, ann in vabs.anns.items():
        if (isinstance(ann, MemAnn) and ann.region == "ctx"
                and idx not in ctx_patch):
            if ann.off + ann.size > ctx_bytes:
                raise RelocationError(
                    f"insn {idx}: fixed ctx access [{ann.off},"
                    f"{ann.off + ann.size}) outside target ctx ({ctx_bytes}B)")

    # ---- phase 2: build the bound program (fresh objects throughout) ----
    insns: list[Insn] = list(vabs.insns)
    for idx, li in rec.map_lddw.items():
        fd = local_fd[li]
        old = insns[idx]
        insns[idx] = Insn(old.op, old.dst, old.src, old.off,
                          imm=fd & 0xFFFFFFFF, imm64=fd)
    for idx, delta in ctx_patch.items():
        old = insns[idx]
        insns[idx] = Insn(old.op, old.dst, old.src, old.off + delta,
                          imm=old.imm, imm64=old.imm64)

    anns: dict[int, object] = {}
    for idx, ann in vabs.anns.items():
        if isinstance(ann, MemAnn):
            if idx in ctx_patch:
                off = ann.off + ctx_patch[idx]
                ann = MemAnn(ann.region, off, ann.size,
                             aligned=(off % 8 == 0 and ann.size == 8))
            else:
                ann = MemAnn(ann.region, ann.off, ann.size, aligned=ann.aligned)
        elif isinstance(ann, CallAnn):
            sig = HELPERS[ann.hid]
            statics = list(ann.statics)
            for i, kind in enumerate(sig.args):
                if kind == "mapfd":
                    statics[i] = local_fd[statics[i]]
            # key_vals are stack constants — layout-independent, carry over
            ann = CallAnn(hid=ann.hid, name=ann.name, statics=statics,
                          key_vals=ann.key_vals)
        anns[idx] = ann

    touched = frozenset(local_fd[li] for li in vabs.touched_map_fds)
    from .verifier import compute_footprints
    return VerifiedProgram(
        insns=insns, map_specs=list(concrete_specs), ctx_words=ctx_words,
        anns=anns, blocks=vabs.blocks, block_of=vabs.block_of,
        tier=vabs.tier, max_insns=vabs.max_insns,
        helper_ids_used=set(vabs.helper_ids_used),
        touched_map_fds=touched, touched_aux=vabs.touched_aux,
        footprints=compute_footprints(anns, concrete_specs),
        reloc=_dc_replace(rec, resolved=True))


def verify_relocatable(obj) -> VerifiedProgram:
    """Abstract-verify a loader.ProgramObject once, against its own
    declared maps and BTF — the artifact a fleet ships around and
    resolves per-world (the runtime path and `prog relocate` both come
    through here)."""
    from .layout import layout_for
    from .verifier import verify
    insns = obj.decode_insns()
    declared = obj.map_specs()
    src_layout = layout_for(obj.prog_type, obj.btf, obj.ctx_words)
    return verify(
        insns, declared, ctx_words=obj.ctx_words,
        map_refs={int(k): v for k, v in obj.relocs.items()},
        ctx_refs={int(k): v for k, v in getattr(obj, "ctx_relocs", {}).items()},
        ctx_layout=src_layout)


def relocation_table(vprog: VerifiedProgram) -> list[dict]:
    """Human/JSON rows for the `prog relocate` dry-run."""
    rec = vprog.reloc
    if not isinstance(rec, RelocRecord):
        return []
    rows = []
    for idx in sorted(rec.map_lddw):
        li = rec.map_lddw[idx]
        rows.append({"insn": idx, "kind": "map",
                     "symbol": rec.map_name(li), "local_fd": li,
                     "bound_fd": int(vprog.insns[idx].imm64 or 0)
                     if rec.resolved else None,
                     "disasm": isa.disasm_one(vprog.insns[idx])})
    for idx in sorted(rec.ctx_refs):
        fld = rec.ctx_refs[idx]
        rows.append({"insn": idx, "kind": "ctx", "symbol": fld,
                     "byte": vprog.insns[idx].off,
                     "src_byte": (rec.ctx_layout.byte_of(fld)
                                  if rec.ctx_layout else None),
                     "disasm": isa.disasm_one(vprog.insns[idx])})
    return rows
