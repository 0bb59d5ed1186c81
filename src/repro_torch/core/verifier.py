"""Static verifier — the userspace analogue of the kernel eBPF verifier (SP1).

Abstract interpretation over the CFG with a small lattice per register:

    uninit < {scalar, const(v), ptr_stack(off), ptr_ctx(off)} < conflict

plus a per-state set of initialized stack bytes. Guarantees provided to the
JIT (which therefore needs NO runtime checks — the paper's "verify once,
run fast" property):

  * every memory access has a statically known (region, offset, size),
    in bounds, and reads only initialized bytes;
  * ctx is read-only; r10 is never written; no variable pointer arithmetic;
  * helper args are well-typed; map fds and ringbuf sizes are compile-time
    constants resolving to bound maps of the right kind;
  * r0 is set before EXIT; execution is bounded (DAG, or loops with an
    explicit fuel bound — the analogue of the kernel's 1M-insn budget);
  * no unknown opcodes / helpers; program length capped.
"""
from __future__ import annotations

import threading
from dataclasses import dataclass, field

from . import isa, vm
from .helpers import HELPERS
from .isa import (BPF_ALU, BPF_ALU64, BPF_JMP, BPF_JMP32, BPF_LDX, BPF_ST,
                  BPF_STX, COND_JMP_OPS, Insn, OP_MASK, SIZE_BYTES, SIZE_MASK,
                  SRC_MASK, STACK_SIZE, s64, u32, u64)
from .maps import MapKind, MapSpec

MAX_PROG_INSNS = 4096

# Monotone counters — tests assert relocation does ZERO re-verification by
# pinning verify_calls across a relocate-to-N-worlds loop. Increments are
# serialized under _STATS_LOCK so the background promotion thread and the
# fuzz harness cannot lose updates; the object stays a plain dict (tests
# assign STATS["verify_calls"] = 0 directly).
STATS = {"verify_calls": 0}
_STATS_LOCK = threading.Lock()


def reset_stats() -> None:
    """Zero all counters (harness entry points call this between runs)."""
    with _STATS_LOCK:
        for k in STATS:
            STATS[k] = 0


class VerifierError(ValueError):
    pass


# ---------------------------------------------------------------- reg lattice
UNINIT, SCALAR, CONST, PTR_STACK, PTR_CTX, CONFLICT = range(6)
# Abstract map reference (the kernel's CONST_PTR_TO_MAP analogue): produced
# only by `lddw rX, map:NAME` in abstract mode, val = object-local map index.
# It may be mov-copied and passed as a helper mapfd arg — nothing else — so
# relocation can rebind names to concrete fds knowing every mapfd a helper
# sees is provenance-tracked (a forged scalar fd cannot sneak past rebinding).
MAPVAL = 6
_KIND_NAMES = {UNINIT: "uninit", SCALAR: "scalar", CONST: "const",
               PTR_STACK: "ptr_stack", PTR_CTX: "ptr_ctx",
               CONFLICT: "conflict", MAPVAL: "mapval"}


@dataclass(frozen=True)
class Reg:
    kind: int = UNINIT
    val: int = 0  # const value (u64) or pointer offset from region base

    def __repr__(self):
        return f"{_KIND_NAMES[self.kind]}({self.val})"


def _merge_reg(a: Reg, b: Reg) -> Reg:
    if a == b:
        return a
    if UNINIT in (a.kind, b.kind):
        return Reg(UNINIT)
    ka, kb = a.kind, b.kind
    if {ka, kb} <= {SCALAR, CONST}:
        return Reg(SCALAR)
    if ka == kb and ka in (PTR_STACK, PTR_CTX):
        return Reg(CONFLICT)  # same region, different offset
    return Reg(CONFLICT)


@dataclass(frozen=True)
class AbsState:
    regs: tuple[Reg, ...]
    stack_init: frozenset[int]
    # statically-known stack words: (byte_off, u64_value) for every aligned
    # 8-byte slot last written with a compile-time constant on ALL paths.
    # Merge is set intersection; any overlapping store invalidates. This is
    # what lets a helper's key pointer resolve to a STATIC key value — the
    # raw material of the effect-footprint lattice (DESIGN.md §14).
    stack_const: frozenset[tuple[int, int]] = frozenset()

    def with_reg(self, i: int, r: Reg) -> "AbsState":
        rs = list(self.regs)
        rs[i] = r
        return AbsState(tuple(rs), self.stack_init, self.stack_const)


def _merge_state(a: AbsState, b: AbsState) -> AbsState:
    return AbsState(tuple(_merge_reg(x, y) for x, y in zip(a.regs, b.regs)),
                    a.stack_init & b.stack_init,
                    a.stack_const & b.stack_const)


# ---------------------------------------------------------------- annotations
@dataclass
class MemAnn:
    region: str     # 'stack' | 'ctx'
    off: int        # byte offset from region base
    size: int
    # verifier-proven natural 8-byte alignment: the JIT's word-oriented
    # stack lowers these to a single word load/store (no shifts/masks).
    aligned: bool = False


@dataclass
class CallAnn:
    hid: int
    name: str
    # per-arg resolved statics: for mapfd -> fd int; kptr -> stack off;
    # cscalar -> value; scalar -> None
    statics: list
    # per-arg statically-known POINTEE values: for a kptr arg whose stack
    # word holds a path-invariant constant, the s64 value; None elsewhere.
    # Layout-independent (stack contents), so relocation carries it over.
    key_vals: list | None = None


# helpers whose map side effects commute across programs/events (order-free);
# the single source of truth for runtime._COMMUTATIVE_HELPERS and
# table_interp._BATCH_EFFECT.
COMMUTATIVE_HELPERS = frozenset(
    {"map_fetch_add", "percpu_fetch_add", "hist_add"})

# which helper arg (0-based) is the MAP KEY pointer, for key-addressed ops
_KEY_ARG = {"map_lookup_elem": 1, "map_update_elem": 1, "map_delete_elem": 1,
            "map_fetch_add": 1, "percpu_fetch_add": 1}


@dataclass(frozen=True)
class MapFootprint:
    """Per-map effect footprint — what the program can do to one map.

    ``ops`` are the helper names touching it; ``commutative_only`` means
    every touch is in COMMUTATIVE_HELPERS (order across programs is
    unobservable in the map's final state); ``static_keys`` is the exact
    set of s64 key values the program can address when EVERY key-addressed
    touch resolved to a stack constant, else None (some key is dynamic).
    The widening rules in runtime._has_ordering_conflict and
    table_interp._recompute_vec PROVE commutativity from these instead of
    assuming conflict (DESIGN.md §14)."""
    fd: int
    name: str
    kind: MapKind
    max_entries: int
    ops: frozenset[str]
    commutative_only: bool
    static_keys: frozenset[int] | None


def compute_footprints(anns: dict, map_specs) -> dict[int, MapFootprint]:
    """Derive per-map footprints from the CallAnns of a verified program.
    Shared by verify() and reloc.resolve() (which rebinds fds and must
    recompute against the concrete registry)."""
    touches: dict[int, dict] = {}
    for ann in anns.values():
        if not isinstance(ann, CallAnn):
            continue
        sig = HELPERS[ann.hid]
        for i, kind in enumerate(sig.args):
            if kind != "mapfd":
                continue
            fd = ann.statics[i]
            t = touches.setdefault(
                fd, {"ops": set(), "comm": True, "keys": set(),
                     "static": True})
            t["ops"].add(sig.name)
            t["comm"] = t["comm"] and sig.name in COMMUTATIVE_HELPERS
            ka = _KEY_ARG.get(sig.name)
            kv = (ann.key_vals[ka] if ka is not None
                  and ann.key_vals is not None else None)
            if kv is None:
                t["static"] = False      # non-keyed op or dynamic key
            else:
                t["keys"].add(kv)
    return {fd: MapFootprint(
        fd=fd, name=map_specs[fd].name, kind=map_specs[fd].kind,
        max_entries=map_specs[fd].max_entries, ops=frozenset(t["ops"]),
        commutative_only=t["comm"],
        static_keys=frozenset(t["keys"]) if t["static"] else None)
        for fd, t in touches.items()}


# map kinds whose storage is positional (cell = key), so the layout never
# depends on op order — the precondition of widening rule 1 (HASH is
# excluded: inserts shape the physical probe-chain layout)
_POSITIONAL_KINDS = (MapKind.ARRAY, MapKind.PERCPU_ARRAY)


def footprints_disjoint(fa: MapFootprint | None,
                        fb: MapFootprint | None) -> bool:
    """Widening rule 1 (DESIGN.md §14): two programs sharing one map
    non-commutatively still cannot observe each other's order when the map
    is positional (ARRAY / PERCPU_ARRAY), both key sets are fully static
    and in bounds, and the sets are disjoint — each program's reads and
    writes are confined to its own cells, and every execution lane
    preserves each program's own op order. Certified by the fuzz harness
    (tests/test_widening.py)."""
    if fa is None or fb is None:
        return False
    if fa.kind not in _POSITIONAL_KINDS:
        return False
    if fa.static_keys is None or fb.static_keys is None:
        return False
    n = fa.max_entries
    if any(not 0 <= k < n for k in fa.static_keys | fb.static_keys):
        return False        # out-of-bounds keys clamp/no-op: don't reason
    return not (fa.static_keys & fb.static_keys)


@dataclass
class Block:
    start: int
    end: int                      # exclusive, insn indices
    succ: list[int] = field(default_factory=list)   # successor block ids
    # terminator kind: 'cond' (succ=[taken, fall]), 'ja', 'exit', 'fall'
    term: str = "fall"


@dataclass
class VerifiedProgram:
    insns: list[Insn]
    map_specs: list[MapSpec]
    ctx_words: int
    anns: dict[int, object]       # insn idx -> MemAnn | CallAnn
    blocks: list[Block]
    block_of: dict[int, int]      # leader insn idx -> block id
    tier: str                     # 'dag' | 'loop'
    max_insns: int
    helper_ids_used: set[int] = field(default_factory=set)
    # static side-effect footprint (the touched-maps analysis): which map
    # fds this program can write/read through helpers, and which aux fields
    # it can write. The fused runtime pipeline gates per-event state selects
    # to exactly this footprint instead of selecting over ALL map state.
    touched_map_fds: frozenset = frozenset()
    touched_aux: frozenset = frozenset()
    # fd -> MapFootprint (the effect-footprint lattice, DESIGN.md §14):
    # proven per-map op sets, commutativity, and static key ranges. The
    # fused/batched schedulers widen their ordering guards from these.
    footprints: dict = field(default_factory=dict)
    # relocation record (reloc.RelocRecord) when verified in abstract mode:
    # insn index -> symbolic ref, plus the layouts verified against. None
    # for layout-concrete programs. An abstract program is NOT runnable —
    # core/reloc.resolve() binds it to a concrete world first.
    reloc: object = None

    @property
    def is_abstract(self) -> bool:
        return self.reloc is not None and not getattr(
            self.reloc, "resolved", False)

    def touched_map_names(self) -> tuple[str, ...]:
        return tuple(self.map_specs[fd].name
                     for fd in sorted(self.touched_map_fds))

    def footprint_of(self, name: str) -> MapFootprint | None:
        for fp in self.footprints.values():
            if fp.name == name:
                return fp
        return None


def verify(insns: list[Insn], map_specs: list[MapSpec], ctx_words: int = 16,
           max_insns: int = 65536, *, map_refs: dict[int, str] | None = None,
           ctx_refs: dict[int, str] | None = None,
           ctx_layout=None) -> VerifiedProgram:
    """Verify a program against a world of maps + ctx layout.

    Concrete mode (default): `map_specs` is the runtime's registry in fd
    order; lddw imm64s are already-patched fds. Abstract mode (any of
    `map_refs`/`ctx_refs`/`ctx_layout` given): `map_specs` is the
    program's DECLARED map list (object-local order), `map_refs` names
    the `lddw rX, map:NAME` insns and `ctx_refs` the insns whose off
    came from a `ctx:FIELD` substitution against `ctx_layout`. The
    result carries a relocation record and binds to any concrete
    registry via core/reloc.resolve() — verify once, relocate anywhere.
    """
    with _STATS_LOCK:
        STATS["verify_calls"] += 1
    abstract = (map_refs is not None or ctx_refs is not None
                or ctx_layout is not None)
    if not insns:
        raise VerifierError("empty program")
    if len(insns) > MAX_PROG_INSNS:
        raise VerifierError(f"program too long ({len(insns)} insns)")
    if ctx_words * 8 > isa.MAX_CTX_BYTES:
        raise VerifierError("ctx too large")
    ctx_bytes = ctx_words * 8

    if ctx_refs and ctx_layout is None:
        raise VerifierError("ctx_refs given without the ctx_layout they "
                            "were assembled against")
    # symbolic map refs -> object-local indices, validated up front
    map_local_of: dict[int, int] = {}
    if map_refs:
        name_to_local = {s.name: i for i, s in enumerate(map_specs)}
        for idx, mname in map_refs.items():
            if not 0 <= idx < len(insns) or not insns[idx].is_lddw():
                raise VerifierError(
                    f"map reloc at insn {idx} is not an lddw")
            if mname not in name_to_local:
                raise VerifierError(
                    f"insn {idx}: reference to undeclared map {mname!r}")
            map_local_of[idx] = name_to_local[mname]

    slots = isa.insn_slots(insns)
    slot2idx = {s: i for i, s in enumerate(slots)}

    def jump_target(pc: int) -> int:
        tgt_slot = slots[pc] + 1 + insns[pc].off
        if tgt_slot not in slot2idx:
            raise VerifierError(f"insn {pc}: jump to invalid slot {tgt_slot}")
        return slot2idx[tgt_slot]

    # ---------------- successor graph on insn indices
    succs: dict[int, list[int]] = {}
    for pc, ins in enumerate(insns):
        cls = ins.cls
        if cls in (BPF_JMP, BPF_JMP32):
            op = ins.op & OP_MASK
            if op == isa.BPF_EXIT:
                succs[pc] = []
                continue
            if op == isa.BPF_JA:
                succs[pc] = [jump_target(pc)]
                continue
            if op in COND_JMP_OPS:
                fall = pc + 1
                if fall >= len(insns):
                    raise VerifierError(f"insn {pc}: cond jump falls off end")
                succs[pc] = [jump_target(pc), fall]
                continue
        if pc + 1 >= len(insns):
            raise VerifierError(f"insn {pc}: program falls off end")
        succs[pc] = [pc + 1]

    # ---------------- abstract interpretation (worklist to fixpoint)
    entry_regs = [Reg(UNINIT)] * 11
    entry_regs[isa.R1] = Reg(PTR_CTX, 0)
    entry_regs[isa.R10] = Reg(PTR_STACK, STACK_SIZE)
    entry = AbsState(tuple(entry_regs), frozenset())

    in_states: dict[int, AbsState] = {0: entry}
    work = [0]
    anns: dict[int, object] = {}
    helper_ids_used: set[int] = set()
    iters = 0
    while work:
        iters += 1
        if iters > 200_000:
            raise VerifierError("verifier fixpoint did not converge")
        pc = work.pop()
        out = _transfer(pc, insns[pc], in_states[pc], map_specs, ctx_bytes,
                        anns, helper_ids_used, map_local_of, abstract)
        for s in succs[pc]:
            merged = out if s not in in_states else _merge_state(in_states[s], out)
            if s not in in_states or merged != in_states[s]:
                in_states[s] = merged
                work.append(s)

    reachable = set(in_states)

    # ---------------- blocks
    leaders = {0}
    for pc in reachable:
        ins = insns[pc]
        cls = ins.cls
        if cls in (BPF_JMP, BPF_JMP32):
            op = ins.op & OP_MASK
            if op in COND_JMP_OPS or op == isa.BPF_JA:
                for s in succs[pc]:
                    leaders.add(s)
                if pc + 1 < len(insns):
                    leaders.add(pc + 1)
            elif op == isa.BPF_EXIT and pc + 1 < len(insns):
                leaders.add(pc + 1)
    leaders = sorted(x for x in leaders if x in reachable)
    block_of: dict[int, int] = {l: i for i, l in enumerate(leaders)}
    blocks: list[Block] = []
    for bi, start in enumerate(leaders):
        end = start
        while True:
            ins = insns[end]
            cls = ins.cls
            is_term = (cls in (BPF_JMP, BPF_JMP32) and
                       (ins.op & OP_MASK) in
                       (*COND_JMP_OPS, isa.BPF_JA, isa.BPF_EXIT))
            nxt = end + 1
            if is_term or (nxt < len(insns) and nxt in block_of) or nxt >= len(insns):
                break
            end = nxt
        blk = Block(start=start, end=end + 1)
        op = insns[end].op
        cls = insns[end].cls
        jop = op & OP_MASK
        if cls in (BPF_JMP, BPF_JMP32) and jop == isa.BPF_EXIT:
            blk.term = "exit"
        elif cls in (BPF_JMP, BPF_JMP32) and jop == isa.BPF_JA:
            blk.term = "ja"
            blk.succ = [block_of[succs[end][0]]]
        elif cls in (BPF_JMP, BPF_JMP32) and jop in COND_JMP_OPS:
            blk.term = "cond"
            blk.succ = [block_of[s] for s in succs[end]]
        else:
            blk.term = "fall"
            blk.succ = [block_of[end + 1]]
        blocks.append(blk)

    # ---------------- loop detection (back edges on block graph)
    tier = "dag"
    color = {}

    def dfs(b: int) -> bool:
        color[b] = 1
        for s in blocks[b].succ:
            if color.get(s, 0) == 1:
                return True
            if color.get(s, 0) == 0 and dfs(s):
                return True
        color[b] = 2
        return False

    if dfs(0):
        tier = "loop"

    # ---------------- touched-maps / touched-aux footprint
    from .helpers import AUX_WRITES
    touched_fds: set[int] = set()
    touched_aux: set[str] = set()
    for ann in anns.values():
        if not isinstance(ann, CallAnn):
            continue
        sig = HELPERS[ann.hid]
        for i, kind in enumerate(sig.args):
            if kind == "mapfd":
                touched_fds.add(ann.statics[i])
        touched_aux.update(AUX_WRITES.get(ann.name, ()))

    # ---------------- relocation record (abstract mode)
    record = None
    if abstract:
        live_ctx_refs: dict[int, str] = {}
        for idx, fld in sorted((ctx_refs or {}).items()):
            if idx not in reachable:
                continue  # dead code never executes; leave it un-relocated
            ann = anns.get(idx)
            if not (isinstance(ann, MemAnn) and ann.region == "ctx"):
                raise VerifierError(
                    f"insn {idx}: ctx:{fld} reference is not a direct ctx "
                    f"load — indirect ctx offsets are not relocatable")
            live_ctx_refs[idx] = fld
        from .layout import MapLayout  # late: layout never imports verifier
        from .reloc import RelocRecord
        record = RelocRecord(
            map_layouts=tuple(MapLayout.from_spec(s) for s in map_specs),
            map_lddw=dict(map_local_of),
            ctx_refs=live_ctx_refs,
            ctx_layout=ctx_layout)

    return VerifiedProgram(insns=insns, map_specs=list(map_specs),
                           ctx_words=ctx_words, anns=anns, blocks=blocks,
                           block_of=block_of, tier=tier, max_insns=max_insns,
                           helper_ids_used=helper_ids_used,
                           touched_map_fds=frozenset(touched_fds),
                           touched_aux=frozenset(touched_aux),
                           footprints=compute_footprints(anns, map_specs),
                           reloc=record)


def check_table_encodable(vprog: VerifiedProgram, n_maps: int,
                          max_insns: int, ctx_words: int) -> None:
    """Gate for hot-attaching into a live program table (table_interp.py).

    The table interpreter is compiled ONCE against a fixed universe — the
    padded insn dimension, the event-row width, and the map registry as of
    interpreter compile time. A verified program may still be impossible to
    attach without a retrace; this raises VerifierError for each such case
    so the control plane can reject the request cleanly (generation counter
    untouched)."""
    if len(vprog.insns) > max_insns:
        raise VerifierError(
            f"program has {len(vprog.insns)} insns, live table is padded to "
            f"{max_insns} — recompile the step with a larger table")
    if vprog.ctx_words > ctx_words:
        raise VerifierError(
            f"program reads {vprog.ctx_words} ctx words, live table rows "
            f"carry {ctx_words}")
    for ann in vprog.anns.values():
        if isinstance(ann, CallAnn):
            sig = HELPERS[ann.hid]
            for i, kind in enumerate(sig.args):
                if kind == "mapfd" and ann.statics[i] >= n_maps:
                    raise VerifierError(
                        f"program touches map fd {ann.statics[i]} "
                        f"({vprog.map_specs[ann.statics[i]].name!r}) created "
                        f"after the live table was compiled "
                        f"(knows fds 0..{n_maps - 1})")


# ---------------------------------------------------------------- transfer fn

def _require_init(st: AbsState, r: int, pc: int, what: str) -> Reg:
    reg = st.regs[r]
    if reg.kind == UNINIT:
        raise VerifierError(f"insn {pc}: {what} reads uninitialized r{r}")
    if reg.kind == CONFLICT:
        raise VerifierError(f"insn {pc}: {what} reads r{r} with conflicting "
                            "types across paths")
    return reg


def _check_stack_access(st: AbsState, base: Reg, off: int, size: int,
                        pc: int, write: bool) -> int:
    lo = base.val + off
    if lo < 0 or lo + size > STACK_SIZE:
        raise VerifierError(f"insn {pc}: stack access [{lo},{lo + size}) "
                            "out of bounds")
    if not write:
        missing = [b for b in range(lo, lo + size) if b not in st.stack_init]
        if missing:
            raise VerifierError(f"insn {pc}: read of uninitialized stack "
                                f"byte(s) {missing[:4]}")
    return lo


def _transfer(pc: int, ins: Insn, st: AbsState, map_specs, ctx_bytes: int,
              anns: dict, helper_ids_used: set,
              map_local_of: dict[int, int] | None = None,
              abstract: bool = False) -> AbsState:
    cls = ins.cls

    if ins.is_lddw():
        if map_local_of and pc in map_local_of:
            return st.with_reg(ins.dst, Reg(MAPVAL, map_local_of[pc]))
        return st.with_reg(ins.dst, Reg(CONST, u64(ins.imm64 or 0)))

    if cls in (BPF_ALU64, BPF_ALU):
        if ins.dst == isa.R10:
            raise VerifierError(f"insn {pc}: write to frame pointer r10")
        op = ins.op & OP_MASK
        is64 = cls == BPF_ALU64
        if op == isa.BPF_NEG:
            d = _require_init(st, ins.dst, pc, "neg")
            if d.kind in (PTR_STACK, PTR_CTX, MAPVAL):
                raise VerifierError(f"insn {pc}: arithmetic on pointer")
            if d.kind == CONST:
                return st.with_reg(ins.dst, Reg(CONST, vm._alu(op, d.val, 0, is64)))
            return st.with_reg(ins.dst, Reg(SCALAR))

        if ins.op & SRC_MASK:
            s = _require_init(st, ins.src, pc, "alu")
        else:
            s = Reg(CONST, u64(ins.imm) if is64 else u32(ins.imm))

        if op == isa.BPF_MOV:
            if not is64 and s.kind in (PTR_STACK, PTR_CTX, MAPVAL):
                return st.with_reg(ins.dst, Reg(SCALAR))  # truncation kills ptr
            if not is64 and s.kind == CONST:
                return st.with_reg(ins.dst, Reg(CONST, u32(s.val)))
            return st.with_reg(ins.dst, s)

        d = _require_init(st, ins.dst, pc, "alu")
        if MAPVAL in (d.kind, s.kind):
            raise VerifierError(f"insn {pc}: arithmetic on map reference")
        d_ptr = d.kind in (PTR_STACK, PTR_CTX)
        s_ptr = s.kind in (PTR_STACK, PTR_CTX)
        if d_ptr or s_ptr:
            if not is64:
                raise VerifierError(f"insn {pc}: 32-bit arithmetic on pointer")
            if op not in (isa.BPF_ADD, isa.BPF_SUB):
                raise VerifierError(f"insn {pc}: op {op:#x} on pointer")
            if d_ptr and s_ptr:
                raise VerifierError(f"insn {pc}: pointer +/- pointer")
            if d_ptr:
                if s.kind != CONST:
                    raise VerifierError(f"insn {pc}: variable pointer "
                                        "arithmetic (offset not constant)")
                delta = s64(s.val)
                newoff = d.val + (delta if op == isa.BPF_ADD else -delta)
                return st.with_reg(ins.dst, Reg(d.kind, newoff))
            # scalar + ptr (ADD only)
            if op != isa.BPF_ADD or d.kind != CONST:
                raise VerifierError(f"insn {pc}: unsupported pointer form")
            return st.with_reg(ins.dst, Reg(s.kind, s.val + s64(d.val)))

        if d.kind == CONST and s.kind == CONST:
            dv = d.val if is64 else u32(d.val)
            sv = s.val if is64 else u32(s.val)
            return st.with_reg(ins.dst, Reg(CONST, vm._alu(op, dv, sv, is64)))
        return st.with_reg(ins.dst, Reg(SCALAR))

    if cls == BPF_LDX:
        base = _require_init(st, ins.src, pc, "load")
        size = SIZE_BYTES[ins.op & SIZE_MASK]
        if base.kind == PTR_STACK:
            lo = _check_stack_access(st, base, ins.off, size, pc, write=False)
            anns[pc] = MemAnn("stack", lo, size,
                              aligned=(lo % 8 == 0 and size == 8))
        elif base.kind == PTR_CTX:
            lo = base.val + ins.off
            if lo < 0 or lo + size > ctx_bytes:
                raise VerifierError(f"insn {pc}: ctx read [{lo},{lo + size}) "
                                    f"out of bounds (ctx={ctx_bytes}B)")
            if lo % size:
                raise VerifierError(f"insn {pc}: unaligned ctx read at {lo} "
                                    f"(size {size})")
            anns[pc] = MemAnn("ctx", lo, size,
                              aligned=(lo % 8 == 0 and size == 8))
        else:
            raise VerifierError(f"insn {pc}: load via non-pointer r{ins.src}")
        return st.with_reg(ins.dst, Reg(SCALAR))

    if cls in (BPF_STX, BPF_ST):
        base = _require_init(st, ins.dst, pc, "store")
        size = SIZE_BYTES[ins.op & SIZE_MASK]
        if base.kind == PTR_CTX:
            raise VerifierError(f"insn {pc}: store to read-only ctx")
        if base.kind != PTR_STACK:
            raise VerifierError(f"insn {pc}: store via non-pointer r{ins.dst}")
        v = None
        if cls == BPF_STX:
            v = _require_init(st, ins.src, pc, "store value")
            if v.kind in (PTR_STACK, PTR_CTX, MAPVAL):
                raise VerifierError(f"insn {pc}: spilling pointers to stack "
                                    "is not supported")
        lo = _check_stack_access(st, base, ins.off, size, pc, write=True)
        anns[pc] = MemAnn("stack", lo, size,
                          aligned=(lo % 8 == 0 and size == 8))
        # stack-constant tracking: any overlapping store invalidates; a
        # fresh aligned 8-byte constant store (re)establishes the slot
        sc = frozenset(e for e in st.stack_const
                       if not (lo < e[0] + 8 and e[0] < lo + size))
        if size == 8 and lo % 8 == 0:
            if cls == BPF_ST:
                sc = sc | {(lo, u64(ins.imm))}
            elif v is not None and v.kind == CONST:
                sc = sc | {(lo, u64(v.val))}
        return AbsState(st.regs,
                        st.stack_init | frozenset(range(lo, lo + size)), sc)

    if cls in (BPF_JMP, BPF_JMP32):
        op = ins.op & OP_MASK
        if op == isa.BPF_EXIT:
            r0 = _require_init(st, isa.R0, pc, "exit")
            if r0.kind == MAPVAL:
                raise VerifierError(f"insn {pc}: returning a map reference "
                                    "(its concrete value is layout-dependent)")
            return st
        if op == isa.BPF_JA:
            return st
        if op == isa.BPF_CALL:
            return _transfer_call(pc, ins, st, map_specs, anns,
                                  helper_ids_used, abstract)
        # conditional jump
        d = _require_init(st, ins.dst, pc, "jump")
        if d.kind in (PTR_STACK, PTR_CTX, MAPVAL):
            raise VerifierError(f"insn {pc}: comparison on pointer")
        if ins.op & SRC_MASK:
            s = _require_init(st, ins.src, pc, "jump")
            if s.kind in (PTR_STACK, PTR_CTX, MAPVAL):
                raise VerifierError(f"insn {pc}: comparison on pointer")
        return st

    raise VerifierError(f"insn {pc}: unknown opcode {ins.op:#x}")


def _transfer_call(pc: int, ins: Insn, st: AbsState, map_specs, anns,
                   helper_ids_used, abstract: bool = False) -> AbsState:
    sig = HELPERS.get(ins.imm)
    if sig is None:
        raise VerifierError(f"insn {pc}: unknown helper {ins.imm}")
    helper_ids_used.add(ins.imm)
    statics: list = []
    for i, kind in enumerate(sig.args):
        r = 1 + i
        reg = _require_init(st, r, pc, f"call {sig.name} arg{i + 1}")
        if kind == "mapfd":
            if reg.kind == MAPVAL:
                fd = reg.val
            elif reg.kind == CONST and not abstract:
                fd = s64(reg.val)
            else:
                # abstract mode refuses scalar-forged fds: positional rebinding
                # at relocation time must never silently retarget them
                raise VerifierError(
                    f"insn {pc}: {sig.name} arg{i + 1} map fd must be "
                    + ("a symbolic map reference (lddw rX, map:NAME)"
                       if abstract else "a compile-time constant"))
            if not 0 <= fd < len(map_specs):
                raise VerifierError(f"insn {pc}: map fd {fd} out of range")
            if sig.map_kinds and map_specs[fd].kind not in sig.map_kinds:
                raise VerifierError(
                    f"insn {pc}: {sig.name} on map of kind "
                    f"{map_specs[fd].kind.value} not allowed")
            statics.append(fd)
        elif kind == "kptr":
            if reg.kind != PTR_STACK:
                raise VerifierError(f"insn {pc}: {sig.name} arg{i + 1} must "
                                    "be a stack pointer")
            nbytes = 8
            if sig.name == "ringbuf_output":
                # size checked below once cscalar seen; defer with off only
                pass
            lo = _check_stack_access(st, reg, 0, nbytes, pc, write=False)
            statics.append(lo)
        elif kind == "cscalar":
            if reg.kind != CONST:
                raise VerifierError(f"insn {pc}: {sig.name} arg{i + 1} must "
                                    "be a compile-time constant")
            statics.append(s64(reg.val))
        else:  # scalar
            if reg.kind in (PTR_STACK, PTR_CTX, MAPVAL):
                raise VerifierError(f"insn {pc}: {sig.name} arg{i + 1} must "
                                    "be a scalar, not a pointer")
            statics.append(None)

    if sig.name == "ringbuf_output":
        fd, data_off, size = statics[0], statics[1], statics[2]
        spec = map_specs[fd]
        if size <= 0 or size % 8 or size > 8 * spec.rec_width:
            raise VerifierError(f"insn {pc}: ringbuf_output size {size} "
                                f"invalid for rec_width {spec.rec_width}")
        for b in range(data_off, data_off + size):
            if b not in st.stack_init:
                raise VerifierError(f"insn {pc}: ringbuf_output reads "
                                    f"uninitialized stack byte {b}")

    # statically-known pointee values for kptr args (footprint static keys)
    consts = dict(st.stack_const)
    key_vals: list = [None] * len(sig.args)
    for i, kind in enumerate(sig.args):
        if kind == "kptr" and statics[i] % 8 == 0 and statics[i] in consts:
            key_vals[i] = s64(consts[statics[i]])

    anns[pc] = CallAnn(hid=ins.imm, name=sig.name, statics=statics,
                       key_vals=key_vals)
    rs = list(st.regs)
    rs[0] = Reg(SCALAR)
    for r in range(1, 6):
        rs[r] = Reg(UNINIT)
    return AbsState(tuple(rs), st.stack_init, st.stack_const)
