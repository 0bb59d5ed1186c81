"""Grammar-based program fuzzer + differential lane harness (DESIGN.md §14).

The runtime's safety story rests on two checkers: the verifier (which
programs may run) and the lane gates (which programs may run FAST —
fused, batched, vectorized).  Both are exercised here adversarially:

  1. a seed-deterministic GRAMMAR GENERATOR emits random programs from
     weighted production rules over the full ISA — ALU/branch/stack word
     traffic, bounded loops, helper calls and map ops across all five
     map kinds, ctx loads — constructed so the verifier's path-sensitive
     lattice accepts them (tracked register/stack-init state, structured
     forward branches with init-set intersection at joins);
  2. a REPAIR pass fixes the residual breakage the generator injects on
     purpose (dangling jump targets, reads of uninitialized registers)
     so acceptance stays high even for "raw" material;
  3. every accepted program is DIFFERENTIALLY EXECUTED across every lane
     that will take it — numpy oracle VM, torch JIT scan, sequential table
     interpreter, batched lockstep machine, shadow-vmap vectorized lane —
     on a random event tape, and across N-worker splits of that tape
     through the shm-merge plane (ShmRegion -> Aggregator -> GlobalView)
     when the program's effect footprint is commutative-only;
  4. any divergence is SHRUNK to a minimal reproducer by deterministic
     line deletion to a fixpoint.

Determinism / thread-safety: there is NO module-level RNG state — every
case derives from a private ``random.Random(seed)``, so concurrent
harnesses (the promotion thread, parallel CI shards) can never corrupt
each other's streams, and a seed is a complete reproducer.  The verifier
counter plane has the same property via ``verifier.reset_stats()``.

CLI::

    python -m repro_torch.core.fuzz --seeds 0-99 [--events 6] [--out DIR]
                                    [--device cpu]

Every lane runs on `device` (default cuda: the table and batched lanes
launch the interpreter kernel there; no card raises).

exits 1 on any lane divergence or verifier crash, writing minimized
reproducers (JSON, replayable by tests/test_fuzz_corpus.py) to --out.
"""
from __future__ import annotations

import argparse
import json
import os
import random
import re
import shutil
import sys
import tempfile
from dataclasses import dataclass, field
from functools import partial

import numpy as np
import torch

from . import asm, isa, jit, maps as M, table_interp, vectorized, verifier, vm
from .helpers import HELPERS

CTX_WORDS = 8

# The fixed map universe every fuzz program runs against (numeric fds by
# position).  Fixing it means the table/batched interpreter cores compile
# ONCE for the whole campaign (their trace key is (spec_key, ctx_words)).
FUZZ_SPECS = [
    M.MapSpec("arr", M.MapKind.ARRAY, max_entries=8),
    M.MapSpec("hsh", M.MapKind.HASH, max_entries=8),
    M.MapSpec("pc", M.MapKind.PERCPU_ARRAY, max_entries=8, num_shards=2),
    M.MapSpec("hist", M.MapKind.LOG2HIST),
    M.MapSpec("rb", M.MapKind.RINGBUF, max_entries=4, rec_width=2),
]
_FD = {s.name: i for i, s in enumerate(FUZZ_SPECS)}

_ALU = ("add", "sub", "mul", "div", "or", "and", "lsh", "rsh", "mod",
        "xor", "arsh")
_COND = ("jeq", "jne", "jgt", "jge", "jlt", "jle", "jsgt", "jsge", "jset")
_NARGS = {h.name: len(h.args) for h in HELPERS.values()}


# ==========================================================================
# grammar generator
# ==========================================================================

class _Gen:
    """One program's worth of generator state: the emitted lines plus the
    tracked abstract state (initialized registers, initialized stack dw
    slots) that keeps productions verifier-acceptable by construction."""

    KEY_SLOT, VAL_SLOT, RB_SLOT = -8, -16, -32
    SCRATCH_SLOTS = (-40, -48, -56, -64)

    def __init__(self, rng: random.Random, breakage: float = 0.0):
        self.rng = rng
        self.out: list[str] = []
        self.init: set[int] = set()       # registers holding defined values
        self.stack: set[int] = set()      # dw-aligned initialized byte offs
        self.n_label = 0
        self.breakage = breakage

    def emit(self, s: str) -> None:
        self.out.append(s)

    def label(self) -> str:
        self.n_label += 1
        return f"L{self.n_label}"

    def reg(self) -> int:
        return self.rng.choice(sorted(self.init))

    def imm(self) -> int:
        r = self.rng.random()
        if r < 0.7:
            return self.rng.randrange(-4, 17)
        if r < 0.95:
            return self.rng.randrange(-(1 << 15), 1 << 15)
        return self.rng.randrange(-(1 << 31), 1 << 31)

    # ---------------------------------------------------------- productions
    def p_mov_imm(self) -> None:
        d = self.rng.randrange(10)
        self.emit(f"mov r{d}, {self.imm()}")
        self.init.add(d)

    def p_lddw(self) -> None:
        d = self.rng.randrange(10)
        self.emit(f"lddw r{d}, {self.rng.getrandbits(63)}")
        self.init.add(d)

    def p_alu_imm(self) -> None:
        if not self.init:
            return self.p_mov_imm()
        op = self.rng.choice(_ALU)
        w = "32" if self.rng.random() < 0.25 else ""
        self.emit(f"{op}{w} r{self.reg()}, {self.imm()}")

    def p_alu_reg(self) -> None:
        if not self.init:
            return self.p_mov_imm()
        op = self.rng.choice(_ALU + ("mov",))
        w = "32" if self.rng.random() < 0.25 else ""
        d = self.reg() if op != "mov" else self.rng.randrange(10)
        self.emit(f"{op}{w} r{d}, r{self.reg()}")
        self.init.add(d)

    def p_neg(self) -> None:
        if not self.init:
            return self.p_mov_imm()
        self.emit(f"neg r{self.reg()}")

    def p_stack_store(self) -> None:
        off = self.rng.choice(self.SCRATCH_SLOTS)
        if self.init and self.rng.random() < 0.6:
            self.emit(f"stxdw [r10{off}], r{self.reg()}")
        else:
            self.emit(f"stdw [r10{off}], {self.imm()}")
        self.stack.add(off)

    def p_stack_load(self) -> None:
        if not self.stack:
            return self.p_stack_store()
        off = self.rng.choice(sorted(self.stack))
        sz = self.rng.choice(("b", "h", "w", "dw"))
        d = self.rng.randrange(10)
        self.emit(f"ldx{sz} r{d}, [r10{off}]")
        self.init.add(d)

    def p_branch(self, depth: int) -> None:
        if not self.init:
            return self.p_mov_imm()
        lbl = self.label()
        target = lbl
        if self.rng.random() < self.breakage:
            target = f"missing_{lbl}"     # repaired by repair()
        cond = self.rng.choice(_COND)
        w = "32" if self.rng.random() < 0.2 else ""
        if self.rng.random() < 0.4 and len(self.init) > 1:
            self.emit(f"{cond}{w} r{self.reg()}, r{self.reg()}, {target}")
        else:
            self.emit(f"{cond}{w} r{self.reg()}, {self.imm()}, {target}")
        snap_init, snap_stack = set(self.init), set(self.stack)
        for _ in range(self.rng.randrange(1, 4)):
            self.step(depth + 1)
        self.emit(f"{lbl}:")
        # join: the taken edge carries the snapshot — keep the intersection
        # (calls in the body clobber r1-r5; the snapshot side never saw
        # the body's inits)
        self.init, self.stack = snap_init & self.init, snap_stack

    def p_loop(self) -> None:
        c = self.rng.randrange(2, 10)
        self.emit(f"mov r{c}, {self.rng.randrange(1, 7)}")
        self.init.add(c)
        lbl = self.label()
        self.emit(f"{lbl}:")
        for _ in range(self.rng.randrange(1, 4)):
            if not (self.init - {c}):
                break
            op = self.rng.choice(_ALU)
            d = self.rng.choice(sorted(self.init - {c}))
            self.emit(f"{op} r{d}, {self.imm()}")
        self.emit(f"sub r{c}, 1")
        self.emit(f"jgt r{c}, 0, {lbl}")

    # ------------------------------------------------------------- helpers
    def _post_call(self, r0_live_p: float = 0.3) -> None:
        self.init -= {1, 2, 3, 4, 5}
        self.init.add(0)
        if self.init - {0} and self.rng.random() < r0_live_p:
            self.emit(f"mov r{self.rng.choice(sorted(self.init - {0}))}, r0")

    def _emit_key(self, slot: int, static_p: float = 0.75,
                  lo: int = -2, hi: int = 12) -> None:
        """Store a map key at [r10+slot]: usually a static constant (so
        the footprint lattice sees it), sometimes a masked dynamic value."""
        if not self.init or self.rng.random() < static_p:
            self.emit(f"stdw [r10{slot}], {self.rng.randrange(lo, hi)}")
        else:
            t = self.rng.randrange(2, 10)
            self.emit(f"mov r{t}, r{self.reg()}")
            self.emit(f"and r{t}, 7")
            self.emit(f"stxdw [r10{slot}], r{t}")
            self.init.add(t)
        self.stack.add(slot)

    def _kptr(self, argreg: int, slot: int) -> None:
        self.emit(f"mov r{argreg}, r10")
        self.emit(f"add r{argreg}, {slot}")

    def p_call(self) -> None:
        kind = self.rng.choices(
            ("fetch_add", "percpu", "hist", "lookup", "update", "delete",
             "ringbuf", "pure", "printk", "override"),
            weights=(10, 3, 4, 5, 5, 2, 2, 5, 1, 1))[0]
        if kind == "fetch_add":
            fd = self.rng.choice((_FD["arr"], _FD["hsh"]))
            self._emit_key(self.KEY_SLOT)
            self.emit(f"mov r1, {fd}")
            self._kptr(2, self.KEY_SLOT)
            self.emit(f"mov r3, {self.rng.randrange(-9, 10)}")
            self.emit("call map_fetch_add")
            # a live fetch-add result demotes the vector/batched lanes —
            # keep it rare so those lanes stay well exercised
            self._post_call(r0_live_p=0.15)
        elif kind == "percpu":
            self._emit_key(self.KEY_SLOT)
            self.emit(f"mov r1, {_FD['pc']}")
            self._kptr(2, self.KEY_SLOT)
            self.emit(f"mov r3, {self.rng.randrange(1, 9)}")
            self.emit("call percpu_fetch_add")
            self._post_call(r0_live_p=0.15)
        elif kind == "hist":
            self.emit(f"mov r1, {_FD['hist']}")
            if self.init and self.rng.random() < 0.5:
                self.emit(f"mov r2, r{self.reg()}")
            else:
                self.emit(f"mov r2, {self.rng.randrange(0, 1 << 20)}")
            self.emit("call hist_add")
            self._post_call()
        elif kind == "lookup":
            fd = self.rng.choice((_FD["arr"], _FD["hsh"]))
            self._emit_key(self.KEY_SLOT)
            self.emit(f"mov r1, {fd}")
            self._kptr(2, self.KEY_SLOT)
            self.emit("call map_lookup_elem")
            self._post_call(r0_live_p=0.6)
        elif kind == "update":
            fd = self.rng.choice((_FD["arr"], _FD["hsh"]))
            self._emit_key(self.KEY_SLOT)
            self._emit_key(self.VAL_SLOT, static_p=0.6, lo=-99, hi=100)
            self.emit(f"mov r1, {fd}")
            self._kptr(2, self.KEY_SLOT)
            self._kptr(3, self.VAL_SLOT)
            self.emit("mov r4, 0")
            self.emit("call map_update_elem")
            self._post_call()
        elif kind == "delete":
            self._emit_key(self.KEY_SLOT)
            self.emit(f"mov r1, {_FD['hsh']}")
            self._kptr(2, self.KEY_SLOT)
            self.emit("call map_delete_elem")
            self._post_call()
        elif kind == "ringbuf":
            self.emit(f"stdw [r10{self.RB_SLOT}], {self.imm()}")
            self.emit(f"stdw [r10{self.RB_SLOT + 8}], {self.imm()}")
            self.stack.update((self.RB_SLOT, self.RB_SLOT + 8))
            self.emit(f"mov r1, {_FD['rb']}")
            self._kptr(2, self.RB_SLOT)
            self.emit("mov r3, 16")
            self.emit("mov r4, 0")
            self.emit("call ringbuf_output")
            self._post_call()
        elif kind == "pure":
            h = self.rng.choice(("ktime_get_ns", "get_smp_processor_id",
                                 "get_current_pid_tgid", "get_prandom_u32",
                                 "log2"))
            if h == "log2":
                self.emit(f"mov r1, {self.rng.randrange(0, 1 << 20)}")
            self.emit(f"call {h}")
            self._post_call(r0_live_p=0.6)
        elif kind == "printk":
            self.emit(f"mov r1, {self.imm()}")
            self.emit(f"mov r2, {self.imm()}")
            self.emit("call trace_printk")
            self._post_call()
        else:  # override
            self.emit(f"mov r1, {self.rng.randrange(0, 256)}")
            self.emit("call override_return")
            self._post_call()

    # --------------------------------------------------------------- driver
    def step(self, depth: int = 0) -> None:
        prods = [(self.p_alu_imm, 26), (self.p_alu_reg, 14),
                 (self.p_mov_imm, 10), (self.p_lddw, 3), (self.p_neg, 2),
                 (self.p_stack_store, 8), (self.p_stack_load, 8),
                 (self.p_call, 18)]
        if depth < 2:
            prods.append((lambda: self.p_branch(depth), 9))
        if depth == 0:
            prods.append((self.p_loop, 2))
        fns, ws = zip(*prods)
        self.rng.choices(fns, weights=ws)[0]()

    def generate(self, n_steps: int | None = None) -> str:
        # prologue: bank a few ctx words in callee-ish regs while r1 is
        # still the ctx pointer
        for r in range(6, 6 + self.rng.randrange(1, 5)):
            self.emit(f"ldxdw r{r}, [r1+{8 * self.rng.randrange(CTX_WORDS)}]")
            self.init.add(r)
        for _ in range(n_steps or self.rng.randrange(6, 22)):
            self.step()
        if self.rng.random() < self.breakage:
            self.emit(f"add r{self.rng.randrange(10)}, 1")  # maybe uninit
        if 0 in self.init and self.rng.random() < 0.7:
            pass                           # exit with whatever r0 holds
        else:
            self.emit("mov r0, 0")
        self.emit("exit")
        return "\n".join(self.out)


def generate_text(rng: random.Random, breakage: float = 0.0,
                  n_steps: int | None = None) -> str:
    return _Gen(rng, breakage=breakage).generate(n_steps)


# ==========================================================================
# repair pass
# ==========================================================================

_MEM_RE = re.compile(r"\[r(\d+)[+-]\d+\]")
_REG_RE = re.compile(r"\br(\d+)\b")


def _uses(ln: str) -> tuple[set[int], set[int], bool]:
    """(reads, writes, is_call) for one asm line — enough structure for a
    linear conservative liveness scan (labels read/write nothing)."""
    if ln.endswith(":"):
        return set(), set(), False
    parts = ln.replace(",", " ").split()
    mn = parts[0]
    regs = [int(m) for m in _REG_RE.findall(ln)]
    mem = _MEM_RE.search(ln)
    base = {int(mem.group(1))} if mem else set()
    if mn == "exit":
        return {0}, set(), False
    if mn == "call":
        return set(range(1, 1 + _NARGS.get(parts[1], 5))), {0}, True
    if mn == "ja":
        return set(), set(), False
    if mn.startswith("j"):
        return set(regs), set(), False
    if mn.startswith("ldx"):
        return base, {regs[0]}, False
    if mn.startswith("stx"):
        return base | {regs[-1]}, set(), False
    if mn.startswith("st"):
        return base, set(), False
    if mn == "lddw":
        return set(), {regs[0]}, False
    if mn.startswith("mov"):
        return set(regs[1:]), {regs[0]}, False
    if mn.startswith("neg"):
        return {regs[0]}, {regs[0]}, False
    return set(regs), {regs[0]} if regs else set(), False   # alu


def repair(text: str) -> str:
    """Fix the two classes of breakage raw generation leaves behind so the
    verifier's acceptance rate stays high:

      * branches to undefined labels are redirected to a fresh landing pad
        (``__repair_out: mov r0, 0; exit``) appended after the program;
      * registers read while unwritten (linear conservative scan; calls
        clobber r1–r5, ``exit`` reads r0) get a zeroing ``mov`` inserted
        IMMEDIATELY before the offending line — a prologue zero would not
        survive call clobbers, and zeroing r1 up front would destroy the
        ctx pointer.

    Idempotent on already-well-formed programs."""
    lines = [ln.strip() for ln in text.splitlines() if ln.strip()]
    labels = {ln[:-1] for ln in lines if ln.endswith(":")}
    fixed: list[str] = []
    patched = False
    for ln in lines:
        mn = ln.split()[0]
        if (mn == "ja" or (mn.startswith("j") and mn != "ja")) \
                and not ln.endswith(":"):
            target = ln.replace(",", " ").split()[-1]
            if not _REG_RE.fullmatch(target) and not \
                    re.fullmatch(r"-?\d+", target) and target not in labels:
                ln = ln[: ln.rfind(target)] + "__repair_out"
                patched = True
        fixed.append(ln)
    written = {1, 10}                      # r1 = ctx ptr, r10 = frame ptr
    out: list[str] = []
    for ln in fixed:
        reads, writes, is_call = _uses(ln)
        for r in sorted(reads - written - {10}):
            out.append(f"mov r{r}, 0")
            written.add(r)
        if is_call:
            written -= {1, 2, 3, 4, 5}
        written |= writes
        out.append(ln)
    if not out or out[-1] != "exit":
        out += ["mov r0, 0", "exit"]
    if patched:
        out += ["__repair_out:", "mov r0, 0", "exit"]
    return "\n".join(out)


# ==========================================================================
# case model + differential matrix
# ==========================================================================

@dataclass
class FuzzCase:
    """A complete reproducer: program text + the event tape it ran on."""
    seed: int
    text: str
    tape: list[list[int]]                  # B rows x CTX_WORDS u64 words

    def to_json(self) -> dict:
        return {"seed": self.seed, "text": self.text, "tape": self.tape,
                "ctx_words": CTX_WORDS}

    @classmethod
    def from_json(cls, d: dict) -> "FuzzCase":
        return cls(seed=int(d["seed"]), text=d["text"],
                   tape=[[int(w) for w in row] for row in d["tape"]])


@dataclass
class CaseResult:
    accepted: bool = False
    rejected: str | None = None            # VerifierError text
    crashed: str | None = None             # non-VerifierError from verify
    mismatches: list[str] = field(default_factory=list)
    lanes: list[str] = field(default_factory=list)

    @property
    def diverged(self) -> bool:
        return bool(self.mismatches) or self.crashed is not None


def _gen_tape(rng: random.Random, events: int) -> list[list[int]]:
    rows = []
    for _ in range(events):
        rows.append([rng.getrandbits(63) if rng.random() < 0.1
                     else rng.randrange(0, 200) for _ in range(CTX_WORDS)])
    return rows


def generate_case(seed: int, events: int = 6,
                  breakage: float = 0.15) -> FuzzCase:
    """Seed -> (repaired program, event tape), fully deterministic."""
    rng = random.Random(seed)
    text = repair(generate_text(rng, breakage=breakage))
    return FuzzCase(seed=seed, text=text, tape=_gen_tape(rng, events))


def _aux_kw(i: int) -> dict:
    """Aux constants for event i — CONSTANT across the tape, because the
    batched/vectorized lanes execute a whole batch under one aux block
    (time/cpu/pid are per-batch constants in the runtime), so per-event
    variation would manufacture divergence that is a harness artifact,
    not a lane bug.  cpu=1 on purpose: it catches any lane that silently
    lands per-cpu traffic on shard 0."""
    return dict(time_ns=1000, cpu=1, pid=77)


def _cmp_maps(label: str, got, want_np, out: list[str]) -> None:
    for sp in FUZZ_SPECS:
        for k, arr in want_np[sp.name].items():
            g = got[sp.name][k]
            g = g.cpu().numpy() if isinstance(g, torch.Tensor) else \
                np.asarray(g)
            if not np.array_equal(g, arr):
                out.append(f"{label}: map {sp.name}.{k} "
                           f"{g.tolist()} != {arr.tolist()}")


def run_case(case: FuzzCase, device="cuda") -> CaseResult:
    """The full differential matrix for one case.  Lanes that a gate
    rejects are skipped (that is the gate doing its job); lanes that run
    must be bit-identical to the numpy oracle."""
    from ..device import resolve
    dev = resolve(device)

    res = CaseResult()
    a = asm.assemble(case.text)
    assert not a.map_relocs
    try:
        vprog = verifier.verify(a.insns, FUZZ_SPECS, ctx_words=CTX_WORDS)
    except verifier.VerifierError as e:
        res.rejected = str(e)
        return res
    except Exception as e:                 # verifier CRASH — always a bug
        res.crashed = f"{type(e).__name__}: {e}"
        return res
    res.accepted = True

    jrows = torch.tensor([[isa.s64(isa.u64(w)) for w in row]
                          for row in case.tape], dtype=torch.int64,
                         device=dev)
    mm = res.mismatches

    # ---- oracle: sequential vm over the tape on accumulating numpy maps
    np_maps = M.init_states_np(FUZZ_SPECS)
    oracle: list[vm.Result] = []
    for i, row in enumerate(case.tape):
        oracle.append(vm.run(a.insns, vm.pack_ctx(row), FUZZ_SPECS,
                             np_maps, vm.Aux(**_aux_kw(i))))

    # ---- JIT scan + sequential table lanes, event by event
    res.lanes += ["jit", "table"]
    prog = jit.compile_program(vprog)
    j_maps = M.init_states(FUZZ_SPECS, dev)
    t_maps = M.init_states(FUZZ_SPECS, dev)
    for i, row in enumerate(case.tape):
        ctx = jrows[i]
        r0, j_maps, jaux = prog(ctx.reshape(1, -1), j_maps,
                                jit.make_aux(device=dev, **_aux_kw(i)))
        r0 = r0[0]
        t_r0, t_maps, taux = table_interp.run_program(
            vprog, ctx, t_maps, jit.make_aux(device=dev, **_aux_kw(i)))
        want = oracle[i]
        for label, got_r0, got_aux in (("jit", r0, jaux),
                                       ("table", t_r0, taux)):
            if isa.u64(int(got_r0)) != isa.u64(want.r0):
                mm.append(f"{label}[ev{i}]: r0 {isa.u64(int(got_r0)):#x} != "
                          f"{isa.u64(want.r0):#x}")
            if int(got_aux["override_set"]) != want.aux.override_set or (
                    want.aux.override_set and
                    isa.u64(int(got_aux["override_val"]))
                    != want.aux.override_val):
                mm.append(f"{label}[ev{i}]: override aux mismatch")
    _cmp_maps("jit[final]", j_maps, np_maps, mm)
    _cmp_maps("table[final]", t_maps, np_maps, mm)

    # ---- batched lockstep machine over the whole tape at once
    if table_interp.batched_encodable(vprog):
        res.lanes.append("batched")
        b_maps = M.init_states(FUZZ_SPECS, dev)
        b_r0, b_maps = table_interp.run_program_batched(
            vprog, jrows, b_maps, jit.make_aux(device=dev, **_aux_kw(0)))
        _cmp_maps("batched[final]", b_maps, np_maps, mm)

    # ---- shadow-vmap vectorized lane over the whole tape
    if vectorized.is_vector_safe(vprog):
        res.lanes.append("vectorized")
        v_maps = M.init_states(FUZZ_SPECS, dev)
        valid = torch.ones(len(case.tape), dtype=torch.bool, device=dev)
        v_maps, _ = vectorized.run_vectorized(
            vprog, jrows, valid, v_maps,
            jit.make_aux(device=dev, **_aux_kw(0)))
        _cmp_maps("vectorized[final]", v_maps, np_maps, mm)

    # ---- N-worker splits through the shm merge plane
    if _merge_eligible(vprog):
        for n in (1, 2, 3):
            res.lanes.append(f"merge{n}")
            mm.extend(_check_merge_split(case, a.insns, np_maps, n))
    return res


def _merge_eligible(vprog) -> bool:
    """The merge plane's contract (DESIGN.md §10): cross-worker ops on
    shared state must be commutative AND unobserved.  The footprint
    lattice states the first half per program (every touched map
    commutative-only); the second half is fetch-add RESULT deadness —
    a live r0 reads the accumulated value, which depends on how the tape
    was split (found by the fuzz harness: a live fetch_add result fed
    into hist_add diverged under 2/3-way splits, pinned in
    tests/corpus/live_fetch_add_split.json)."""
    from .vectorized import _r0_dead_after
    from .verifier import CallAnn
    fps = [vprog.footprints.get(fd) for fd in vprog.touched_map_fds]
    if not fps or not all(fp is not None and fp.commutative_only
                          for fp in fps):
        return False
    for pc, ann in vprog.anns.items():
        if isinstance(ann, CallAnn) and \
                ann.name in ("map_fetch_add", "percpu_fetch_add") and \
                not _r0_dead_after(vprog, pc):
            return False
    return True


def _check_merge_split(case: FuzzCase, insns, oracle_maps,
                       n_workers: int) -> list[str]:
    """Split the tape round-robin across N workers, each applying its
    share to its OWN map state through the vm, publish through the shm
    plane, aggregate, and compare the global view to the sequential
    oracle (hash compared canonicalized, as the plane publishes it)."""
    from . import daemon as D, shm as SH
    root = tempfile.mkdtemp(prefix="fuzzmerge_")
    out: list[str] = []
    try:
        regions = {w: SH.ShmRegion.create(root, FUZZ_SPECS,
                                          worker_id=f"w{w}")
                   for w in range(n_workers)}
        states = {w: M.init_states_np(FUZZ_SPECS)
                  for w in range(n_workers)}
        for i, row in enumerate(case.tape):
            w = i % n_workers
            vm.run(insns, vm.pack_ctx(row), FUZZ_SPECS, states[w],
                   vm.Aux(**_aux_kw(i)))
        agg = D.Aggregator(root)
        for w in range(n_workers):
            regions[w].publish_device(states[w])
        agg.poll_once()
        g = SH.GlobalView.attach(root)
        for sp in FUZZ_SPECS:
            got = g.snapshot(sp.name)
            if sp.kind == M.MapKind.HASH:
                want = M.n_hash_canonical(
                    sp, M.n_hash_items(oracle_maps[sp.name]))
            else:
                want = oracle_maps[sp.name]
            for fld in got:
                if not np.array_equal(got[fld], np.asarray(want[fld])):
                    out.append(f"merge{n_workers}: {sp.name}.{fld} "
                               f"{got[fld].tolist()} != "
                               f"{np.asarray(want[fld]).tolist()}")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    return out


# ==========================================================================
# shrinker
# ==========================================================================

def _still_fails(text: str, case: FuzzCase, device="cuda") -> bool:
    cand = FuzzCase(seed=case.seed, text=text, tape=case.tape)
    try:
        r = run_case(cand, device)
    except Exception:
        return False                       # breakage, not the divergence
    return r.accepted and r.diverged


def shrink_case(case: FuzzCase, still_fails=None) -> FuzzCase:
    """Deterministic line-deletion to a fixpoint: drop every line (largest
    chunks first) whose removal keeps the program verifier-accepted AND
    still diverging.  O(lines^2) worst case on programs of ~dozens of
    lines — fine for a reproducer pass.  ``still_fails(text, case)`` is
    injectable so the shrink loop itself is unit-testable without a real
    lane divergence."""
    if still_fails is None:
        still_fails = _still_fails
    lines = case.text.splitlines()
    chunk = max(1, len(lines) // 2)
    while chunk >= 1:
        i = 0
        while i < len(lines):
            cand = lines[:i] + lines[i + chunk:]
            if cand and still_fails("\n".join(cand), case):
                lines = cand
            else:
                i += chunk
        chunk //= 2
    return FuzzCase(seed=case.seed, text="\n".join(lines), tape=case.tape)


# ==========================================================================
# campaign driver
# ==========================================================================

def fuzz(seeds, events: int = 6, out_dir: str | None = None,
         shrink: bool = True, breakage: float = 0.15,
         device="cuda") -> dict:
    """Run the matrix over a seed list.  Returns a summary dict; writes
    minimized reproducers to ``out_dir`` (one JSON per divergent seed)."""
    total = accepted = 0
    failures: list[dict] = []
    for seed in seeds:
        case = generate_case(seed, events=events, breakage=breakage)
        r = run_case(case, device)
        total += 1
        accepted += r.accepted
        if r.diverged:
            mini = (shrink_case(case, partial(_still_fails, device=device))
                    if shrink and not r.crashed else case)
            rec = {**mini.to_json(),
                   "crashed": r.crashed, "mismatches": r.mismatches,
                   "lanes": r.lanes, "original_text": case.text}
            failures.append(rec)
            if out_dir:
                os.makedirs(out_dir, exist_ok=True)
                with open(os.path.join(out_dir, f"repro_{seed}.json"),
                          "w") as fh:
                    json.dump(rec, fh, indent=1)
    return {"seeds": total, "accepted": accepted,
            "acceptance_rate": accepted / max(total, 1),
            "divergences": len(failures), "failures": failures}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.core.fuzz",
        description="differential fuzz harness over all execution lanes")
    ap.add_argument("--seeds", default="0-49",
                    help="'A-B' inclusive range or comma list (default 0-49)")
    ap.add_argument("--events", type=int, default=6)
    ap.add_argument("--out", default=None,
                    help="directory for minimized reproducer JSONs")
    ap.add_argument("--no-shrink", action="store_true")
    ap.add_argument("--json", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="device of every lane (default cuda)")
    args = ap.parse_args(argv)
    if "-" in args.seeds and not args.seeds.startswith("-"):
        lo, hi = args.seeds.split("-")
        seeds = range(int(lo), int(hi) + 1)
    else:
        seeds = [int(s) for s in args.seeds.split(",")]
    summary = fuzz(seeds, events=args.events, out_dir=args.out,
                   shrink=not args.no_shrink, device=args.device)
    if args.json:
        print(json.dumps(summary, indent=1))
    else:
        print(f"fuzz: {summary['seeds']} seeds, "
              f"{summary['accepted']} accepted "
              f"({summary['acceptance_rate']:.0%}), "
              f"{summary['divergences']} divergence(s)")
        for f_ in summary["failures"]:
            print(f"  seed {f_['seed']}: "
                  + (f_["crashed"] or "; ".join(f_["mismatches"][:3])))
            if args.out:
                print(f"    reproducer: {args.out}/repro_{f_['seed']}.json")
    return 1 if summary["divergences"] else 0


if __name__ == "__main__":                 # pragma: no cover
    sys.exit(main())
