"""Vectorized + fused probe execution.

The paper JITs each probe invocation to straight-line native code; on a
vector machine the equivalent is executing probe programs over a whole
event batch as tensor ops. For DAG programs whose map side effects are
commutative (fetch-add family), the sequential pass over events
(jit.run_over_events) collapses to:

  1. a SHADOW pass: the T1 if-converted dataflow runs once over all event
     rows (registers i64[B]) with side-effect helpers replaced by recorders
     -> per-call-site batched (pred, args) tensors. Event validity is
     folded into the entry-block predicate, so recorded preds carry it;
  2. an APPLY pass: one scatter-add / histogram-add / batched hash
     fetch-add / batched ringbuf op per call site over the whole batch.
     The HASH and RINGBUF applies call the Hopper kernels through
     `kernels.ops` (their plain versions on the CPU).

`run_fused_vector` goes one step further (the fused pipeline): ALL
vector-safe programs across ALL (site, kind) attachments share ONE shadow
pass over the tape -- each program's validity mask is its entry predicate
-- and side effects apply once per call site.

Semantic deltas vs scan mode (checked by is_vector_safe / documented):
  * fetch-add return values must be dead (we verify this statically);
  * HASH fetch_add is batched (end states bit-identical to the sequential
    twin);
  * ringbuf rows keep batch order; override takes the first valid lane;
  * trace_printk is counted, not stored.
End map states are bit-identical to scan mode for safe programs.
"""
from __future__ import annotations

import torch

from . import isa, jit as J, maps as M
from .isa import BPF_JMP, BPF_JMP32, OP_MASK
from .verifier import CallAnn, VerifiedProgram
from ..kernels import ops

I64 = torch.int64

_PURE = {"ktime_get_ns", "get_smp_processor_id", "get_current_pid_tgid",
         "log2"}
_EFFECT = {"map_fetch_add", "percpu_fetch_add", "hist_add", "ringbuf_output",
           "override_return", "trace_printk"}


def _r0_dead_after(vprog: VerifiedProgram, call_pc: int) -> bool:
    """Conservative: r0 (the fetch-add result) must be overwritten before any
    read, scanning forward in instruction order (over-approximates across
    branches; good enough for probe programs)."""
    for pc in range(call_pc + 1, len(vprog.insns)):
        ins = vprog.insns[pc]
        cls = ins.cls
        if cls in (isa.BPF_ALU, isa.BPF_ALU64):
            op = ins.op & OP_MASK
            reads_dst = op != isa.BPF_MOV
            if ins.dst == 0 and not reads_dst:
                return True                      # overwritten
            if (ins.dst == 0 and reads_dst) or \
               (ins.op & isa.SRC_MASK and ins.src == 0):
                return False
        elif cls == isa.BPF_LDX:
            if ins.src == 0:
                return False
            if ins.dst == 0:
                return True
        elif cls in (isa.BPF_STX,):
            if ins.src == 0 or ins.dst == 0:
                return False
        elif cls in (BPF_JMP, BPF_JMP32):
            op = ins.op & OP_MASK
            if op == isa.BPF_CALL:
                return True                      # call clobbers r0
            if op == isa.BPF_EXIT:
                return False                     # r0 is the return value
            if ins.dst == 0 or (ins.op & isa.SRC_MASK and ins.src == 0):
                return False
        elif ins.is_lddw() and ins.dst == 0:
            return True
    return True


def is_vector_safe(vprog: VerifiedProgram) -> bool:
    """True iff the program can run on the batched (shadow+apply) path:
    an acyclic CFG, only pure or commutative-effect helpers, dead fetch-add
    results, and at most ONE ringbuf_output site per ring -- effects apply
    per call SITE, so a second site emitting to the same ring would land
    its whole batch after the first site's instead of interleaving per
    event."""
    if vprog.tier != "dag":
        return False
    rb_fds: set[int] = set()
    for pc, ann in vprog.anns.items():
        if not isinstance(ann, CallAnn):
            continue
        if ann.name in _PURE:
            continue
        if ann.name not in _EFFECT:
            return False
        if ann.name in ("map_fetch_add", "percpu_fetch_add"):
            if not _r0_dead_after(vprog, pc):
                return False
        if ann.name == "ringbuf_output":
            fd = ann.statics[0]
            if fd in rb_fds:
                return False
            rb_fds.add(fd)
    return True


# --------------------------------------------------------------------------
# shadow pass: record (pred, args) per call site instead of executing
# --------------------------------------------------------------------------

def _make_shadow_cb(recs: list):
    """Helper callback for the shadow pass. Effectful helpers append one
    (program, helper name, statics, (pred, *dynamic args)) record; the T1
    pass runs once over the whole batch, so each call site records once."""

    def shadow_cb(vp, ann, m, ms, aux_l, pred):
        zero = torch.zeros_like(m.regs[0])
        name = ann.name
        if name == "ktime_get_ns":
            return aux_l["time_ns"].expand_as(zero), ms, aux_l
        if name == "get_smp_processor_id":
            return aux_l["cpu"].expand_as(zero), ms, aux_l
        if name == "get_current_pid_tgid":
            return aux_l["pid"].expand_as(zero), ms, aux_l
        if name == "log2":
            return M.log2_bin(m.regs[1]), ms, aux_l
        if name in ("map_fetch_add", "percpu_fetch_add"):
            rec = (pred, J._stack_load(m.stack, ann.statics[1], 8), m.regs[3])
        elif name == "hist_add":
            rec = (pred, m.regs[2])
        elif name == "ringbuf_output":
            fd, doff, size, _ = ann.statics
            w = vp.map_specs[fd].rec_width
            lanes = [J._stack_load(m.stack, doff + 8 * i, 8)
                     for i in range(size // 8)]
            lanes += [zero] * (w - len(lanes))
            rec = (pred, torch.stack(lanes, dim=1))
        elif name == "override_return":
            rec = (pred, m.regs[1])
        elif name == "trace_printk":
            rec = (pred,)
        else:  # pragma: no cover - guarded by is_vector_safe
            raise AssertionError(name)
        recs.append((vp, name, ann.statics, rec))
        return zero, ms, aux_l

    return shadow_cb


# --------------------------------------------------------------------------
# apply pass: one batched op per call site
# --------------------------------------------------------------------------

def _apply_site(vp, name, statics, rec, maps_state, aux):
    """Apply one call site's batched side effect. rec[0] is the per-lane
    predicate with event validity already folded in (entry_pred)."""
    ok = rec[0]
    if name == "map_fetch_add":
        sp = vp.map_specs[statics[0]]
        st = maps_state[sp.name]
        keys, delta = rec[1], rec[2]
        if sp.kind == M.MapKind.HASH:
            new = M.t_hash_fetch_add_batch(st, keys, delta, ok)
            maps_state = {**maps_state, sp.name: new}
        else:
            n = sp.max_entries
            inb = ok & (keys >= 0) & (keys < n)
            vals = st["values"].index_add(
                0, keys.clamp(0, n - 1),
                torch.where(inb, delta, torch.zeros_like(delta)))
            maps_state = {**maps_state, sp.name: {"values": vals}}
    elif name == "percpu_fetch_add":
        sp = vp.map_specs[statics[0]]
        st = maps_state[sp.name]
        keys, delta = rec[1], rec[2]
        n = sp.max_entries
        inb = ok & (keys >= 0) & (keys < n)
        sh = aux["cpu"].clamp(0, sp.num_shards - 1)
        flat = st["values"].reshape(-1).index_add(
            0, sh * n + keys.clamp(0, n - 1),
            torch.where(inb, delta, torch.zeros_like(delta)))
        maps_state = {**maps_state,
                      sp.name: {"values": flat.reshape(st["values"].shape)}}
    elif name == "hist_add":
        sp = vp.map_specs[statics[0]]
        st = maps_state[sp.name]
        # bin = min(63, bit_length(v)) for v > 0: binary search over the
        # sorted powers of two (exact)
        bins = st["bins"].index_add(0, M.log2_bin(rec[1]), ok.to(I64))
        maps_state = {**maps_state, sp.name: {"bins": bins}}
    elif name == "ringbuf_output":
        sp = vp.map_specs[statics[0]]
        st = maps_state[sp.name]
        # one launch: the rows, the head and the dropped (lap) count
        d, h, dr = ops.ringbuf_emit_batch(st["data"], st["head"],
                                          st["dropped"], rec[1], ok)
        maps_state = {**maps_state,
                      sp.name: {"data": d, "head": h, "dropped": dr}}
    elif name == "override_return":
        any_ok = ok.any()
        first = torch.argmax(ok.to(torch.int32))
        aux = {**aux,
               "override_set": torch.where(
                   any_ok, torch.ones_like(aux["override_set"]),
                   aux["override_set"]),
               "override_val": torch.where(any_ok, rec[1][first],
                                           aux["override_val"])}
    elif name == "trace_printk":
        aux = {**aux, "printk_n": aux["printk_n"] + ok.to(I64).sum()}
    return maps_state, aux


# --------------------------------------------------------------------------
# drivers
# --------------------------------------------------------------------------

def run_vectorized(vprog: VerifiedProgram, event_rows, valid, maps_state,
                   aux):
    """Single-program batched execution ('vectorized' mode).
    event_rows: i64[B, 16]; valid: bool[B] folded into the entry pred."""
    recs: list[tuple] = []
    t1 = J.compile_t1(vprog, helper_cb=_make_shadow_cb(recs))
    t1(event_rows, {}, aux, entry_pred=valid)
    for vp, name, statics, rec in recs:
        maps_state, aux = _apply_site(vp, name, statics, rec, maps_state,
                                      aux)
    return maps_state, aux


def run_fused_vector(entries, event_rows, maps_state, aux):
    """The fused pipeline's vector lane: ONE shadow pass over the event
    tape executing every vector-safe program of every attachment, then one
    batched apply per call site.

    entries: [(site_id, kind, vprog)] in attachment order -- apply order
    matches the scan mode's sorted-attachment iteration, so per-map streams
    (ringbuf record order, override first-lane) are preserved."""
    recs: list[tuple] = []
    cb = _make_shadow_cb(recs)
    for sid, kind, vp in entries:
        pred = (event_rows[:, 0] == sid) & (event_rows[:, 1] == kind)
        J.compile_t1(vp, helper_cb=cb)(event_rows, {}, aux, entry_pred=pred)
    for vp, name, statics, rec in recs:
        maps_state, aux = _apply_site(vp, name, statics, rec, maps_state,
                                      aux)
    return maps_state, aux
