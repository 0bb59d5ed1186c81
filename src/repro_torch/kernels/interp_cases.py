"""The cases the interpreter kernel is held to its plain version on.

`tests/test_torch_cuda.py` builds these and runs each through
`ops.table_interp_run` twice: on CUDA tensors (the kernel) and on CPU
copies (the plain version), then compares map states, aux and r0 bit for
bit. Every case is made from a seed with numpy.

  * `mixed_case`: a live table of eight slots on one runtime -- vec slots
    (ARRAY, HASH and LOG2HIST counters, a HASH map that fills, a loop)
    and sequential slots (a RINGBUF record; a program that walks lookup,
    update and delete on a small HASH map until it is full, a per-cpu
    fetch-add, prandom, printk, override, ktime, pid, cpu, log2; a loop
    forced onto the sequential sub-lane), the loops' fuel cut so some
    events exhaust it;
  * `branch_case`: a HASH fetch-add behind a data-dependent loop forced
    onto the vec sub-lane (lanes reach HASH at different machine steps),
    beside a sequential program and a vec ARRAY counter; with `big`, the
    counter's map takes the universe past the kernel's shared memory (the
    global route);
  * `corpus_case`: one fuzz-corpus program in a one-slot table on the
    sequential or the vec sub-lane, every event taken (match_all), over a
    tape that repeats the corpus rows and adds random ones.
"""
from __future__ import annotations

import numpy as np
import torch

_COUNT = """
    ldxdw r6, [r1+ctx:layer]
    stxdw [r10-8], r6
    lddw r1, map:{map}
    mov r2, r10
    add r2, -8
    mov r3, 1
    call map_fetch_add
    mov r0, 0
    exit
"""
_HIST = """
    ldxdw r2, [r1+ctx:rms]
    lddw r1, map:ic_hist
    call hist_add
    mov r0, 0
    exit
"""
_RB = """
    ldxdw r6, [r1+ctx:step]
    stxdw [r10-32], r6
    ldxdw r6, [r1+ctx:numel]
    stxdw [r10-24], r6
    ldxdw r6, [r1+ctx:rms]
    stxdw [r10-16], r6
    ldxdw r6, [r1+ctx:absmax]
    stxdw [r10-8], r6
    lddw r1, map:ic_rb
    mov r2, r10
    add r2, -32
    mov r3, 32
    mov r4, 0
    call ringbuf_output
    mov r0, 0
    exit
"""
_LOOP = """
    ldxdw r6, [r1+ctx:layer]
    mov r7, 0
    loop:
    add r7, 1
    sub r6, 1
    jsgt r6, 0, loop
    stxdw [r10-8], r7
    lddw r1, map:{map}
    mov r2, r10
    add r2, -8
    mov r3, r7
    call map_fetch_add
    mov r0, 0
    exit
"""
# every other helper, on the sequential sub-lane: update / lookup / delete
# on a HASH map of 8 slots (full after 8 keys: update answers -7), a live
# per-cpu fetch-add, prandom, printk, ktime, pid, cpu, log2, override
_MISC = """
    ldxdw r6, [r1+ctx:layer]
    ldxdw r7, [r1+ctx:rms]
    stxdw [r10-8], r6
    stxdw [r10-16], r7
    lddw r1, map:ic_small
    mov r2, r10
    add r2, -8
    mov r3, r10
    add r3, -16
    mov r4, 0
    call map_update_elem
    mov r8, r0
    lddw r1, map:ic_small
    mov r2, r10
    add r2, -8
    call map_lookup_elem
    mov r9, r0
    mov r1, r6
    and r1, 3
    jne r1, 0, keep
    lddw r1, map:ic_small
    mov r2, r10
    add r2, -8
    call map_delete_elem
    add r8, r0
    keep:
    mov r1, r6
    and r1, 7
    stxdw [r10-24], r1
    lddw r1, map:ic_pcpu
    mov r2, r10
    add r2, -24
    mov r3, r9
    call percpu_fetch_add
    add r9, r0
    call get_prandom_u32
    mov r1, r0
    mov r2, r9
    call trace_printk
    call ktime_get_ns
    mov r7, r0
    call get_current_pid_tgid
    add r7, r0
    call get_smp_processor_id
    add r7, r0
    mov r1, r7
    call log2
    add r8, r0
    mov r1, r8
    call override_return
    mov r0, r8
    exit
"""

# (name, text, (map name, kind, max_entries, rec_width, num_shards),
#  target, vec forced (None: the table's own flag), fuel cut (None: keep))
MIXED = [
    ("ic_count", _COUNT.format(map="ic_arr"), ("ic_arr", "array", 64, 4, 1),
     "uprobe:ic_block", None, None),
    ("ic_hashc", _COUNT.format(map="ic_hash"),
     ("ic_hash", "hash", 256, 4, 1), "uprobe:ic_block", None, None),
    ("ic_histp", _HIST, ("ic_hist", "log2hist", 64, 4, 1),
     "uretprobe:ic_block", None, None),
    ("ic_rbp", _RB, ("ic_rb", "ringbuf", 64, 4, 1), "probe:ic_logits", None,
     None),
    ("ic_misc", _MISC, None, "uprobe:ic_block", None, None),
    ("ic_full", _COUNT.format(map="ic_full"), ("ic_full", "hash", 8, 4, 1),
     "uretprobe:ic_block", None, None),
    ("ic_loopv", _LOOP.format(map="ic_loopv"),
     ("ic_loopv", "array", 64, 4, 1), "uprobe:ic_block", None, 60),
    ("ic_loops", _LOOP.format(map="ic_loops"),
     ("ic_loops", "array", 64, 4, 1), "uretprobe:ic_block", 0, 60),
]
MISC_MAPS = [("ic_small", "hash", 8, 4, 1), ("ic_pcpu", "percpu_array", 8,
                                             4, 2)]
# a HASH fetch-add behind a loop whose trip count is the layer's low bits,
# then a second one on odd layers only: forced onto the vec sub-lane, the
# lanes reach their HASH calls at different machine steps, and the 16-slot
# map fills, so the insert order is visible in its layout
_BRANCH_HASH = """
    ldxdw r6, [r1+ctx:layer]
    ldxdw r8, [r1+ctx:step]
    mov r7, r6
    and r7, 7
    loop:
    sub r7, 1
    jsgt r7, 0, loop
    stxdw [r10-8], r6
    lddw r1, map:ic_bh
    mov r2, r10
    add r2, -8
    mov r3, 1
    call map_fetch_add
    jset r6, 1, skip
    add r8, 1000
    stxdw [r10-8], r8
    lddw r1, map:ic_bh
    mov r2, r10
    add r2, -8
    mov r3, r6
    call map_fetch_add
    skip:
    mov r0, 0
    exit
"""
# the branching HASH program forced onto the vec sub-lane, beside a
# sequential program and a vec ARRAY counter (MIXED's format)
BRANCH = [
    ("ic_misc", _MISC, None, "uprobe:ic_block", None, None),
    ("ic_bcount", _COUNT.format(map="ic_barr"),
     ("ic_barr", "array", 64, 4, 1), "uretprobe:ic_block", None, None),
    ("ic_bhash", _BRANCH_HASH, ("ic_bh", "hash", 16, 4, 1),
     "uprobe:ic_block", 1, None),
]
# entries of BRANCH's ARRAY map that put its universe (256 KiB) past the
# interpreter kernel's shared memory: the global route
BIG_ENTRIES = 32768
AUX = dict(time_ns=123456789, cpu=1, pid=4242, rand=0x12345678)


def _spec(t):
    from ..core.maps import MapKind, MapSpec
    name, kind, n, width, shards = t
    return MapSpec(name, MapKind(kind), n, rec_width=width,
                   num_shards=shards)


def _runtime(programs, max_programs: int):
    """A runtime with `programs` (MIXED's format) on its live table; returns
    (runtime, links). A forced vec flag or fuel is written after the slot's
    attach, so a forced program comes last (a later attach recomputes the
    flags)."""
    from ..core.runtime import BpftimeRuntime
    rt = BpftimeRuntime()
    for _, _, spec, *_ in programs:
        if spec is not None:
            rt.create_map(_spec(spec))
    for spec in MISC_MAPS:
        rt.create_map(_spec(spec))
    rt.enable_live_attach(max_programs=max_programs, max_insns=64,
                          arm=("uprobe:ic_block", "uretprobe:ic_block",
                               "probe:ic_logits"))
    links = []
    for name, text, spec, target, vec, fuel in programs:
        maps = MISC_MAPS if spec is None else [spec]
        pid = rt.load_asm(name, text, [_spec(m) for m in maps], "uprobe")
        lk = rt.attach(pid, target, mode="table", promote=False)
        if vec is not None:
            rt.live.host["vec"][lk.slot] = vec
        if fuel is not None:
            rt.live.host["fuel"][lk.slot] = fuel
        links.append(lk)
    return rt, links


def mixed_runtime():
    """A runtime with the MIXED programs on its live table (eight slots);
    returns (runtime, links)."""
    return _runtime(MIXED, 8)


def branch_programs(big: bool = False):
    """BRANCH, with the vec counter's ARRAY map at BIG_ENTRIES when `big`."""
    if not big:
        return BRANCH
    return [(n, t, (s[0], s[1], BIG_ENTRIES, *s[3:])
             if s is not None and s[0] == "ic_barr" else s, tg, v, f)
            for n, t, s, tg, v, f in BRANCH]


def branch_runtime(big: bool = False):
    """A runtime with the BRANCH programs on a live table of four slots."""
    return _runtime(branch_programs(big), 4)


def mixed_tape(n: int, seed: int):
    """i64[n, 16] event rows on the MIXED programs' sites, numpy."""
    from ..core import events as E
    rng = np.random.default_rng(seed)
    rows = np.zeros((n, E.EVENT_WIDTH), np.int64)
    block = E.SITES.get_or_create("ic_block")
    logits = E.SITES.get_or_create("ic_logits")
    pick = rng.integers(0, 3, n)
    rows[:, 0] = np.where(pick == 2, logits, block)
    rows[:, 1] = np.choose(pick, [E.KIND_ENTRY, E.KIND_EXIT,
                                  E.KIND_TRACEPOINT])
    rows[:, 2] = rng.integers(0, 40, n)                     # layer
    rows[:, 3] = np.arange(n) // 7                          # step
    rows[:, 4] = rng.integers(1, 1 << 20, n)                # numel
    rows[:, 5:10] = rng.integers(-(1 << 40), 1 << 40, (n, 5))
    rows[:, 6] = rng.integers(0, 1 << 40, n)                # rms >= 0
    return rows


def _case(rt, n: int, seed: int, device):
    from ..core import jit as J
    st = rt.init_device_maps(device)
    table = st.pop("__live_table__")
    rows = torch.as_tensor(mixed_tape(n, seed), device=device)
    return rt.live.spec_key, table, rows, st, J.make_aux(device=device,
                                                         **AUX)


def mixed_case(n: int, seed: int, device):
    """(spec_key, table, rows, maps, aux) of the MIXED table over an
    n-event tape, on `device`."""
    return _case(mixed_runtime()[0], n, seed, device)


def branch_case(n: int, seed: int, device, big: bool = False):
    """(spec_key, table, rows, maps, aux) of the BRANCH table over an
    n-event tape (`mixed_tape`), on `device`; `big` puts the universe past
    the kernel's shared-memory budget (its global route)."""
    return _case(branch_runtime(big)[0], n, seed, device)


# The ISA's traps in one sequential program, every result recorded in a
# RINGBUF of 8-lane records: unsigned DIV / MOD (64 and 32 bit, by zero
# too), RSH / LSH / ARSH with shift masking, NEG32 and ALU32 zero-extension,
# unaligned sub-word stack stores and loads, the jmp32 and unsigned
# compares, and a record shorter than the lane width (zero padding).
TRAPS = """
    ldxdw r6, [r1+16]
    ldxdw r7, [r1+24]
    ldxdw r8, [r1+32]
    mov r9, r6
    div r9, r7
    stxdw [r10-64], r9
    mov r9, r6
    mod r9, r7
    stxdw [r10-56], r9
    mov r9, r6
    div32 r9, r7
    stxdw [r10-48], r9
    mov r9, r6
    mod32 r9, r8
    stxdw [r10-40], r9
    mov r9, r6
    rsh r9, r8
    stxdw [r10-32], r9
    mov r9, r6
    arsh32 r9, r8
    stxdw [r10-24], r9
    mov r9, r7
    lsh32 r9, r8
    stxdw [r10-16], r9
    mov r9, r6
    neg32 r9
    add r9, r8
    arsh r9, r7
    stxdw [r10-8], r9
    lddw r1, map:ic_trap_rb
    mov r2, r10
    add r2, -64
    mov r3, 64
    mov r4, 0
    call ringbuf_output
    stxw [r10-61], r7
    stxh [r10-55], r8
    stxb [r10-50], r6
    stxw [r10-47], r6
    ldxdw r9, [r10-64]
    ldxw r0, [r10-59]
    add r9, r0
    ldxh r0, [r10-53]
    add r9, r0
    ldxb r0, [r10-49]
    xor r9, r0
    stxdw [r10-64], r9
    mov r9, 0
    jlt32 r6, r7, a1
    or r9, 1
    a1:
    jsgt32 r6, r8, a2
    or r9, 2
    a2:
    jge r6, r7, a3
    or r9, 4
    a3:
    jsle r7, r8, a4
    or r9, 8
    a4:
    jset32 r6, r8, a5
    or r9, 16
    a5:
    jgt r8, -1, a6
    or r9, 32
    a6:
    jne32 r6, -7, a7
    or r9, 64
    a7:
    stxdw [r10-56], r9
    lddw r1, map:ic_trap_rb
    mov r2, r10
    add r2, -64
    mov r3, 24
    mov r4, 0
    call ringbuf_output
    mov r0, r9
    exit
"""
TRAPS_MAP = ("ic_trap_rb", "ringbuf", 16, 8, 1)


def traps_tape(n: int, seed: int):
    """i64[n, 16] rows whose words 2-4 (the TRAPS operands) mix zero, small
    values, values near 2^32 and full 64-bit ones."""
    rng = np.random.default_rng(seed)
    pool = np.array([0, 1, 2, 7, 31, 32, 63, 64, 65, (1 << 31) - 1, 1 << 31,
                     (1 << 32) - 1, 1 << 32, -1, -2, -7, -(1 << 31),
                     (1 << 63) - 1, -(1 << 63)], np.int64)
    rows = rng.integers(-(1 << 62), 1 << 62, (n, 16))
    pick = rng.random((n, 16)) < 0.5
    rows[pick] = pool[rng.integers(0, pool.size, int(pick.sum()))]
    return rows


def traps_program():
    """(runtime, verified TRAPS) with its ringbuf map created."""
    from ..core.runtime import BpftimeRuntime
    rt = BpftimeRuntime()
    pid = rt.load_asm("ic_traps", TRAPS, [_spec(TRAPS_MAP)], "uprobe")
    return rt, rt.progs[pid].vprog


def traps_case(n: int, seed: int, device):
    """(spec_key, table, rows, maps, aux) of TRAPS in a one-slot table on
    the sequential sub-lane, every event taken (match_all)."""
    from ..core import jit as J
    from ..core.table_interp import LiveTable
    rt, vprog = traps_program()
    lt = LiveTable(rt.map_specs, ctx_words=16, max_programs=1,
                   max_insns=128)
    lt.encode_slot(0, vprog, site_id=0, kind=0)
    return (lt.spec_key, lt.device_state(device),
            torch.as_tensor(traps_tape(n, seed), device=device),
            rt.init_device_maps(device), J.make_aux(device=device, **AUX))


# the fuzz harness's fixed map universe (the JAX package's fuzz.FUZZ_SPECS)
FUZZ_SPECS = [("arr", "array", 8, 4, 1), ("hsh", "hash", 8, 4, 1),
              ("pc", "percpu_array", 8, 4, 2), ("hist", "log2hist", 64, 4, 1),
              ("rb", "ringbuf", 4, 2, 1)]
FUZZ_CTX_WORDS = 8
FUZZ_AUX = dict(time_ns=1000, cpu=1, pid=77)


def corpus_case(text: str, tape, n: int, seed: int, vec: bool, device):
    """(spec_key, table, rows, maps, aux) of one fuzz-corpus program in a
    one-slot table on the vec (vec=True) or the sequential sub-lane, over
    n events: the corpus tape's rows, then random ones. None when the
    program may not take the vec sub-lane."""
    from ..core import asm, isa, jit as J, maps as M, verifier
    from ..core.table_interp import LiveTable, batched_encodable
    specs = [_spec(s) for s in FUZZ_SPECS]
    vprog = verifier.verify(asm.assemble(text).insns, specs,
                            ctx_words=FUZZ_CTX_WORDS)
    if vec and not batched_encodable(vprog):
        return None
    lt = LiveTable(specs, ctx_words=FUZZ_CTX_WORDS, max_programs=1,
                   max_insns=max(128, len(vprog.insns)))
    lt.encode_slot(0, vprog, site_id=0, kind=0)
    lt.host["vec"][0] = int(vec)
    rng = np.random.default_rng(seed)
    rows = np.concatenate([
        np.array([[isa.s64(int(w)) for w in r] for r in tape], np.int64),
        np.where(rng.random((n, FUZZ_CTX_WORDS)) < 0.5,
                 rng.integers(0, 200, (n, FUZZ_CTX_WORDS)),
                 rng.integers(-(1 << 62), 1 << 62, (n, FUZZ_CTX_WORDS)))])
    return (lt.spec_key, lt.device_state(device),
            torch.as_tensor(rows[:n], device=device),
            M.init_states(specs, device), J.make_aux(device=device,
                                                     **FUZZ_AUX))


def to_cpu(tree):
    """A copy of a case (or a result) with every tensor on the CPU."""
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(to_cpu(v) for v in tree)
    return tree.cpu() if isinstance(tree, torch.Tensor) else tree


def compare(got, want) -> list[str]:
    """Names of the (maps, aux, r0) leaves that differ between a kernel run
    and a plain run (both on the CPU by now)."""
    bad = []
    gm, ga, gr = got
    wm, wa, wr = want
    for name in wm:
        for f in wm[name]:
            if not torch.equal(gm[name][f], wm[name][f]):
                bad.append(f"{name}.{f}")
    for k in wa:
        if not torch.equal(ga[k].reshape(wa[k].shape), wa[k]):
            bad.append(f"aux.{k}")
    if (gr is None) != (wr is None) or (gr is not None
                                        and not torch.equal(gr, wr)):
        bad.append("r0")
    return bad
