"""The port's probe core (repro_torch.core) against the JAX package's, on
the CPU, all bit-exact: the u64 helper, the T1/T2 JIT against the numpy
oracle VM, the device map twins against the numpy twins, probe_stage in all
three modes against JAX's on one shared tape, and fuzz seeds 0-49."""
import glob
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import (asm as JA, events as JE, fuzz as JF, jit as JJ,  # noqa: E402,E501
                        maps as JM, vm as JVM)
from repro.core.runtime import BpftimeRuntime as JRuntime  # noqa: E402

from repro_torch.core import (asm as TA, events as TE, isa as TI,  # noqa: E402
                              jit as TJ, maps as TM, u64 as U, verifier as TV,
                              vectorized as TVec)
from repro_torch.core.runtime import BpftimeRuntime as TRuntime, to_numpy  # noqa: E402,E501

CPU = "cpu"
M64 = (1 << 64) - 1
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _tspec(sp):
    """The port's MapSpec for one of the JAX package's."""
    return TM.MapSpec(sp.name, TM.MapKind(sp.kind.value), sp.max_entries,
                      rec_width=sp.rec_width, num_shards=sp.num_shards)


def _t(words):
    return torch.tensor([U.s64(int(w)) for w in words], dtype=torch.int64)


# --------------------------------------------------------------- u64 helper

def _u64_cases():
    rng = np.random.default_rng(0)
    edge = [0, 1, 2, 3, 7, (1 << 31) - 1, 1 << 31, (1 << 32) - 1, 1 << 32,
            (1 << 63) - 1, 1 << 63, (1 << 63) + 5, M64 - 1, M64]
    vals = edge + [int(v) for v in rng.integers(0, 1 << 63, 40,
                                                dtype=np.uint64)] \
        + [int(v) | (1 << 63) for v in rng.integers(0, 1 << 62, 20)] \
        + [int(v) for v in rng.integers(1, 1 << 20, 20)]
    a, b = zip(*[(x, y) for x in vals for y in vals])
    return list(a), list(b)


def test_u64_compare_shift_divmod_match_python():
    a, b = _u64_cases()
    ta, tb = _t(a), _t(b)
    assert U.ult(ta, tb).tolist() == [x < y for x, y in zip(a, b)]
    assert U.ule(ta, tb).tolist() == [x <= y for x, y in zip(a, b)]
    assert U.ugt(ta, tb).tolist() == [x > y for x, y in zip(a, b)]
    assert U.uge(ta, tb).tolist() == [x >= y for x, y in zip(a, b)]
    s = _t([y % 64 for y in b])
    assert U.lshr(ta, s).tolist() == [U.s64(x >> (y % 64))
                                      for x, y in zip(a, b)]
    assert U.shl(ta, s).tolist() == [U.s64(x << (y % 64))
                                     for x, y in zip(a, b)]
    for k in (0, 1, 33, 63):
        assert U.lshr(ta, k).tolist() == [U.s64(x >> k) for x in a]
    nz = [i for i, y in enumerate(b) if y]
    q, r = U.udivmod(ta[nz], tb[nz])
    assert q.tolist() == [U.s64(a[i] // b[i]) for i in nz]
    assert r.tolist() == [U.s64(a[i] % b[i]) for i in nz]
    assert U.hash_home(ta, 37).tolist() == [
        ((x * U.HASH_MULT) & M64) >> 33 and (((x * U.HASH_MULT) & M64) >> 33)
        % 37 for x in a]


# ------------------------------------------- JIT against the numpy oracle VM

def _arr(n=8):
    return JM.MapSpec("a", JM.MapKind.ARRAY, max_entries=n)


def _hash(n=8):
    return JM.MapSpec("h", JM.MapKind.HASH, max_entries=n)


_FILL = "\n".join(
    f"mov r6, {100 + k}\nstxdw [r10-8], r6\nmov r6, {k}\nstxdw [r10-16], r6\n"
    "mov r1, 0\nmov r2, r10\nadd r2, -8\nmov r3, r10\nadd r3, -16\n"
    "mov r4, 0\ncall map_update_elem\nand r0, 0xff\nadd r8, r0"
    for k in range(6))

# (name, text, ctx words, map specs, aux) -- the cases of
# tests/test_vm_jit_differential.py
VM_CASES = [
    ("alu64", """mov r1, 1000
        mov r2, 37
        mov r0, r1
        mul r0, r2
        div r0, 7
        mod r0, 1000
        xor r0, 0xff
        lsh r0, 3
        rsh r0, 1
        arsh r0, 1
        neg r0
        and r0, 0xffff
        or  r0, 0x10000
        sub r0, 5
        exit""", None, [], {}),
    ("alu32_zero_extend", """mov r0, -1
        add32 r0, 1
        mov r1, -1
        mov32 r1, -1
        add r0, r1
        exit""", None, [], {}),
    ("div_mod_by_zero", """mov r0, 42
        mov r1, 0
        div r0, r1
        mov r2, 13
        mod r2, r1
        add r0, r2
        exit""", None, [], {}),
    ("unsigned_div_mod", """mov r0, -7
        mov r1, 3
        div r0, r1
        mov r2, -1
        lddw r3, 0x8000000000000001
        mod r2, r3
        add r0, r2
        mov r4, -100
        div32 r4, 7
        add r0, r4
        exit""", None, [], {}),
    ("shift_masking", """mov r0, 1
        mov r1, 65
        lsh r0, r1
        mov r2, 1
        mov r3, 33
        lsh32 r2, r3
        add r0, r2
        mov r4, -1
        rsh r4, 60
        add r0, r4
        mov r5, -16
        arsh32 r5, 2
        add r0, r5
        exit""", None, [], {}),
    ("branches", """mov r1, 10
        mov r0, 0
        jgt r1, 5, big
        mov r0, 111
        ja out
        big:
        mov r0, 222
        out:
        exit""", None, [], {}),
    ("signed_vs_unsigned", """mov r1, -1
        mov r0, 0
        jsgt r1, 0, spos
        add r0, 1
        spos:
        jgt r1, 0, upos
        add r0, 100
        upos:
        jlt r1, 5, no
        add r0, 1000
        no:
        jset r1, 0x80, yes
        add r0, 10000
        yes:
        exit""", None, [], {}),
    ("jmp32", """lddw r1, 0x1_00000005
        mov r0, 0
        jeq32 r1, 5, yes
        ja out
        yes:
        mov r0, 1
        lddw r2, 0xffffffff_00000001
        jsgt32 r2, 0, out
        add r0, 10
        out:
        exit""", None, [], {}),
    ("stack_sizes", """lddw r1, 0x1234567890abcdef
        stxdw [r10-8], r1
        ldxb r0, [r10-8]
        ldxh r2, [r10-7]
        add r0, r2
        ldxw r3, [r10-6]
        add r0, r3
        ldxdw r4, [r10-8]
        add r0, r4
        stxdw [r10-16], r1
        stw [r10-16], -1
        ldxw r5, [r10-16]
        add r0, r5
        stxh [r10-11], r1
        ldxdw r5, [r10-16]
        add r0, r5
        exit""", None, [], {}),
    ("ctx_reads", """ldxdw r0, [r1+0]
        ldxdw r2, [r1+8]
        add r0, r2
        ldxw r3, [r1+16]
        add r0, r3
        ldxb r4, [r1+17]
        add r0, r4
        exit""", [11, 31, 0x1_0000_0007], [], {}),
    ("loop_tier2", """mov r1, 10
        mov r0, 0
        loop:
        add r0, r1
        sub r1, 1
        jgt r1, 0, loop
        exit""", None, [], {}),
    ("array_update_lookup", """mov r6, 3
        stxdw [r10-8], r6
        mov r6, 99
        stxdw [r10-16], r6
        mov r1, 0
        mov r2, r10
        add r2, -8
        mov r3, r10
        add r3, -16
        mov r4, 0
        call map_update_elem
        mov r1, 0
        mov r2, r10
        add r2, -8
        call map_lookup_elem
        exit""", None, [_arr()], {}),
    ("array_fetch_add_oob", """mov r6, 2
        stxdw [r10-8], r6
        mov r1, 0
        mov r2, r10
        add r2, -8
        mov r3, 5
        call map_fetch_add
        mov r1, 0
        mov r2, r10
        add r2, -8
        mov r3, 7
        call map_fetch_add
        mov r7, r0
        mov r6, 1000
        stxdw [r10-8], r6
        mov r1, 0
        mov r2, r10
        add r2, -8
        mov r3, 5
        call map_fetch_add
        add r0, r7
        exit""", None, [_arr()], {}),
    ("hash_update_lookup_delete", """lddw r6, 0xdeadbeefcafe
        stxdw [r10-8], r6
        mov r6, 1234
        stxdw [r10-16], r6
        mov r1, 0
        mov r2, r10
        add r2, -8
        mov r3, r10
        add r3, -16
        mov r4, 0
        call map_update_elem
        mov r1, 0
        mov r2, r10
        add r2, -8
        call map_lookup_elem
        mov r7, r0
        mov r1, 0
        mov r2, r10
        add r2, -8
        call map_delete_elem
        mov r1, 0
        mov r2, r10
        add r2, -8
        call map_lookup_elem
        add r0, r7
        mov r1, 0
        mov r2, r10
        add r2, -8
        mov r3, 3
        call map_fetch_add
        exit""", None, [_hash()], {}),
    ("hash_collisions_fill", "mov r8, 0\n" + _FILL + "\nmov r0, r8\nexit",
     None, [_hash(4)], {}),
    ("hist_ringbuf", """mov r1, 0
        mov r2, 1000
        call hist_add
        mov r1, 0
        mov r2, 0
        call hist_add
        mov r6, 41
        stxdw [r10-16], r6
        mov r6, 42
        stxdw [r10-8], r6
        mov r1, 1
        mov r2, r10
        add r2, -16
        mov r3, 16
        mov r4, 0
        call ringbuf_output
        exit""", None, [JM.MapSpec("hist", JM.MapKind.LOG2HIST),
                        JM.MapSpec("rb", JM.MapKind.RINGBUF, max_entries=4,
                                   rec_width=2)], {}),
    ("percpu", """mov r6, 5
        stxdw [r10-8], r6
        mov r1, 0
        mov r2, r10
        add r2, -8
        mov r3, 9
        call percpu_fetch_add
        mov r1, 0
        mov r2, r10
        add r2, -8
        call map_lookup_elem
        exit""", None, [JM.MapSpec("pc", JM.MapKind.PERCPU_ARRAY,
                                   max_entries=8, num_shards=2)],
     dict(cpu=1)),
    ("override_log2_aux", """mov r1, 4096
        call log2
        mov r6, r0
        call ktime_get_ns
        add r6, r0
        call get_smp_processor_id
        add r6, r0
        call get_current_pid_tgid
        add r6, r0
        call get_prandom_u32
        add r6, r0
        mov r1, r6
        mov r2, 7
        call trace_printk
        mov r1, 255
        call override_return
        mov r0, r6
        exit""", None, [], dict(time_ns=1000, cpu=3, pid=77)),
    ("branchy_predication", """ldxdw r6, [r1+0]
        mov r7, 1
        jgt r6, 100, hot
        mov r7, 0
        hot:
        stxdw [r10-8], r7
        mov r1, 0
        mov r2, r10
        add r2, -8
        mov r3, 1
        call map_fetch_add
        mov r0, r7
        exit""", [50], [_arr()], {}),
]


def _oracle(text, ctx, specs, aux_kw):
    a = JA.assemble(text)
    st = JM.init_states(specs, np)
    res = JVM.run(a.insns, JVM.pack_ctx(ctx), specs, st, JVM.Aux(**aux_kw))
    return res, st


def _port_run(text, ctx, specs, aux_kw):
    tspecs = [_tspec(s) for s in specs]
    a = TA.assemble(text)
    vprog = TV.verify(a.insns, tspecs, ctx_words=len(ctx))
    prog = TJ.compile_program(vprog)
    r0, maps, aux = prog(_t(ctx)[None, :], TM.init_states(tspecs, CPU),
                         TJ.make_aux(device=CPU, **aux_kw))
    return vprog, r0, maps, aux


@pytest.mark.parametrize("case", VM_CASES, ids=[c[0] for c in VM_CASES])
def test_jit_matches_numpy_oracle(case):
    _, text, ctx, specs, aux_kw = case
    ctx = ctx or [0] * 8
    res, want = _oracle(text, ctx, specs, aux_kw)
    vprog, r0, maps, aux = _port_run(text, ctx, specs, aux_kw)
    assert TI.u64(int(r0[0])) == TI.u64(res.r0)
    got = to_numpy(maps)
    for sp in specs:
        for f, arr in want[sp.name].items():
            np.testing.assert_array_equal(got[sp.name][f], arr,
                                          err_msg=f"{sp.name}.{f}")
    assert int(aux["override_set"]) == res.aux.override_set
    if res.aux.override_set:
        assert TI.u64(int(aux["override_val"])) == res.aux.override_val
    assert int(aux["printk_n"]) == len(res.aux.printk)


def test_random_straightline_alu_matches_oracle():
    """Seeded random ALU programs (64- and 32-bit, imm and reg sources)."""
    rng = np.random.default_rng(7)
    ops = ["add", "sub", "mul", "div", "or", "and", "lsh", "rsh", "mod",
           "xor", "arsh", "mov"]
    for _ in range(12):
        lines = [f"ldxdw r{i}, [r1+{8 * i}]" for i in range(2, 6)]
        lines.append("mov r0, 0")
        for _ in range(int(rng.integers(4, 20))):
            op = ops[int(rng.integers(len(ops)))]
            w = "32" if rng.random() < 0.3 else ""
            dst = int(rng.choice([0, 2, 3, 4, 5]))
            if rng.random() < 0.5:
                lines.append(f"{op}{w} r{dst}, r{int(rng.integers(2, 6))}")
            else:
                lines.append(f"{op}{w} r{dst}, "
                             f"{int(rng.integers(-2**31, 2**31))}")
        lines += ["add r0, r2", "xor r0, r3", "add r0, r4", "xor r0, r5",
                  "exit"]
        ctx = [int(v) for v in rng.integers(0, 1 << 63, 8, dtype=np.uint64)]
        text = "\n".join(lines)
        res, _ = _oracle(text, ctx, [], {})
        _, r0, _, _ = _port_run(text, ctx, [], {})
        assert TI.u64(int(r0[0])) == TI.u64(res.r0), text


# -------------------------------------------------- corpus + fuzz seeds 0-49

CORPUS = sorted(glob.glob(os.path.join(ROOT, "tests", "corpus", "*.json")))
FUZZ_T = [_tspec(s) for s in JF.FUZZ_SPECS]


def _fuzz_case_matches(case):
    """Every lane the port has for one fuzz case against the numpy oracle:
    the scan lane event by event (r0 and override too) and, when the
    program is vector-safe, the shadow+apply lane over the whole tape.
    Returns the lanes run, or None when the verifier rejects the program."""
    from repro.core import verifier as JV
    a = JA.assemble(case.text)
    try:
        JV.verify(a.insns, JF.FUZZ_SPECS, ctx_words=JF.CTX_WORDS)
    except JV.VerifierError:
        with pytest.raises(TV.VerifierError):
            TV.verify(TA.assemble(case.text).insns, FUZZ_T,
                      ctx_words=JF.CTX_WORDS)
        return None
    np_maps = JM.init_states(JF.FUZZ_SPECS, np)
    oracle = [JVM.run(a.insns, JVM.pack_ctx(row), JF.FUZZ_SPECS, np_maps,
                      JVM.Aux(**JF._aux_kw(i)))
              for i, row in enumerate(case.tape)]
    vprog = TV.verify(TA.assemble(case.text).insns, FUZZ_T,
                      ctx_words=JF.CTX_WORDS)
    rows = torch.stack([_t(r) for r in case.tape])
    prog = TJ.compile_program(vprog)
    maps = TM.init_states(FUZZ_T, CPU)
    for i, want in enumerate(oracle):
        r0, maps, aux = prog(rows[i:i + 1], maps,
                             TJ.make_aux(device=CPU, **JF._aux_kw(i)))
        assert TI.u64(int(r0[0])) == TI.u64(want.r0), (case.seed, i)
        assert int(aux["override_set"]) == want.aux.override_set
        if want.aux.override_set:
            assert TI.u64(int(aux["override_val"])) == want.aux.override_val
    lanes = {"scan": maps}
    if TVec.is_vector_safe(vprog):
        lanes["vectorized"], _ = TVec.run_vectorized(
            vprog, rows, torch.ones(len(case.tape), dtype=torch.bool),
            TM.init_states(FUZZ_T, CPU),
            TJ.make_aux(device=CPU, **JF._aux_kw(0)))
    for lane, st in lanes.items():
        got = to_numpy(st)
        for sp in JF.FUZZ_SPECS:
            for f, arr in np_maps[sp.name].items():
                np.testing.assert_array_equal(
                    got[sp.name][f], arr,
                    err_msg=f"seed {case.seed} {lane}: {sp.name}.{f}")
    return sorted(lanes)


@pytest.mark.parametrize("path", CORPUS, ids=[os.path.basename(p)
                                              for p in CORPUS])
def test_corpus_cases_match_oracle(path):
    with open(path) as fh:
        d = json.load(fh)
    lanes = _fuzz_case_matches(JF.FuzzCase.from_json(d))
    assert lanes is not None
    assert ("vectorized" in lanes) == ("vectorized" in d["lanes"])


@pytest.mark.parametrize("block", range(5))
def test_fuzz_seeds_match_oracle(block):
    """Seeds 0-49 of the grammar fuzzer, ten per case."""
    accepted = 0
    for seed in range(10 * block, 10 * block + 10):
        accepted += _fuzz_case_matches(JF.generate_case(seed)) is not None
    assert accepted >= 5


# ------------------------------------------------------ device map twins

def test_map_twins_match_numpy_twins():
    rng = np.random.default_rng(11)
    specs = [TM.MapSpec("a", TM.MapKind.ARRAY, 8),
             TM.MapSpec("h", TM.MapKind.HASH, 8),
             TM.MapSpec("p", TM.MapKind.PERCPU_ARRAY, 8, num_shards=2),
             TM.MapSpec("g", TM.MapKind.LOG2HIST),
             TM.MapSpec("r", TM.MapKind.RINGBUF, 4, rec_width=3)]
    nst = TM.init_states_np(specs)
    tst = TM.init_states(specs, CPU)

    def i(v):
        return torch.tensor(U.s64(v))

    yes = torch.tensor(True)
    for step in range(300):
        op = int(rng.integers(9))
        key = int(rng.choice([rng.integers(-2, 10), rng.integers(0, 12),
                              rng.integers(-(1 << 62), 1 << 62)]))
        val = int(rng.integers(-(1 << 40), 1 << 40))
        pred = bool(rng.random() < 0.85)
        p = torch.tensor(pred)
        if op == 0:
            got = TM.t_array_lookup(tst["a"], i(key), p)
            assert int(got) == (TM.n_array_lookup(nst["a"], key)
                                if pred else 0)
        elif op == 1:
            tst["a"], old = TM.t_array_fetch_add(tst["a"], i(key), i(val), p)
            if pred:
                assert int(old) == TM.n_array_fetch_add(nst["a"], key, val)
        elif op == 2:
            tst["a"] = TM.t_array_update(tst["a"], i(key), i(val), p)
            if pred:
                TM.n_array_update(nst["a"], key, val)
        elif op == 3:
            tst["h"], ok = TM.t_hash_update(tst["h"], i(key), i(val), p)
            if pred:
                assert bool(ok) == TM.n_hash_update(nst["h"], key, val)
        elif op == 4:
            tst["h"], old = TM.t_hash_fetch_add(tst["h"], i(key), i(val), p)
            if pred:
                assert int(old) == TM.n_hash_fetch_add(nst["h"], key, val)
        elif op == 5:
            tst["h"], found = TM.t_hash_delete(tst["h"], i(key), p)
            if pred:
                assert bool(found) == TM.n_hash_delete(nst["h"], key)
            got = TM.t_hash_lookup(tst["h"], i(key), yes)
            assert int(got) == TM.n_hash_lookup(nst["h"], key)
        elif op == 6:
            cpu = int(rng.integers(0, 3))
            tst["p"], old = TM.t_percpu_fetch_add(tst["p"], i(cpu), i(key),
                                                  i(val), p)
            if pred and 0 <= key < 8:
                sh = min(cpu, 1)
                assert int(old) == int(nst["p"]["values"][sh, key])
                nst["p"]["values"][sh, key] += val
            assert int(TM.t_percpu_lookup(tst["p"], i(cpu), i(key), yes)) \
                == (int(nst["p"]["values"][min(cpu, 1), key])
                    if 0 <= key < 8 else 0)
        elif op == 7:
            tst["g"] = TM.t_hist_add(tst["g"], i(val), p)
            if pred:
                TM.n_hist_add(nst["g"], val)
        else:
            rec = [int(v) for v in rng.integers(-99, 99, 3)]
            tst["r"] = TM.t_ringbuf_emit(tst["r"], _t(rec), p)
            if pred:
                TM.n_ringbuf_emit(nst["r"], rec)
        got = to_numpy(tst)
        for name in nst:
            for f in nst[name]:
                np.testing.assert_array_equal(got[name][f], nst[name][f],
                                              err_msg=f"step {step} {name}")
    assert int(nst["h"]["used"].max()) >= 1
    assert int(nst["r"]["dropped"][0]) > 0


def test_hash_fetch_add_batch_twin_matches_numpy():
    rng = np.random.default_rng(12)
    spec = TM.MapSpec("h", TM.MapKind.HASH, 16)
    nst = TM.init_state_np(spec)
    for k in rng.integers(0, 40, 12):
        TM.n_hash_update(nst, int(k), int(rng.integers(-9, 9)))
    for k in rng.integers(0, 40, 4):
        TM.n_hash_delete(nst, int(k))
    keys = rng.integers(0, 60, 50)
    deltas = rng.integers(-(1 << 40), 1 << 40, 50)
    ok = rng.random(50) < 0.8
    tst = TM.t_hash_fetch_add_batch(
        {f: torch.as_tensor(a.copy()) for f, a in nst.items()},
        torch.as_tensor(keys), torch.as_tensor(deltas), torch.as_tensor(ok))
    TM.n_hash_fetch_add_batch(nst, keys, deltas, ok)
    for f in nst:
        np.testing.assert_array_equal(tst[f].numpy(), nst[f], err_msg=f)


# --------------------------------------- probe_stage against JAX, 3 modes

_COUNT = """
    ldxdw r6, [r1+ctx:layer]
    stxdw [r10-8], r6
    lddw r1, map:{m}
    mov r2, r10
    add r2, -8
    mov r3, 1
    call map_fetch_add
    mov r0, 0
    exit
"""
_HIST = """
    ldxdw r2, [r1+ctx:rms]
    lddw r1, map:pp_hist
    call hist_add
    mov r0, 0
    exit
"""
_RB = """
    ldxdw r6, [r1+ctx:layer]
    stxdw [r10-32], r6
    ldxdw r6, [r1+ctx:numel]
    stxdw [r10-24], r6
    lddw r1, map:pp_rb
    mov r2, r10
    add r2, -32
    mov r3, 16
    mov r4, 0
    call ringbuf_output
    mov r0, 0
    exit
"""
# (name, text, (map, kind, n, rec_width), target)
PIPELINE = [  # tests/test_kernels_fallback.py::_run_pipeline
    ("fb_count", _COUNT.format(m="pp_counts"), ("pp_counts", "array", 16, 4),
     "uprobe:pp_block"),
    ("fb_rb", _RB, ("pp_rb", "ringbuf", 8, 4), "uprobe:pp_block"),
]
PROBE_PIPELINE = [  # benchmarks/probe_pipeline.py PROGS
    ("bp_count", _COUNT.format(m="pp_layer"), ("pp_layer", "array", 128, 4),
     "uprobe:pp_block"),
    ("bp_hash", _COUNT.format(m="pp_keys"), ("pp_keys", "hash", 256, 4),
     "uprobe:pp_block"),
    ("bp_hist", _HIST, ("pp_hist", "log2hist", 64, 4), "uretprobe:pp_block"),
]


def _runtime(RT, Mmod, progs):
    rt = RT()
    for name, text, (m, kind, n, w), target in progs:
        spec = Mmod.MapSpec(m, Mmod.MapKind(kind), n, rec_width=w)
        rt.attach(rt.load_asm(name, text, [spec], "uprobe"), target,
                  mode="fused")
    return rt


def _tape(n, site_id, seed):
    rng = np.random.default_rng(seed)
    rows = np.zeros((n, JE.EVENT_WIDTH), np.int64)
    rows[:, 0] = site_id
    rows[rng.random(n) < 0.1, 0] = site_id + 1000   # unattached site
    rows[:, 1] = np.where(np.arange(n) % 3 == 2, JE.KIND_EXIT, JE.KIND_ENTRY)
    rows[:, 2] = rng.integers(0, 300, n)             # layer (some out of range)
    rows[:, 4] = rng.integers(0, 1 << 20, n)
    rows[:, 6] = rng.integers(-5, 1 << 40, n)        # rms (fx)
    return rows


@pytest.mark.parametrize("mode", ["fused", "vectorized", "scan"])
@pytest.mark.parametrize("progs", [PIPELINE, PROBE_PIPELINE],
                         ids=["run_pipeline", "probe_pipeline"])
def test_probe_stage_matches_jax(progs, mode):
    jrt = _runtime(JRuntime, JM, progs)
    trt = _runtime(TRuntime, TM, progs)
    base = _tape(96, 0, seed=len(progs))
    jrows, trows = base.copy(), base.copy()
    jrows[:, 0] += JE.SITES.get_or_create("pp_block")
    trows[:, 0] += TE.SITES.get_or_create("pp_block")
    jm, jaux = jrt.probe_stage(jnp.asarray(jrows), jrt.init_device_maps(),
                               JJ.make_aux(time_ns=5), mode=mode)
    tm, taux = trt.probe_stage(torch.as_tensor(trows),
                               trt.init_device_maps(CPU),
                               TJ.make_aux(time_ns=5, device=CPU), mode=mode)
    got = to_numpy(tm)
    assert set(got) == set(jm)
    for name in jm:
        for f in jm[name]:
            np.testing.assert_array_equal(got[name][f], np.asarray(jm[name][f]),
                                          err_msg=f"{name}.{f} [{mode}]")
    assert any(got[name][f].any() for name in got for f in got[name])


def test_collector_rows_match_jax():
    """One collected event row: header lanes exact, stat lanes within the
    tensor_stats tolerance of JAX's row."""
    jrt = _runtime(JRuntime, JM, PIPELINE)
    trt = _runtime(TRuntime, TM, PIPELINE)
    x = np.random.default_rng(5).normal(size=(3, 40)).astype(np.float32) * 4
    x[0, 3], x[1, 7] = np.nan, np.inf
    with jrt.collector() as col:
        JE.probe_site("pp_block", jnp.asarray(x), kind=JE.KIND_ENTRY)
        jrow = np.asarray(col.take_all_rows())[0]
    with trt.collector() as col:
        TE.probe_site("pp_block", torch.as_tensor(x), kind=TE.KIND_ENTRY)
        trow = col.take_all_rows().numpy()[0]
    np.testing.assert_array_equal(trow[[1, 2, 3, 4, 10, 11, 12, 13, 14, 15]],
                                  jrow[[1, 2, 3, 4, 10, 11, 12, 13, 14, 15]])
    np.testing.assert_allclose(trow[5:10].astype(np.float64),
                               jrow[5:10].astype(np.float64), rtol=2e-5,
                               atol=2e-5 * TE.FX_ONE)


def test_traceable_entry_and_exit_rows_match_jax():
    """uprobe/uretprobe rows of a @traceable function: the first tensor
    argument on entry, the first output tensor on exit."""
    def rows_of(E, col_of, x, mk):
        @E.traceable("pp_fn")
        def fn(params, y):
            return {"out": y * 2.0 + params["b"]}

        sid = E.SITES.get_or_create("pp_fn")
        with col_of({(sid, E.KIND_ENTRY), (sid, E.KIND_EXIT)}) as col:
            fn({"b": mk(np.ones(3, np.float32))}, mk(x))
            return np.asarray(col.take_all_rows())

    x = np.arange(6, dtype=np.float32).reshape(2, 3) - 2.5
    jr = rows_of(JE, JE.Collector, x, jnp.asarray)
    tr = rows_of(TE, TE.Collector, x, torch.as_tensor)
    assert tr.shape == jr.shape == (2, TE.EVENT_WIDTH)
    np.testing.assert_array_equal(tr[:, [1, 4]], jr[:, [1, 4]])
    np.testing.assert_allclose(tr[:, 5:10].astype(np.float64),
                               jr[:, 5:10].astype(np.float64), rtol=2e-5,
                               atol=2e-5 * TE.FX_ONE)


def test_to_fx_saturates_and_zeroes_nan():
    x = np.array([0.5, -1.25, np.nan, np.inf, -np.inf, 3e30, 1e-9],
                 np.float32)
    np.testing.assert_array_equal(TE.to_fx(torch.as_tensor(x)).numpy(),
                                  np.asarray(JE.to_fx(jnp.asarray(x))))
    np.testing.assert_array_equal(
        TE.from_fx(torch.tensor([65536, -32768])).numpy(), [1.0, -0.5])


# ------------------------------------------------------------- import guard

def test_port_imports_neither_jax_nor_repro():
    """Every repro_torch module imports in a process where `jax` and
    `repro` cannot be imported."""
    code = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                "repro_torch.")]
for n in names:
    importlib.import_module(n)
bad = [m for m in sys.modules if m == "jax" or m.startswith("jax.")
       or m == "repro" or m.startswith("repro.")]
bad = [m for m in bad if sys.modules[m] is not None]
assert not bad, bad
training = {"repro_torch.kernels.flash_attention", "repro_torch.optim",
            "repro_torch.optim.optimizers", "repro_torch.data.pipeline",
            "repro_torch.train.train_step", "repro_torch.launch.train"}
assert training <= set(names), training - set(names)
live = {"repro_torch.core.table_interp", "repro_torch.core.promote",
        "repro_torch.core.callback_probe", "repro_torch.kernels.table_interp",
        "repro_torch.kernels.interp_cases"}
assert live <= set(names), live - set(names)
fleet = {"repro_torch.dist.compression", "repro_torch.ckpt.checkpoint",
         "repro_torch.ft.fault_tolerance", "repro_torch.core.faults",
         "repro_torch.core.shm", "repro_torch.core.artifact_cache"}
assert fleet <= set(names), fleet - set(names)
aggregator = {"repro_torch.core.daemon", "repro_torch.core.treeagg",
              "repro_torch.core.fuzz"}
assert aggregator <= set(names), aggregator - set(names)
print(len(names))
"""
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    out = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 71
