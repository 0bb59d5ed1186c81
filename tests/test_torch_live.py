"""The port's live lane (repro_torch.core.{table_interp,callback_probe})
against the JAX package's, on the CPU, bit for bit: the live table's host
arrays, the plain interpreter against JAX's table interpreter over the
corpus and fuzz seeds 0-49, LiveTable.run on mixed tables, the kernel-mode
baseline's host maps, and the ring-buffer apply's dropped count. The
runtime's live half, promotion and serving with a mid-serve attach are in
tests/test_torch_live_runtime.py, which shares this file's helpers."""
import glob
import json
import os
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import (asm as JA, callback_probe as JCB, events as JE,  # noqa: E402,E501
                        fuzz as JF, isa as JI, jit as JJ, maps as JM, table_interp as JT, vectorized as JV,
                        verifier as JVf)
from repro.core.runtime import BpftimeRuntime as JRuntime  # noqa: E402

from repro_torch.core import (asm as TA, callback_probe as TCB,  # noqa: E402
                              events as TE, jit as TJ, maps as TM, table_interp as TT, u64 as U,
                              vectorized as TV, verifier as TVf)
from repro_torch.core.runtime import BpftimeRuntime as TRuntime, to_numpy  # noqa: E402,E501
from repro_torch.kernels import interp_cases as IC, ref as TREF  # noqa: E402

CPU = "cpu"
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CORPUS = sorted(glob.glob(os.path.join(ROOT, "tests", "corpus", "*.json")))

COUNT_BY_LAYER = """
    ldxdw r6, [r1+ctx:layer]
    stxdw [r10-8], r6
    lddw r1, map:lv_counts
    mov r2, r10
    add r2, -8
    mov r3, 1
    call map_fetch_add
    mov r0, 0
    exit
"""
HASH_BY_LAYER = COUNT_BY_LAYER.replace("lv_counts", "lv_hash")
HIST_NUMEL = """
    ldxdw r2, [r1+ctx:numel]
    lddw r1, map:lv_hist
    call hist_add
    mov r0, 0
    exit
"""
LOOP_SUM = """
    ldxdw r6, [r1+ctx:layer]
    mov r7, 0
    loop:
    add r7, 1
    sub r6, 1
    jsgt r6, 0, loop
    stxdw [r10-8], r7
    lddw r1, map:lv_counts
    mov r2, r10
    add r2, -8
    mov r3, r7
    call map_fetch_add
    mov r0, 0
    exit
"""
RB_RECORD = """
    ldxdw r6, [r1+ctx:step]
    stxdw [r10-32], r6
    ldxdw r6, [r1+ctx:numel]
    stxdw [r10-24], r6
    ldxdw r6, [r1+ctx:layer]
    stxdw [r10-16], r6
    ldxdw r6, [r1+ctx:kind]
    stxdw [r10-8], r6
    lddw r1, map:lv_rb
    mov r2, r10
    add r2, -32
    mov r3, 32
    mov r4, 0
    call ringbuf_output
    mov r0, 0
    exit
"""
# (name, kind, max_entries, rec_width, num_shards)
SPECS = [("lv_counts", "array", 64, 4, 1), ("lv_hash", "hash", 64, 4, 1),
         ("lv_hist", "log2hist", 64, 4, 1), ("lv_rb", "ringbuf", 16, 4, 1)]
PROGS = {"count": (COUNT_BY_LAYER, "lv_counts"),
         "hash": (HASH_BY_LAYER, "lv_hash"),
         "hist": (HIST_NUMEL, "lv_hist"),
         "loop": (LOOP_SUM, "lv_counts"),
         "rb": (RB_RECORD, "lv_rb")}


def _jspec(t):
    return JM.MapSpec(t[0], JM.MapKind(t[1]), t[2], rec_width=t[3],
                      num_shards=t[4])


def _tspec(t):
    return TM.MapSpec(t[0], TM.MapKind(t[1]), t[2], rec_width=t[3],
                      num_shards=t[4])


SPEC_OF = {s[0]: s for s in SPECS}


class Pair:
    """The same runtime built twice, JAX's and the port's, driven by the
    same calls."""

    def __init__(self, live=True, arm=("uprobe:lv_block",
                                       "uretprobe:lv_block"), **kw):
        self.j, self.t = JRuntime(), TRuntime()
        for s in SPECS:
            self.j.create_map(_jspec(s))
            self.t.create_map(_tspec(s))
        if live:
            self.j.enable_live_attach(arm=arm, **kw)
            self.t.enable_live_attach(arm=arm, **kw)
        self.pids = {}
        self._jit = {}

    def load(self, name):
        text, m = PROGS[name]
        if name not in self.pids:
            self.pids[name] = (
                self.j.load_asm(name, text, [_jspec(SPEC_OF[m])], "uprobe"),
                self.t.load_asm(name, text, [_tspec(SPEC_OF[m])], "uprobe"))
        return self.pids[name]

    def attach(self, name, target, **kw):
        jp, tp = self.load(name)
        return self.j.attach(jp, target, **kw), self.t.attach(tp, target,
                                                              **kw)

    def maps(self):
        return self.j.init_device_maps(), self.t.init_device_maps(CPU)

    def stage(self, rows, jm, tm, mode=None):
        """Both runtimes' probe_stage over one tape of the port's site ids
        (JAX's jitted once per runtime and mode, as a step is)."""
        if mode not in self._jit:
            self._jit[mode] = jax.jit(lambda r, m: self.j.probe_stage(
                r, m, JJ.make_aux(), mode=mode))
        jm, ja = self._jit[mode](jnp.asarray(jax_sites(rows)), jm)
        tm, ta = self.t.probe_stage(torch.as_tensor(rows), tm,
                                    TJ.make_aux(device=CPU), mode=mode)
        return jm, ja, tm, ta


def jax_sites(rows):
    """`rows` (the port's site ids in column 0) with the JAX package's ids
    for the same site names: each package numbers sites in the order its
    process first sees them."""
    out = np.array(rows, copy=True)
    for sid in np.unique(out[:, 0]):
        out[rows[:, 0] == sid, 0] = JE.SITES.get_or_create(
            TE.SITES.name_of(int(sid)))
    return out


def make_tape(n=48, seed=7):
    """A tape on site lv_block with the port's site id."""
    rng = np.random.default_rng(seed)
    rows = np.zeros((n, 16), np.int64)
    rows[:, 0] = TE.SITES.get_or_create("lv_block")
    rows[:, 1] = np.where(np.arange(n) % 3 == 2, JE.KIND_EXIT,
                          JE.KIND_ENTRY)
    rows[:, 2] = rng.integers(0, 32, n)
    rows[:, 3] = np.arange(n) // 5
    rows[:, 4] = rng.integers(1, 1 << 30, n)
    return rows


def assert_maps_equal(jm, tm, names=None):
    got = to_numpy(tm)
    for name in names or [s[0] for s in SPECS]:
        for f in jm[name]:
            np.testing.assert_array_equal(got[name][f], np.asarray(jm[name][f]),
                                          err_msg=f"{name}.{f}")


def assert_aux_equal(ja, ta):
    for k in ja:
        np.testing.assert_array_equal(ta[k].numpy(), np.asarray(ja[k]),
                                      err_msg=f"aux.{k}")


def _sites(lt, registry):
    """The active slots' site names (inactive rows are never read)."""
    return [registry.name_of(int(s)) if a else None
            for s, a in zip(lt.host["site"], lt.host["active"])]


def assert_host_equal(jlt, tlt, registries=True):
    """Every host array equal; with `registries`, site ids compared by
    the names each package's registry gives them."""
    assert set(jlt.host) == set(tlt.host)
    for f in jlt.host:
        if f == "site" and registries:
            assert _sites(tlt, TE.SITES) == _sites(jlt, JE.SITES)
            continue
        np.testing.assert_array_equal(tlt.host[f], jlt.host[f], err_msg=f)
    assert tlt.slot_pid == jlt.slot_pid
    views = tlt.views(torch.as_tensor(tlt.packed()))
    for f in tlt.host:
        np.testing.assert_array_equal(views[f].numpy(), tlt.host[f])


# ------------------------------------------------------- the host half

FUZZ_T = [_tspec((s.name, s.kind.value, s.max_entries, s.rec_width,
                  s.num_shards)) for s in JF.FUZZ_SPECS]


def _both_verified(text):
    jv = JVf.verify(JA.assemble(text).insns, JF.FUZZ_SPECS,
                    ctx_words=JF.CTX_WORDS)
    tv = TVf.verify(TA.assemble(text).insns, FUZZ_T, ctx_words=JF.CTX_WORDS)
    return jv, tv


@pytest.mark.parametrize("path", CORPUS, ids=[os.path.basename(p)
                                              for p in CORPUS])
def test_live_table_host_arrays_match_jax_on_corpus(path):
    """encode_slot / clear_slot / _recompute_vec on every corpus program,
    two slots each, then a clear: every host array equal."""
    with open(path) as fh:
        text = json.load(fh)["text"]
    jv, tv = _both_verified(text)
    assert JT.batched_encodable(jv) == TT.batched_encodable(tv)
    jlt = JT.LiveTable(JF.FUZZ_SPECS, ctx_words=8, max_programs=3,
                       max_insns=128)
    tlt = TT.LiveTable(FUZZ_T, ctx_words=8, max_programs=3, max_insns=128)
    for lt, vp in ((jlt, jv), (tlt, tv)):
        lt.encode_slot(0, vp, site_id=5, kind=1, pid=1)
        lt.encode_slot(2, vp, site_id=5, kind=2, pid=2)
    assert_host_equal(jlt, tlt, registries=False)
    jlt.clear_slot(0)
    tlt.clear_slot(0)
    assert_host_equal(jlt, tlt, registries=False)
    assert jlt.free_slot() == tlt.free_slot() == 0
    assert JT.LiveTable.image_key(jv) == TT.LiveTable.image_key(tv)


def test_live_table_vec_flags_and_cross_slot_demotion_match_jax():
    """test_table_interp.py's demotion case: two slots sharing a HASH map
    both demote, the ARRAY slot stays batched, and detaching lifts it."""
    p = Pair()
    lk_c = p.attach("count", "uprobe:lv_block", mode="table")
    lk_h = p.attach("hash", "uprobe:lv_block", mode="table")
    assert p.t.live.host["vec"][lk_c[1].slot] == 1
    assert p.t.live.host["vec"][lk_h[1].slot] == 1
    jp, tp = p.load("hash")
    lk_h2 = (p.j.attach(jp, "uretprobe:lv_block", mode="table"),
             p.t.attach(tp, "uretprobe:lv_block", mode="table"))
    assert p.t.live.host["vec"][lk_h[1].slot] == 0
    assert p.t.live.host["vec"][lk_h2[1].slot] == 0
    assert p.t.live.host["vec"][lk_c[1].slot] == 1
    assert_host_equal(p.j.live, p.t.live)
    rows = make_tape()
    jm, tm = p.maps()
    jm, ja, tm, ta = p.stage(rows, jm, tm)
    assert_maps_equal(jm, tm)
    p.j.detach(lk_h2[0])
    p.t.detach(lk_h2[1])
    assert p.t.live.host["vec"][lk_h[1].slot] == 1
    assert_host_equal(p.j.live, p.t.live)


# ---------------------------------------------- plain interpreter vs JAX

def _run_program_case(text, tape):
    """run_program event by event and run_program_batched over the tape,
    port against JAX: r0, aux and the final maps. Returns the lanes run, or
    None when the verifier rejects the program."""
    try:
        jv, tv = _both_verified(text)
    except JVf.VerifierError:
        return None
    jrows = jnp.asarray([[JI.s64(JI.u64(w)) for w in r] for r in tape],
                        jnp.int64)
    trows = torch.tensor([[U.s64(int(w)) for w in r] for r in tape],
                         dtype=torch.int64)
    jm = JM.init_states(JF.FUZZ_SPECS, jnp)
    tm = TM.init_states(FUZZ_T, CPU)
    for i in range(len(tape)):
        jr0, jm, ja = JT.run_program(jv, jrows[i], jm,
                                     JJ.make_aux(**JF._aux_kw(i)))
        tr0, tm, ta = TT.run_program(tv, trows[i], tm,
                                     TJ.make_aux(device=CPU,
                                                 **JF._aux_kw(i)))
        assert int(tr0) == int(jr0)
        assert_aux_equal(ja, ta)
    names = [s.name for s in JF.FUZZ_SPECS]
    assert_maps_equal(jm, tm, names)
    lanes = ["table"]
    if JT.batched_encodable(jv):
        jr0, jm = JT.run_program_batched(
            jv, jrows, JM.init_states(JF.FUZZ_SPECS, jnp),
            JJ.make_aux(**JF._aux_kw(0)))
        tr0, tm = TT.run_program_batched(
            tv, trows, TM.init_states(FUZZ_T, CPU),
            TJ.make_aux(device=CPU, **JF._aux_kw(0)))
        np.testing.assert_array_equal(tr0.numpy(), np.asarray(jr0))
        assert_maps_equal(jm, tm, names)
        lanes.append("batched")
    return lanes


@pytest.mark.parametrize("path", CORPUS, ids=[os.path.basename(p)
                                              for p in CORPUS])
def test_run_program_matches_jax_on_corpus(path):
    with open(path) as fh:
        d = json.load(fh)
    lanes = _run_program_case(d["text"], d["tape"])
    assert lanes is not None
    assert ("batched" in lanes) == ("batched" in d["lanes"])


@pytest.mark.parametrize("block", range(5))
def test_run_program_matches_jax_on_fuzz_seeds(block):
    """Seeds 0-49 of the grammar fuzzer, ten per case."""
    ran = 0
    for seed in range(10 * block, 10 * block + 10):
        case = JF.generate_case(seed)
        ran += _run_program_case(case.text, case.tape) is not None
    assert ran >= 5


def test_long_loop_fuel_matches_jax():
    """The fuel scaled by the longest block: 30,000 iterations of a 3-insn
    loop body complete, as in the scan lane and in JAX."""
    text = LOOP_SUM.replace("stxdw [r10-8], r7", "mov r8, r7\n    and r8, "
                            "63\n    stxdw [r10-8], r8")
    jrt, trt = JRuntime(), TRuntime()
    jrt.create_map(_jspec(SPECS[0]))
    trt.create_map(_tspec(SPECS[0]))
    jv = jrt.progs[jrt.load_asm("long", text, [_jspec(SPECS[0])])].vprog
    tv = trt.progs[trt.load_asm("long", text, [_tspec(SPECS[0])])].vprog
    ctx = np.zeros(16, np.int64)
    ctx[2] = 30_000
    jr0, jm, _ = JT.run_program(jv, jnp.asarray(ctx),
                                JM.init_states(jv.map_specs, jnp),
                                JJ.make_aux())
    tr0, tm, _ = TT.run_program(tv, torch.as_tensor(ctx),
                                TM.init_states(tv.map_specs, CPU),
                                TJ.make_aux(device=CPU))
    assert int(tr0) == int(jr0) == 0
    assert_maps_equal(jm, tm, ["lv_counts"])
    assert int(tm["lv_counts"]["values"][30_000 & 63]) == 30_000


def test_isa_traps_program_matches_jax():
    """The kernel cases' ISA-traps program (unsigned and by-zero DIV/MOD,
    shift masking, ALU32 zero-extension, unaligned sub-word stack access,
    jmp32 and unsigned compares, a short ringbuf record) event by event
    through the port's and JAX's table interpreters."""
    trt, tv = IC.traps_program()
    jrt = JRuntime()
    spec = _jspec(IC.TRAPS_MAP)
    jv = jrt.progs[jrt.load_asm("ic_traps", IC.TRAPS, [spec])].vprog
    rows = IC.traps_tape(40, 1)
    jm = JM.init_states([spec], jnp)
    tm = trt.init_device_maps(CPU)
    for i in range(rows.shape[0]):
        jr0, jm, _ = JT.run_program(jv, jnp.asarray(rows[i]), jm,
                                    JJ.make_aux(**IC.AUX))
        tr0, tm, _ = TT.run_program(tv, torch.as_tensor(rows[i]), tm,
                                    TJ.make_aux(device=CPU, **IC.AUX))
        assert int(tr0) == int(jr0), i
    assert_maps_equal(jm, tm, ["ic_trap_rb"])
    assert int(tm["ic_trap_rb"]["dropped"][0]) > 0


def _jax_live(programs, max_programs):
    """A JAX runtime with `programs` (interp_cases' format) on its live
    table, set up as `interp_cases._runtime` sets up the port's, and its
    interpreter over a tape, jitted once."""
    jrt = JRuntime()
    for _, _, spec, *_ in programs:
        if spec is not None:
            jrt.create_map(_jspec(spec))
    for spec in IC.MISC_MAPS:
        jrt.create_map(_jspec(spec))
    jrt.enable_live_attach(max_programs=max_programs, max_insns=64,
                           arm=("uprobe:ic_block", "uretprobe:ic_block",
                                "probe:ic_logits"))
    for name, text, spec, target, vec, fuel in programs:
        maps = IC.MISC_MAPS if spec is None else [spec]
        lk = jrt.attach(jrt.load_asm(name, text, [_jspec(m) for m in maps]),
                        target, mode="table", promote=False)
        if vec is not None:
            jrt.live.host["vec"][lk.slot] = vec
        if fuel is not None:
            jrt.live.host["fuel"][lk.slot] = fuel
    run = jax.jit(lambda t, r, m: jrt.live.run(t, r, m,
                                               JJ.make_aux(**IC.AUX)))
    return jrt, run


def _run_both(jrt, run, trt, rows):
    """(JAX maps, JAX aux, port maps, port aux) of both live tables over
    one tape, from zeroed maps."""
    jm = jrt.init_device_maps()
    tm = trt.init_device_maps(CPU)
    jm, ja = run(jm.pop("__live_table__"), jnp.asarray(jax_sites(rows)), jm)
    tm, ta = trt.live.run(tm.pop("__live_table__"), torch.as_tensor(rows),
                          tm, TJ.make_aux(device=CPU, **IC.AUX))
    return jm, ja, tm, ta


@pytest.fixture(scope="module")
def mixed_pair():
    """The eight-slot table the kernel is held to, on the port and on JAX
    (its interpreter jitted once)."""
    trt, _ = IC.mixed_runtime()
    jrt, run = _jax_live(IC.MIXED, 8)
    return jrt, trt, run


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_live_table_run_matches_jax_on_mixed_table(mixed_pair, seed):
    """The eight-slot table (both sub-lanes, every helper, full HASH maps,
    a lapping ringbuf, fuel cut short) through LiveTable.run, against
    JAX's on the same table and tape."""
    jrt, trt, run = mixed_pair
    assert_host_equal(jrt.live, trt.live)
    assert set(trt.live.host["vec"]) == {0, 1}
    jm, ja, tm, ta = _run_both(jrt, run, trt, IC.mixed_tape(240, seed))
    assert_maps_equal(jm, tm, list(jm))
    assert_aux_equal(ja, ta)
    assert int(tm["ic_rb"]["dropped"][0]) > 0


@pytest.mark.parametrize("big", [False, True], ids=["shared", "global"])
@pytest.mark.parametrize("events", [49, 600])
def test_live_table_run_matches_jax_on_branching_hash_vec(big, events):
    """interp_cases' BRANCH table: a HASH fetch-add behind a data-dependent
    loop forced onto the vec sub-lane (its lanes reach HASH at different
    machine steps, so the inserts go in (step, lane) order and the full
    16-slot map shows it), beside a sequential program and a vec counter;
    with `big` the counter's map puts the universe past the kernel's
    shared memory. The port's plain lane against JAX's on tapes below and
    above the kernel's 512 threads."""
    from repro_torch.kernels import table_interp as TI
    trt, _ = IC.branch_runtime(big)
    jrt, run = _jax_live(IC.branch_programs(big), 4)
    assert_host_equal(jrt.live, trt.live)
    assert trt.live.host["vec"].tolist() == [0, 1, 1, 0]
    assert TI.plan(trt.live.spec_key, 4, 64, events, 16)["maps"] == \
        ("global" if big else "shared")
    jm, ja, tm, ta = _run_both(jrt, run, trt, IC.mixed_tape(events, events))
    assert_maps_equal(jm, tm, list(jm))
    assert_aux_equal(ja, ta)
    assert int(tm["ic_bh"]["used"].sum()) == 16


# ------------------------------------------------- kernel-mode baseline

def test_callback_probe_host_maps_match_jax():
    """The host round trip over one tape: the same host maps as the JAX
    package's io_callback baseline."""
    rows = make_tape()
    p = Pair(live=False)
    for name, tgt in (("count", "uprobe:lv_block"),
                      ("hash", "uprobe:lv_block"),
                      ("rb", "uretprobe:lv_block")):
        p.attach(name, tgt, mode="fused")
    n = TCB.host_probe_stage(p.t, torch.as_tensor(rows), 3)
    tok = jax.jit(lambda r, s: JCB.host_probe_stage(p.j, r, s))(
        jnp.asarray(jax_sites(rows)), jnp.int64(3))
    assert n == int(tok) == rows.shape[0]
    for name in p.j.host_maps:
        for f in p.j.host_maps[name]:
            np.testing.assert_array_equal(p.t.host_maps[name][f],
                                          p.j.host_maps[name][f],
                                          err_msg=f"{name}.{f}")
    assert p.t.host_maps["lv_counts"]["values"].sum() > 0


# ------------------------------------------------- ring-buffer apply

@pytest.mark.parametrize("head,batch,cap", [(0, 10, 8), (6, 5, 8),
                                            (7, 40, 8), (30, 3, 8),
                                            (5, 0, 8), (0, 64, 64)])
def test_ringbuf_apply_dropped_matches_jax(head, batch, cap):
    """The port's one-launch apply (its plain version here) against the
    JAX apply's rank formula: laps from any head, more rows than cap, an
    empty batch."""
    rng = np.random.default_rng(head * 100 + batch)
    jspec = JM.MapSpec("rb", JM.MapKind.RINGBUF, cap, rec_width=3)
    tspec = TM.MapSpec("rb", TM.MapKind.RINGBUF, cap, rec_width=3)
    st = {"data": rng.integers(-9, 9, (cap, 3)), "head": np.array([head]),
          "dropped": np.array([4])}
    rows = rng.integers(-(1 << 62), 1 << 62, (batch, 3))
    ok = rng.random(batch) < 0.8
    jms, _ = JV._apply_site(SimpleNamespace(map_specs=[jspec]),
                            "ringbuf_output", (0,), (jnp.asarray(ok),
                                                     jnp.asarray(rows)),
                            {"rb": {k: jnp.asarray(v) for k, v in st.items()}},
                            JJ.make_aux())
    tms, _ = TV._apply_site(SimpleNamespace(map_specs=[tspec]),
                            "ringbuf_output", (0,), (torch.as_tensor(ok),
                                                     torch.as_tensor(rows)),
                            {"rb": {k: torch.as_tensor(v)
                                    for k, v in st.items()}},
                            TJ.make_aux(device=CPU))
    for f in ("data", "head", "dropped"):
        np.testing.assert_array_equal(tms["rb"][f].numpy(),
                                      np.asarray(jms["rb"][f]), err_msg=f)
    d, h, dr = TREF.ringbuf_emit_batch(*[torch.as_tensor(a) for a in (
        st["data"], st["head"], st["dropped"], rows.reshape(batch, 3), ok)])
    assert torch.equal(dr, tms["rb"]["dropped"])


def test_ringbuf_two_sites_corpus_through_the_port():
    """tests/corpus/ringbuf_two_sites.json through the port's scan and
    table lanes against the numpy oracle VM."""
    from repro.core import vm as JVM
    with open(os.path.join(ROOT, "tests", "corpus",
                           "ringbuf_two_sites.json")) as fh:
        d = json.load(fh)
    a = JA.assemble(d["text"])
    np_maps = JM.init_states(JF.FUZZ_SPECS, np)
    for i, row in enumerate(d["tape"]):
        JVM.run(a.insns, JVM.pack_ctx(row), JF.FUZZ_SPECS, np_maps,
                JVM.Aux(**JF._aux_kw(i)))
    _, tv = _both_verified(d["text"])
    rows = torch.tensor([[U.s64(int(w)) for w in r] for r in d["tape"]],
                        dtype=torch.int64)
    prog = TJ.compile_program(tv)
    scan = TM.init_states(FUZZ_T, CPU)
    table = TM.init_states(FUZZ_T, CPU)
    for i in range(rows.shape[0]):
        aux = TJ.make_aux(device=CPU, **JF._aux_kw(i))
        _, scan, _ = prog(rows[i:i + 1], scan, aux)
        _, table, _ = TT.run_program(tv, rows[i], table, aux)
    for st in (scan, table):
        got = to_numpy(st)
        for f, arr in np_maps["rb"].items():
            np.testing.assert_array_equal(got["rb"][f], arr, err_msg=f)
    assert np_maps["rb"]["head"][0] > 0
