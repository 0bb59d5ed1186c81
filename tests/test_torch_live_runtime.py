"""The port's runtime live half against the JAX package's, on the CPU:
the runtime cases of test_table_interp.py and test_promotion.py that need
no shm (auto routing, the link handle, the shims, slot reuse and a full
table, rejects, loops and fuel, composition with the fused lane, armed
sites, promotion bit-identity across the swap, detach mid-promotion,
re-schedule), the training loop's promotion hook, and smoke-width serving
with a mid-serve table attach against the JAX engine. Helpers are
tests/test_torch_live.py's."""
import threading

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import events as JE, loader as JLd  # noqa: E402
from repro.core.runtime import BpftimeRuntime as JRuntime  # noqa: E402

from repro_torch.core import (events as TE, jit as TJ, loader as TLd,  # noqa: E402,E501
                              verifier as TVf)
from repro_torch.core.runtime import BpftimeRuntime as TRuntime  # noqa: E402

from test_torch_live import (CPU, COUNT_BY_LAYER, HIST_NUMEL, RB_RECORD,  # noqa: E402,E501
                             SPECS, SPEC_OF, Pair, _jspec, _tspec,
                             assert_aux_equal, assert_host_equal,
                             assert_maps_equal, make_tape)


# ----------------------------------------------------- runtime, table lane

def test_interp_lane_matches_scan_mode_and_jax():
    rows = make_tape()
    p = Pair()
    for name, tgt in (("count", "uprobe:lv_block"),
                      ("hash", "uprobe:lv_block"),
                      ("hist", "uretprobe:lv_block"),
                      ("rb", "uretprobe:lv_block")):
        lj, lt = p.attach(name, tgt, mode="table")
        assert lt.lane == "table" and lt.slot == lj.slot
    jm, tm = p.maps()
    jm, ja, tm, ta = p.stage(rows, jm, tm)
    assert_maps_equal(jm, tm)
    assert_aux_equal(ja, ta)
    scan = Pair(live=False)
    for name, tgt in (("count", "uprobe:lv_block"),
                      ("hash", "uprobe:lv_block"),
                      ("hist", "uretprobe:lv_block"),
                      ("rb", "uretprobe:lv_block")):
        scan.attach(name, tgt, mode="fused")
    sj, st = scan.maps()
    sj, _, st, _ = scan.stage(rows, sj, st, mode="scan")
    assert_maps_equal(sj, tm)


def test_attach_is_a_table_write_and_sync_is_gated():
    """attach(mode="table") changes no epoch and no step; the device table
    lags until sync_live_table, which pushes in place and only on a new
    generation."""
    rows = make_tape()
    p = Pair()
    jm, tm = p.maps()
    buf = tm["__live_table__"]["packed"]
    epoch = p.t.attach_epoch
    lj, lt = p.attach("count", "uprobe:lv_block", mode="table")
    assert p.t.attach_epoch == epoch
    # not synced yet: the step runs the old (empty) table
    tm1, _ = p.t.probe_stage(torch.as_tensor(rows), tm,
                             TJ.make_aux(device=CPU))
    assert int(tm1["lv_counts"]["values"].sum()) == 0
    assert p.t.sync_live_table(tm) is tm
    assert tm["__live_table__"]["packed"] is buf
    assert int(buf[-1]) == 1 == int(p.t.live.host["gen"][0])
    jm = p.j.sync_live_table(jm)
    jm, _, tm, _ = p.stage(rows, jm, tm)
    n_entry = int((rows[:, 1] == JE.KIND_ENTRY).sum())
    assert int(tm["lv_counts"]["values"].sum()) == n_entry
    assert_maps_equal(jm, tm)
    before = buf.clone()
    p.t.live.host["gen"][0] += 0        # no change: the sync is a no-op
    buf.fill_(-1)
    p.t.sync_live_table(tm)
    assert int(buf[0]) == -1
    p.t.sync_live_table(tm, force=True)
    assert torch.equal(buf, before)
    p.j.detach(lj)
    p.t.detach(lt)
    p.t.sync_live_table(tm)
    assert int(buf[-1]) == 2


def test_attach_auto_mode_routing_matches_jax():
    p = Pair()
    lj, lt = p.attach("count", "uprobe:lv_block")
    for lk in (lj, lt):
        assert lk.lane == "table" and lk.slot == 0
        assert lk.promotion_state == "interp" and lk.promote
    lj2, lt2 = p.attach("count", "uprobe:lv_elsewhere")
    assert lt2.lane == lj2.lane == "fused"
    assert lt2.promotion_state == "none"
    p.j.detach(lj2)
    p.t.detach(lt2)
    fill = [p.attach("count", "uprobe:lv_block", mode="table")
            for _ in range(3)]
    assert p.t.live.free_slot() is None
    lj3, lt3 = p.attach("count", "uprobe:lv_block")
    assert lt3.lane == lj3.lane == "fused"
    for fj, ft in fill:
        fj.detach()
        ft.detach()
    bare = Pair(live=False)
    assert bare.attach("count", "uprobe:lv_block")[1].lane == "fused"
    jp, tp = p.load("count")
    lkh = p.t.attach(tp, "tracepoint:sys_step_end:enter")
    assert lkh.lane == "host" and lkh.promotion_state == "none"
    with pytest.raises(ValueError, match="device target"):
        p.t.attach(tp, "filter:sys_step_end", mode="table")
    with pytest.raises(ValueError, match="bad attach mode"):
        p.t.attach(tp, "uprobe:lv_block", mode="eager")
    assert_host_equal(p.j.live, p.t.live)


def test_link_handle_roundtrips():
    p = Pair()
    _, lk = p.attach("count", "uprobe:lv_block", mode="table")
    assert int(lk) == lk.link_id and p.t.links[int(lk)] is lk
    lk.detach()
    assert int(lk) not in p.t.links and p.t.live.free_slot() == 0
    _, lk2 = p.attach("count", "uprobe:lv_block", mode="fused")
    p.t.detach(int(lk2))
    assert not p.t.device_attach


def test_deprecation_shims_still_work():
    p = Pair()
    _, tp = p.load("count")
    with pytest.warns(DeprecationWarning, match="attach_live"):
        lk = p.t.attach_live(tp, "uprobe:lv_block")
    assert lk.lane == "table" and not lk.promote
    assert p.t.live.host["active"][lk.slot] == 1
    with pytest.warns(DeprecationWarning, match="detach_live"):
        p.t.detach_live(int(lk))
    assert int(lk) not in p.t.links
    assert p.t.live.host["active"][0] == 0


def test_slot_reuse_and_full_table():
    p = Pair()
    links = [p.attach("count", "uprobe:lv_block", mode="table")
             for _ in range(4)]
    for rt in (p.j, p.t):
        with pytest.raises((JLd.LoadError, TLd.LoadError), match="full"):
            rt.attach(p.pids["count"][rt is p.t], "uprobe:lv_block",
                      mode="table")
    p.j.detach(links[1][0])
    p.t.detach(links[1][1])
    lj, lt = p.attach("count", "uprobe:lv_block", mode="table")
    assert lt.slot == lj.slot == 1
    assert_host_equal(p.j.live, p.t.live)


def test_table_attach_rejects_like_jax():
    """A map created after the lane was enabled, an oversized program, and
    no live lane at all: rejected, generation untouched."""
    p = Pair()
    late = ("lv_after", "array", 8, 4, 1)
    text = COUNT_BY_LAYER.replace("map:lv_counts", "map:lv_after")
    tp = p.t.load_asm("late", text, [_tspec(late)])
    with pytest.raises(TVf.VerifierError, match="created after"):
        p.t.attach(tp, "uprobe:lv_block", mode="table")
    assert p.t.live.host["gen"][0] == 0
    small = TRuntime()
    small.create_map(_tspec(SPECS[0]))
    small.enable_live_attach(max_programs=1, max_insns=8)
    tp = small.load_asm("count", COUNT_BY_LAYER, [_tspec(SPECS[0])])
    with pytest.raises(TVf.VerifierError, match="padded"):
        small.attach(tp, "uprobe:lv_block", mode="table")
    assert small.live.host["gen"][0] == 0
    bare = TRuntime()
    bare.create_map(_tspec(SPECS[0]))
    tp = bare.load_asm("count", COUNT_BY_LAYER, [_tspec(SPECS[0])])
    with pytest.raises(TLd.LoadError, match="enable_live_attach"):
        bare.attach(tp, "uprobe:lv_block", mode="table")


def test_loop_program_in_lane_matches_jax_and_scan():
    rows = make_tape(24)
    p = Pair(arm=("uprobe:lv_block",))
    p.attach("loop", "uprobe:lv_block", mode="table")
    assert p.t.progs[p.pids["loop"][1]].vprog.tier == "loop"
    jm, tm = p.maps()
    jm, _, tm, _ = p.stage(rows, jm, tm)
    assert_maps_equal(jm, tm)
    scan = Pair(live=False)
    scan.attach("loop", "uprobe:lv_block")
    sj, st = scan.maps()
    sj, _, st, _ = scan.stage(rows, sj, st, mode="scan")
    assert_maps_equal(sj, tm)


def test_live_lane_composes_with_fused_lane():
    rows = make_tape()
    p = Pair()
    p.attach("hist", "uretprobe:lv_block", mode="fused")
    p.attach("count", "uprobe:lv_block", mode="table")
    jm, tm = p.maps()
    jm, _, tm, _ = p.stage(rows, jm, tm)
    assert_maps_equal(jm, tm)
    n_entry = int((rows[:, 1] == JE.KIND_ENTRY).sum())
    assert int(tm["lv_counts"]["values"].sum()) == n_entry
    assert int(tm["lv_hist"]["bins"].sum()) == rows.shape[0] - n_entry


def test_armed_sites_collect_without_programs():
    p = Pair()
    assert (TE.SITES.get_or_create("lv_block"), TE.KIND_ENTRY) in \
        p.t.wanted_sites()
    assert (JE.SITES.get_or_create("lv_block"), JE.KIND_ENTRY) in \
        p.j.wanted_sites()
    with p.t.collector() as col:
        TE.probe_site("lv_block", torch.ones(4), kind=TE.KIND_ENTRY)
        rows = col.take_all_rows(torch.device(CPU))
    assert rows.shape[0] == 1
    with pytest.raises(ValueError, match="non-device"):
        p.t.arm_site("filter:sys_step_end")


def test_layout_fingerprint_matches_jax():
    """The same key as JAX's for the same world: registry, event width,
    table dims and an attach signature (site ids are numbered per process,
    so the signature is given explicitly); an attach changes the key."""
    p = Pair()
    assert p.t.layout_fingerprint() == p.j.layout_fingerprint()
    sig = (((5, 1), (1, 2)),)
    assert p.t.layout_fingerprint(attach_sig=sig, extra=("x",)) == \
        p.j.layout_fingerprint(attach_sig=sig, extra=("x",))
    before = p.t.layout_fingerprint()
    p.attach("hist", "uretprobe:lv_block", mode="fused")
    assert p.t.layout_fingerprint() != before


# ------------------------------------------------------------- promotion

def _stage_builder(rt):
    """A 'step' as a builder returns it: probe_stage over a tape."""
    def build():
        def step(rows, maps):
            return rt.probe_stage(rows, maps, TJ.make_aux(device=CPU))
        return step
    return build


def _scan_oracle(names_targets, tapes):
    scan = Pair(live=False)
    for name, tgt in names_targets:
        scan.attach(name, tgt, mode="fused")
    sj, st = scan.maps()
    for rows in tapes:
        sj, _, st, _ = scan.stage(rows, sj, st, mode="scan")
    return sj


def test_promotion_bit_identity_across_swap():
    """interp phase -> one generation boundary -> fused phase ends in the
    scan oracle's state; the promoted step is built once; the link's slot
    is freed; a second promotion of the same world is a cache hit."""
    rows1, rows2 = make_tape(seed=7), make_tape(seed=11)
    p = Pair()
    step = _stage_builder(p.t)()
    _, tm = p.maps()
    _, lk = p.attach("count", "uprobe:lv_block")           # auto -> table
    assert lk.lane == "table"
    tm = p.t.sync_live_table(tm)
    tm, _ = step(torch.as_tensor(rows1), tm)
    eng = p.t.enable_promotion(_stage_builder(p.t), (rows1, tm),
                               background=False)
    assert lk.promotion_state == "ready", lk.promotion_error
    assert lk.lane == "table"
    epoch0 = p.t.attach_epoch
    tm = p.t.sync_live_table(tm)                           # the boundary
    assert lk.lane == "fused" and lk.promotion_state == "fused"
    assert lk.slot is None and p.t.live.free_slot() == 0
    assert p.t.attach_epoch == epoch0 + 1
    assert int(tm["__live_table__"]["active"].sum()) == 0
    fused = p.t.take_promoted_step()
    assert fused is not None and p.t.take_promoted_step() is None
    tm, _ = fused(torch.as_tensor(rows2), tm)
    assert eng.compiles == 1
    oracle = _scan_oracle([("count", "uprobe:lv_block")], [rows1, rows2])
    assert_maps_equal(oracle, tm)
    p.t.detach(lk)
    lk2 = p.t.attach(p.pids["count"][1], "uprobe:lv_block", mode="table")
    eng.schedule(lk2)
    p.t.sync_live_table(tm)
    assert lk2.lane == "fused" and eng.compiles == 1


def test_detach_mid_promotion_cancels_cleanly():
    p = Pair()
    _, tm = p.maps()
    gate = threading.Event()

    def gated_builder():
        gate.wait(10)
        return _stage_builder(p.t)()

    eng = p.t.enable_promotion(gated_builder, (), background=True)
    _, lk = p.attach("count", "uprobe:lv_block", mode="table")
    assert lk.promotion_state == "compiling"
    epoch0 = p.t.attach_epoch
    p.t.detach(lk)
    assert lk.promotion_state == "cancelled"
    gate.set()
    eng.wait()
    assert eng.pending() == 0
    p.t.sync_live_table(tm)
    assert p.t.take_promoted_step() is None
    assert p.t.attach_epoch == epoch0
    assert not p.t.device_attach
    assert p.t.live.free_slot() == 0


def test_promotion_reschedules_when_world_moves():
    rows1, rows2 = make_tape(seed=3), make_tape(seed=5)
    p = Pair()
    step = _stage_builder(p.t)()
    _, tm = p.maps()
    eng = p.t.enable_promotion(_stage_builder(p.t), (), background=False)
    _, lk = p.attach("count", "uprobe:lv_block", mode="table")
    assert lk.promotion_state == "ready" and eng.compiles == 1
    p.attach("hist", "uretprobe:lv_block", mode="fused")
    tm = p.t.sync_live_table(tm)
    assert lk.lane == "table", "a stale build must not swap in"
    assert lk.promotion_state == "ready" and eng.compiles == 2
    tm, _ = step(torch.as_tensor(rows1), tm)
    tm = p.t.sync_live_table(tm)
    assert lk.lane == "fused" and lk.promotion_state == "fused"
    fused = p.t.take_promoted_step()
    tm, _ = fused(torch.as_tensor(rows2), tm)
    oracle = _scan_oracle([("count", "uprobe:lv_block"),
                           ("hist", "uretprobe:lv_block")], [rows1, rows2])
    assert_maps_equal(oracle, tm)


def test_promotion_failure_is_recorded():
    p = Pair()

    def broken():
        raise RuntimeError("no step")
    p.t.enable_promotion(broken, (), background=False)
    _, lk = p.attach("count", "uprobe:lv_block", mode="table")
    assert lk.promotion_state == "failed" and "no step" in \
        lk.promotion_error
    assert lk.lane == "table"


def test_run_training_arms_promotion():
    """launch/train.run_training hands its step builder to the promotion
    engine when the live lane is on, and a table link attached from
    on_step is promoted at the next boundary: every step counted once."""
    from repro_torch.launch import train as TLt
    rt = TRuntime()
    rt.create_map(_tspec(SPECS[0]))
    rt.enable_live_attach(max_programs=2, arm=("probe:grad.norm",))
    pid = rt.load_asm("inject", COUNT_BY_LAYER.replace("ctx:layer",
                                                       "ctx:step"),
                      [_tspec(SPECS[0])])
    seen = {}

    def on_step(s, state, metrics):
        seen[s] = rt.attach_epoch
        if s == 2:
            seen["link"] = rt.attach(pid, "probe:grad.norm", mode="table")
    state, _ = TLt.run_training("qwen2-0.5b", steps=5, runtime=rt,
                                probe_mode="fused", seq_len=16, batch=2,
                                log_every=0, on_step=on_step, device=CPU)
    assert rt._promoter is not None
    assert seen["link"].lane == "fused"
    assert int(state["maps"]["lv_counts"]["values"].sum()) == 3


# ------------------------------------------------------------- serving

def test_serving_with_a_mid_serve_table_attach_matches_jax():
    """Smoke-width serving on the CPU: three programs attached with
    mode="table" after the first requests, synced, and the rest served --
    the decode step object is unchanged and the maps equal JAX's engine
    driven the same way."""
    from repro.configs import registry as JCFG
    from repro.models import registry as JMR
    from repro.serve.engine import (Request as JRequest,
                                    ServeEngine as JEngine)
    from repro_torch.configs import registry as TCFG
    from repro_torch.launch import serve as TL
    from repro_torch.models import registry as TMR
    from repro_torch.serve.engine import ServeEngine as TEngine
    jcfg, tcfg = JCFG.smoke("qwen2-0.5b"), TCFG.smoke("qwen2-0.5b")
    jp = JMR.init_params(jax.random.PRNGKey(0), jcfg)
    tp = TMR.params_from_numpy(jax.tree.map(np.asarray, jp), CPU)
    arm = ("uprobe:block", "uretprobe:block", "probe:logits")
    progs = [("lv_count", COUNT_BY_LAYER, "lv_counts", "uprobe:block"),
             ("lv_rb", RB_RECORD, "lv_rb", "probe:logits"),
             ("lv_hist", HIST_NUMEL, "lv_hist", "uretprobe:block")]
    engines = []
    for J in (True, False):
        rt = JRuntime() if J else TRuntime()
        spec = _jspec if J else _tspec
        for s in SPECS:
            rt.create_map(spec(s))
        rt.enable_live_attach(arm=arm)
        reqs = TL.make_requests(6, 4, tcfg.vocab_size)
        if J:
            reqs = [JRequest(rid=r.rid, prompt=list(r.prompt),
                             max_new=r.max_new) for r in reqs]
            eng = JEngine(jp, jcfg, slots=2, max_seq=64, runtime=rt)
        else:
            eng = TEngine(tp, tcfg, slots=2, max_seq=64, runtime=rt,
                          device=CPU)
        decode = eng._decode
        eng.submit_all(reqs[:2])
        links = [rt.attach(rt.load_asm(n, text, [spec(SPEC_OF[m])]), tgt,
                           mode="table", promote=False)
                 for n, text, m, tgt in progs]
        assert [lk.lane for lk in links] == ["table"] * 3
        eng.maps = rt.sync_live_table(eng.maps)
        eng.submit_all(reqs[2:])
        assert eng._decode is decode
        engines.append((eng, reqs, rt))
    (je, jreqs, jrt), (te, treqs, trt) = engines
    assert [r.out for r in treqs] == [r.out for r in jreqs]
    assert [int(v) for v in trt.live.host["vec"][:3]] == [1, 0, 1]
    assert_maps_equal(je.maps, te.maps)
    assert int(te.maps["lv_rb"]["head"][0]) > 0
    assert int(te.maps["lv_counts"]["values"].sum()) > 0


def test_replay_of_a_step_runs_the_table_it_ran_after_a_sync():
    """sync_live_table writes the running step's table buffer in place, so
    the state a decode step started from holds a later table after a sync.
    The step records the generation it ran; replaying `last_tape` (its
    input state with that generation's table) through the table lane gives
    the step's own output maps."""
    from repro_torch.configs import registry as TCFG
    from repro_torch.launch import serve as TL
    from repro_torch.models import registry as TMR
    from repro_torch.serve.engine import ServeEngine as TEngine
    cfg = TCFG.smoke("qwen2-0.5b")
    rt = TRuntime()
    for s in SPECS:
        rt.create_map(_tspec(s))
    rt.enable_live_attach(arm=("uprobe:block", "uretprobe:block",
                               "probe:logits"))
    rt.attach(rt.load_asm("lv_count", COUNT_BY_LAYER,
                          [_tspec(SPEC_OF["lv_counts"])]), "uprobe:block",
              mode="table", promote=False)
    eng = TEngine(TMR.init_params(cfg, torch.Generator().manual_seed(0), CPU),
                  cfg, slots=1, max_seq=32, runtime=rt, device=CPU)
    eng.maps = rt.sync_live_table(eng.maps)
    eng.submit_all(TL.make_requests(1, 2, cfg.vocab_size))
    assert eng.step_count >= 1
    out = {m: {f: t.clone() for f, t in st.items()}
           for m, st in eng.maps.items() if m != "__live_table__"}
    ran = rt.table_generation
    rt.attach(rt.load_asm("lv_hist", HIST_NUMEL, [_tspec(SPEC_OF["lv_hist"])]),
              "uprobe:block", mode="table", promote=False)
    eng.maps = rt.sync_live_table(eng.maps)
    # the in-place write reached the state the step started from
    assert eng._decode.last[3] == ran < rt.table_generation == \
        int(eng._decode.last[1]["__live_table__"]["packed"][-1])
    rows, maps_in, step = eng.last_tape
    assert int(maps_in["__live_table__"]["packed"][-1]) == ran
    got, _ = rt.probe_stage(rows, maps_in, TJ.make_aux(time_ns=step,
                                                       device=CPU))
    assert int(out["lv_counts"]["values"].sum()) > 0
    for m in out:
        for f in out[m]:
            assert torch.equal(got[m][f], out[m][f]), f"{m}.{f}"
