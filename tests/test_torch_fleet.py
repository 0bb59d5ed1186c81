"""The port's fleet worker against the JAX package's fleet plane, on the
CPU: the shm region's files, a torch worker's published maps read by the
JAX side (ShmRegion.attach and the daemon's aggregation) bit for bit
against a JAX worker's and the flat oracle of test_shm_merge_differential,
a mixed fleet of a torch and a JAX worker, seeded worker-side faults on a
torch publish that the JAX daemon detects and converges past, torn-read
freedom under a port writer process's republish storm, control-queue
attach and detach on the port's running training loop and serving engine
(queued with the JAX daemon), the status document, and the port's
artifact cache (the counterparts of test_artifact_cache.py's table-image
tests, and the same image key and arrays as JAX's)."""
import contextlib
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import waiters  # noqa: E402
from repro.core import (daemon as D, loader as JLd, maps as JM,  # noqa: E402
                        shm as JSH)
from repro.core.artifact_cache import ArtifactCache as JCache  # noqa: E402
from repro.core.runtime import BpftimeRuntime as JRuntime  # noqa: E402

from repro_torch.core import (faults as TF, maps as TM, shm as TSH,  # noqa: E402,E501
                              table_interp as TT)
from repro_torch.core.artifact_cache import ArtifactCache  # noqa: E402
from repro_torch.core.runtime import BpftimeRuntime as TRuntime, to_numpy  # noqa: E402,E501

from test_faults import _fast_cfg  # noqa: E402
from test_shm_merge_differential import (SPECS, apply_event,  # noqa: E402
                                         assert_global_matches_oracle,
                                         gen_tape, oracle_states)
from test_torch_live import (CPU, COUNT_BY_LAYER, SPEC_OF, Pair,  # noqa: E402,E501
                             _jspec, _tspec, make_tape)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T_SPECS = [TM.MapSpec(s.name, TM.MapKind(s.kind.value), s.max_entries,
                      rec_width=s.rec_width, num_shards=s.num_shards,
                      flags=dict(s.flags)) for s in SPECS]


def _assert_state_equal(got: dict, want: dict, what: str):
    assert set(got) == set(want), what
    for f in want:
        assert got[f].dtype == np.asarray(want[f]).dtype, f"{what}.{f}"
        np.testing.assert_array_equal(got[f], np.asarray(want[f]),
                                      err_msg=f"{what}.{f}")


# ------------------------------------------------------------ region layout

def _files(root):
    out = {}
    for d, _, fns in os.walk(root):
        for fn in fns:
            rel = os.path.relpath(os.path.join(d, fn), root)
            if fn.endswith(".npy"):
                a = np.load(os.path.join(d, fn), mmap_mode="r")
                out[rel] = (a.dtype.str, a.shape)
            else:
                out[rel] = None
    return out


@pytest.mark.parametrize("worker_id", [None, "w0"])
def test_region_files_match_jax(tmp_path, worker_id):
    JSH.ShmRegion.create(str(tmp_path / "j"), SPECS, worker_id=worker_id)
    TSH.ShmRegion.create(str(tmp_path / "t"), T_SPECS, worker_id=worker_id)
    jf, tf = _files(tmp_path / "j"), _files(tmp_path / "t")
    assert tf == jf
    with open(tmp_path / "j" / "meta.json") as a, \
            open(tmp_path / "t" / "meta.json") as b:
        assert a.read() == b.read()


# ------------------------------------------- a torch worker read by JAX

def _fleet_pair(root):
    """A JAX worker (j0) and a torch worker (t0) in one region, the same
    four programs attached on the fused lane of each."""
    p = Pair(live=False)
    for name, tgt in (("count", "uprobe:lv_block"), ("hash", "uprobe:lv_block"),
                      ("hist", "uretprobe:lv_block"), ("rb", "uprobe:lv_block")):
        p.attach(name, tgt, mode="fused")
    p.j.setup_shm(root, worker_id="j0")
    p.t.setup_shm(root, worker_id="t0")
    return p


def test_torch_worker_region_read_by_jax_bit_identical(tmp_path):
    """The same programs over the same tapes: the JAX side reads the torch
    worker's snapshots bit for bit as the JAX worker's and as the port's
    own maps, and the daemon folds both into the flat oracle (one scan
    runtime over every tape of both workers)."""
    root = str(tmp_path / "shm")
    p = _fleet_pair(root)
    jm, tm = p.maps()
    tapes = [make_tape(n, seed) for n, seed in ((48, 1), (30, 2), (61, 3))]
    for rows in tapes:
        jm, _, tm, _ = p.stage(rows, jm, tm)
        p.j.publish(jm)
        p.t.publish(tm)
    want = to_numpy(tm)
    jt = JSH.ShmRegion.attach(root, mode="r", worker_id="t0")
    jj = JSH.ShmRegion.attach(root, mode="r", worker_id="j0")
    for name in SPEC_OF:
        st, seq, _ = jt.snapshot_device_meta(name)
        assert seq % 2 == 0 and seq > 0
        _assert_state_equal(st, want[name], f"t0 {name}")
        _assert_state_equal(st, jj.snapshot_device(name), f"t0/j0 {name}")
    assert int(want["lv_rb"]["head"][0]) > 0

    D.Aggregator(root).poll_once()
    g = JSH.GlobalView.attach(root)
    oracle = Pair(live=False)
    for name, tgt in (("count", "uprobe:lv_block"), ("hash", "uprobe:lv_block"),
                      ("hist", "uretprobe:lv_block")):
        oracle.attach(name, tgt, mode="fused")
    om, _ = oracle.maps()
    for rows in tapes + tapes:
        om, _, _, _ = oracle.stage(rows, om, oracle.t.init_device_maps(CPU),
                                   mode="scan")
    om = jax.tree.map(np.asarray, om)
    _assert_state_equal(g.snapshot("lv_counts"), om["lv_counts"], "global")
    _assert_state_equal(g.snapshot("lv_hist"), om["lv_hist"], "global")
    spec = _jspec(SPEC_OF["lv_hash"])
    _assert_state_equal(g.snapshot("lv_hash"), JM.n_hash_canonical(
        spec, JM.n_hash_items(om["lv_hash"])), "global")


def _apply_t(states: dict, ev: tuple, step: int) -> None:
    """test_shm_merge_differential.apply_event on the port's numpy twins."""
    op = ev[0]
    if op == "arr_add":
        TM.n_array_fetch_add(states["arr"], ev[1], ev[2])
    elif op == "pc_add":
        shard, idx, delta = ev[1:]
        if 0 <= idx < states["pc"]["values"].shape[1]:
            states["pc"]["values"][shard, idx] += delta
    elif op == "hist":
        TM.n_hist_add(states["hist"], ev[1])
    elif op == "hash_add":
        TM.n_hash_fetch_add(states["hsh"], ev[1], ev[2])
    elif op == "hash_set":
        TM.n_hash_update(states["hsh"], ev[1], ev[2])
    elif op == "hash_del":
        TM.n_hash_delete(states["hsh"], ev[1])
    else:
        assert op == "rb", op
        TM.n_ringbuf_emit(states["rb"], [step, ev[1], ev[2]])


def _run_fleet(root, tape, n_workers, jax_workers=(), rounds=3,
               config=None, plan=None):
    """test_shm_merge_differential.run_fleet with torch workers (the
    port's region and numpy twins) except those in `jax_workers`; under
    `plan` (the port's FaultPlan) a torch publish may be abandoned, and is
    not retried within the round. Ends with a clean republish and two
    polls."""
    regions, states, apply = {}, {}, {}
    for w in range(n_workers):
        if w in jax_workers:
            regions[w] = JSH.ShmRegion.create(root, SPECS, worker_id=f"w{w}")
            states[w] = JM.init_states(SPECS, np)
            apply[w] = apply_event
        else:
            regions[w] = TSH.ShmRegion.create(root, T_SPECS,
                                              worker_id=f"w{w}")
            states[w] = TM.init_states_np(T_SPECS)
            apply[w] = _apply_t
    per_worker = {w: [t for t in tape if t[1] == w] for w in range(n_workers)}
    chunks = {w: np.array_split(np.arange(len(per_worker[w])), rounds)
              for w in range(n_workers)}
    agg = D.Aggregator(root, config=config)
    with TF.plan(plan) if plan is not None else contextlib.nullcontext():
        for r in range(rounds):
            for w in range(n_workers):
                for i in chunks[w][r]:
                    step, _, _, ev = per_worker[w][i]
                    apply[w](states[w], ev, step)
                try:
                    regions[w].publish_device(states[w])
                except TF.TornPublish:
                    pass              # abandoned publish: seqlock stays odd
            agg.poll_once()
    for w in range(n_workers):
        regions[w].publish_device(states[w])
    agg.poll_once()
    return agg, agg.poll_once()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_mixed_fleet_torch_and_jax_worker_matches_oracle(tmp_path, seed):
    root = str(tmp_path / "shm")
    tape = gen_tape(np.random.default_rng(seed), 2, n_events=80)
    _run_fleet(root, tape, 2, jax_workers=(1,))
    assert_global_matches_oracle(root, oracle_states(tape))


@pytest.mark.parametrize("kind,rate,seed", [
    ("torn_publish", 0.6, 0), ("torn_publish", 0.6, 1),
    ("stuck_odd", 0.5, 0), ("stuck_odd", 0.5, 1),
    ("corrupt_snapshot", 0.7, 0), ("corrupt_snapshot", 0.7, 1)])
def test_torch_worker_faults_detected_and_converge(tmp_path, kind, rate,
                                                   seed):
    """test_faults.py's worker-side classes, fired by the port's FaultPlan
    on the port's publish: the JAX daemon skips the torn, stuck or corrupt
    sections and converges to the oracle."""
    root = str(tmp_path / "shm")
    tape = gen_tape(np.random.default_rng(20 + seed), 2, n_events=60)
    plan = TF.FaultPlan(seed=seed, rates={kind: rate})
    agg, status = _run_fleet(root, tape, 2, rounds=4, config=_fast_cfg(),
                             plan=plan)
    assert plan.counters[kind] >= 1
    if kind == "corrupt_snapshot":
        assert sum(agg.corrupt_skipped.values()) >= 1
        assert status["corrupt_skipped"] == agg.corrupt_skipped
    assert_global_matches_oracle(root, oracle_states(tape))


_WRITER = """
import os, sys, time
import numpy as np
from repro_torch.core import maps as M, shm as SH
root, stop, pause = sys.argv[1], sys.argv[2], float(sys.argv[3])
specs = [M.MapSpec("arr", M.MapKind.ARRAY, max_entries=64),
         M.MapSpec("hist", M.MapKind.LOG2HIST)]
region = SH.ShmRegion.create(root, specs, worker_id="w0")
st = M.init_states_np(specs)
i = 0
while not os.path.exists(stop):
    i += 1
    st["arr"]["values"][:] = i
    st["hist"]["bins"][:] = 3 * i + 1
    region.publish_device(st)
    if pause:
        time.sleep(pause)
"""


def _storm(tmp_path, pause: float, n_reads: int, budget: int) -> int:
    """A port writer process republishes (pausing `pause` s between
    publishes) while the JAX region reads `n_reads` snapshots of each map:
    no torn read, counters only move forward. Returns the most retries one
    read took."""
    root, stop = str(tmp_path / "shm"), str(tmp_path / "stop")
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    p = subprocess.Popen([sys.executable, "-c", _WRITER, root, stop,
                          repr(pause)], env=env)
    try:
        waiters.wait_for(lambda: "w0" in JSH.list_workers(root),
                         msg="worker dir")
        region = JSH.ShmRegion.attach(root, mode="r", worker_id="w0")
        waiters.wait_for(lambda: int(region.seq[0]) > 2,
                         msg="first publishes")
        last, max_retries = {"arr": 0, "hist": 0}, 0
        for _ in range(n_reads):
            for name, field in (("arr", "values"), ("hist", "bins")):
                st, seq, retries = region.snapshot_device_meta(
                    name, retries=budget)
                assert seq % 2 == 0, f"torn read surfaced: odd seq {seq}"
                vals = st[field]
                assert (vals == vals.flat[0]).all(), \
                    f"torn read surfaced: mixed {name} snapshot {vals}"
                assert int(vals.flat[0]) >= last[name]
                last[name] = int(vals.flat[0])
                max_retries = max(max_retries, retries)
        assert last["arr"] > 0, "never observed a publish"
    finally:
        with open(stop, "w") as f:
            f.write("stop")
        p.wait(timeout=60)
    assert p.returncode == 0
    return max_retries


def test_no_torn_reads_of_a_port_writer_under_republish_storm(tmp_path):
    """test_shm_torn_reads.py's storm with the port as the writer process
    (it imports only repro_torch) and the JAX region as the reader. The
    writer pauses 50 us between publishes (thousands a second): unpaced,
    its even window can be shorter than one read on a loaded CPU, and the
    reader can starve. The unpaced storm is the slow test below."""
    _storm(tmp_path, 5e-5, n_reads=100, budget=2000)


@pytest.mark.slow
def test_no_torn_reads_of_a_port_writer_unpaced(tmp_path):
    """The storm at test_shm_torn_reads.py's rate: the port writer
    republishes with no pause, and the reads' retries stay well inside the
    budget, as that test asks of the JAX writer."""
    budget = 2000
    assert _storm(tmp_path, 0.0, n_reads=200, budget=budget) < budget // 4


# ------------------------------------------- control queue on a running step

ARR = ("lt_counts", "array", 64, 4, 1)


def test_run_training_applies_daemon_live_inject(tmp_path):
    """test_table_interp.py's case on the port: a request queued with the
    JAX daemon's request_load_attach lands on the port's running
    run_training and its step is never rebuilt; the region reads as the
    final maps."""
    from repro_torch.launch.train import run_training
    rt = TRuntime()
    rt.create_map(_tspec(ARR))
    rt.enable_live_attach(max_programs=2, max_insns=64,
                          arm=("probe:grad.norm",))
    epoch_at_step = {}
    prog = JLd.build_object(
        "inject", COUNT_BY_LAYER.replace("ctx:layer", "ctx:step").replace(
            "lv_counts", "lt_counts"), [_jspec(ARR)], "uprobe",
        attach_to="probe:grad.norm")
    shm = str(tmp_path / "shm")

    def on_step(s, state, metrics):
        epoch_at_step[s] = rt.attach_epoch
        if s == 2:      # a 'daemon' injects while training runs
            other = JSH.ShmRegion.attach(shm)
            D.request_load_attach(other, prog.to_json(), live=True,
                                  promote=False)

    state, hist = run_training(
        "qwen2-0.5b", steps=6, runtime=rt, shm_dir=shm, probe_mode="fused",
        seq_len=16, batch=2, log_every=0, on_step=on_step, device=CPU)
    counts = state["maps"]["lt_counts"]["values"].numpy()
    assert counts.sum() == 4, counts[:8]      # steps 3..6
    assert len(set(epoch_at_step.values())) == 1
    assert rt.live.host["gen"][0] == 1
    assert rt.shm.read_status()["live_slots"]["0"] == "inject"
    jr = JSH.ShmRegion.attach(shm, mode="r")
    _assert_state_equal(jr.snapshot_device("lt_counts"),
                        to_numpy(state["maps"])["lt_counts"], "region")


def test_train_cli_probes_region_read_by_jax_daemon(tmp_path, capfd):
    """The train CLI with --probes as shm worker w0, saving a checkpoint
    every step, on the CPU: the JAX daemon aggregates the region, and each
    map field it reads is bit for bit that field in the last checkpoint."""
    from repro_torch.ckpt import checkpoint as CK
    from repro_torch.launch import train as TLT
    shm, ck = str(tmp_path / "shm"), str(tmp_path / "ckpt")
    TLT.main(["--device", "cpu", "--steps", "2", "--batch", "2", "--seq",
              "16", "--probes", "--shm", shm, "--worker-id", "w0", "--ckpt",
              ck, "--save-every", "1"])
    assert "final loss" in capfd.readouterr().out
    step_dir = os.path.join(ck, f"step_{CK.latest(ck)}")
    with open(os.path.join(step_dir, "tree.json")) as f:
        names = json.load(f)["names"]
    region = JSH.ShmRegion.attach(shm, mode="r", worker_id="w0")
    assert sorted(s.name for s in region.specs) == sorted(
        spec[0] for _, _, spec, _, _ in TLT.TRAIN_PROBES if spec is not None)
    for spec in region.specs:
        st, seq, _ = region.snapshot_device_meta(spec.name)
        assert seq % 2 == 0 and seq > 0
        for f, a in st.items():
            i = names.index(f"maps/{spec.name}/{f}")
            _assert_state_equal({f: a}, {f: np.load(os.path.join(
                step_dir, f"{i}.npy"))}, spec.name)
    assert region.snapshot_device("tr_layer_counts")["values"].sum() > 0
    assert D.Aggregator(shm).poll_once()["alive"] == ["w0"]
    g = JSH.GlobalView.attach(shm)
    _assert_state_equal(g.snapshot("tr_layer_counts"), region.snapshot_device(
        "tr_layer_counts"), "global")


def test_serve_engine_applies_daemon_attach_and_detach(tmp_path):
    """ServeEngine(shm_dir=..., worker_id=...) on the CPU at smoke width: a
    load_attach queued by the JAX daemon runs on the running decode step
    from the next iteration, a queued detach stops it, status.json shows
    the program in live_slots and then without it, and the region reads as
    the engine's maps after every step."""
    from repro_torch.configs import registry as TCFG
    from repro_torch.launch import serve as TL
    from repro_torch.models import registry as TMR
    from repro_torch.serve.engine import ServeEngine
    cfg = TCFG.smoke("qwen2-0.5b")
    params = TMR.init_params(cfg, torch.Generator().manual_seed(0), CPU)
    rt = TRuntime()
    TL.attach_serve_probes(rt)
    TL.load_live_probes(rt)
    rt.enable_live_attach(arm=TL.LIVE_ARM)
    shm = str(tmp_path / "shm")
    eng = ServeEngine(params, cfg, slots=2, max_seq=64, runtime=rt,
                      shm_dir=shm, worker_id="w0", device=CPU)
    decode = eng._decode
    name, text, (mname, kind, n, w), target = TL.LIVE_PROBES[0]
    obj = JLd.build_object(name, text, [JM.MapSpec(
        mname, JM.MapKind(kind), n, rec_width=w)], "uprobe",
        attach_to=target)
    other = JSH.ShmRegion.attach(shm, worker_id="w0")
    reqs = TL.make_requests(6, 3, cfg.vocab_size)
    eng.submit_all(reqs[:2])
    steps0 = eng.step_count
    assert int(eng.maps[mname]["values"].sum()) == 0
    D.request_load_attach(other, obj.to_json(), mode="table", promote=False)
    eng.submit_all(reqs[2:4])
    steps1 = eng.step_count
    status = other.read_status()
    assert status["live_slots"]["0"] == name
    (lid,) = [k for k, v in status["promotions"].items()
              if v == {"lane": "table", "state": "interp"}]
    assert status["links"][lid] == target
    counted = int(eng.maps[mname]["values"].sum())
    assert counted == (steps1 - steps0) * cfg.num_layers
    D.request_detach(other, int(lid))
    eng.submit_all(reqs[4:])
    assert eng._decode is decode
    assert other.read_status()["live_slots"]["0"] is None
    assert lid not in other.read_status()["links"]
    # the first iteration of the last call applied the detach
    assert int(eng.maps[mname]["values"].sum()) == counted
    want = to_numpy(eng.maps)
    jr = JSH.ShmRegion.attach(shm, mode="r", worker_id="w0")
    for m in want:
        _assert_state_equal(jr.snapshot_device(m), want[m], m)


def test_status_json_has_jax_keys(tmp_path):
    p = Pair()
    p.j.setup_shm(str(tmp_path / "j"), worker_id="w0")
    p.t.setup_shm(str(tmp_path / "t"), worker_id="w0")
    p.attach("count", "uprobe:lv_block", mode="table", promote=False)
    js, ts = p.j.shm.read_status(), p.t.shm.read_status()
    assert set(ts) == set(js)
    for k in ("worker_id", "attach_epoch", "live_gen", "live_slots",
              "links", "promotions"):
        assert ts[k] == js[k], k
    # the port also counts steps it could not export (aot_step)
    assert set(ts["cache"]) == set(js["cache"]) | {"unexportable"}
    assert ts["cache"]["stores"] == js["cache"]["stores"] == 1


def test_bad_request_is_reported_not_raised(tmp_path):
    rt = TRuntime()
    rt.setup_shm(str(tmp_path))
    rt.shm.request({"op": "detach", "link_id": 99})
    (got,) = rt.poll_control()
    assert got["op"] == "detach" and "error" in got
    assert rt.poll_control() == []               # consumed once


# ---------------------------------------------------------- artifact cache

class _Double(torch.nn.Module):
    def forward(self, x):
        return x * 2 + 1


def test_bytes_round_trip_and_counters(tmp_path):
    c = ArtifactCache(str(tmp_path))
    assert c.get_bytes("k1") is None
    assert c.counters["misses"] == 1
    c.put_bytes("k1", b"payload", "table")
    assert c.get_bytes("k1") == b"payload"
    assert c.get_bytes("k1", kind="step") is None     # kind mismatch drops
    table = {"hits": 1, "misses": 1, "stores": 1, "corrupt": 1, "purged": 0,
             "evicted": 0, "unexportable": 0}
    assert c.counters == table
    assert c.get_bytes("k1") is None
    table["misses"] += 1
    # an exported step round-trips beside the table entries: one store and
    # one hit of its own, the other counters unchanged
    ep = torch.export.export(_Double(), (torch.arange(4),))
    assert c.put_step("s1", ep)
    got = c.get_step("s1")
    assert torch.equal(got(torch.arange(4)), torch.arange(4) * 2 + 1)
    assert c.counters == {**table, "stores": 2, "hits": 2}
    assert [r["kind"] for r in c.ls()] == ["step"]


def test_table_image_round_trip(tmp_path):
    c = ArtifactCache(str(tmp_path))
    arrays = {"op": np.arange(12, dtype=np.int32),
              "imm": np.ones((3, 4), np.int64)}
    c.put_table("t", arrays)
    out = c.get_table("t")
    assert set(out) == {"op", "imm"}
    assert np.array_equal(out["op"], arrays["op"])
    assert np.array_equal(out["imm"], arrays["imm"])
    # the JAX package's cache reads the port's entry and the port JAX's
    assert np.array_equal(JCache(str(tmp_path)).get_table("t")["imm"],
                          arrays["imm"])
    JCache(str(tmp_path)).put_table("u", arrays)
    assert np.array_equal(c.get_table("u")["op"], arrays["op"])


def test_purge(tmp_path):
    c = ArtifactCache(str(tmp_path))
    c.put_bytes("a", b"1", "table")
    c.put_bytes("b", b"2", "table")
    assert c.purge("a") == 1
    assert c.get_bytes("b") == b"2"
    assert c.purge() == 1
    assert c.stats()["entries"] == 0
    assert c.counters["purged"] == 2


def test_lru_eviction_respects_budget(tmp_path):
    c = ArtifactCache(str(tmp_path), max_bytes=256)
    c.put_bytes("a", b"x" * 100, "table")
    c.put_bytes("b", b"y" * 100, "table")
    assert c.counters["evicted"] == 0
    os.utime(c._bin("a"), (1, 1))                     # make "a" the LRU
    c.put_bytes("c", b"z" * 100, "table")
    assert c.counters["evicted"] == 1
    assert c.get_bytes("a") is None
    assert c.get_bytes("b") == b"y" * 100
    assert c.get_bytes("c") == b"z" * 100
    assert c.stats()["bytes"] <= 256
    assert c.stats()["max_bytes"] == 256


def test_eviction_hit_refreshes_recency(tmp_path):
    c = ArtifactCache(str(tmp_path), max_bytes=256)
    c.put_bytes("a", b"x" * 100, "table")
    c.put_bytes("b", b"y" * 100, "table")
    os.utime(c._bin("a"), (1, 1))
    os.utime(c._bin("b"), (2, 2))
    assert c.get_bytes("a") == b"x" * 100             # refresh "a"
    c.put_bytes("c", b"z" * 100, "table")
    assert c.get_bytes("a") is not None
    assert c.get_bytes("b") is None


def test_eviction_never_removes_just_written_entry(tmp_path):
    c = ArtifactCache(str(tmp_path), max_bytes=64)
    c.put_bytes("big", b"x" * 1000, "table")
    assert c.get_bytes("big") == b"x" * 1000
    c.put_bytes("big2", b"y" * 1000, "table")         # evicts "big" only
    assert c.get_bytes("big") is None
    assert c.get_bytes("big2") == b"y" * 1000


def test_no_budget_no_eviction(tmp_path):
    c = ArtifactCache(str(tmp_path))
    for i in range(8):
        c.put_bytes(f"k{i}", b"x" * 512, "table")
    assert c.counters["evicted"] == 0
    assert c.stats()["entries"] == 8
    assert c.stats()["max_bytes"] is None


def test_manual_corruption_detected_and_dropped(tmp_path):
    c = ArtifactCache(str(tmp_path))
    c.put_bytes("k", b"x" * 64, "table")
    with open(c._bin("k"), "r+b") as f:
        f.seek(10)
        f.write(b"\xff")
    assert c.get_bytes("k") is None
    assert c.counters["corrupt"] == 1
    assert not os.path.exists(c._bin("k"))
    c.put_bytes("k", b"y" * 64, "table")
    assert c.get_bytes("k") == b"y" * 64


def test_fault_plan_corrupts_artifact_and_cache_degrades(tmp_path):
    c = ArtifactCache(str(tmp_path))
    arrays = {"op": np.arange(64, dtype=np.int64)}
    with TF.plan(TF.FaultPlan(seed=0,
                              rates={"corrupt_artifact": 1.0})) as p:
        c.put_table("k", arrays)
        assert p.counters["corrupt_artifact"] == 1
    assert c.get_table("k") is None
    assert c.counters["corrupt"] == 1
    assert c.counters["hits"] == 0
    c.put_table("k", arrays)
    assert np.array_equal(c.get_table("k")["op"], arrays["op"])


@pytest.mark.parametrize("prog", ["count", "hash", "hist", "loop", "rb"])
def test_table_image_shared_with_jax_through_the_cache(tmp_path, prog):
    """One program: the same image key and table arrays in both packages;
    a JAX worker's encode_slot stores the image and the port's, on the
    same cache directory, takes it as a hit and writes the same slot."""
    p = Pair()
    jp, tp = p.load(prog)
    jv, tv = p.j.progs[jp].vprog, p.t.progs[tp].vprog
    key = TT.LiveTable.image_key(tv)
    from repro.core.table_interp import LiveTable as JLive
    assert key == JLive.image_key(jv)
    jc, tc = JCache(str(tmp_path)), ArtifactCache(str(tmp_path))
    p.j.live.encode_slot(1, jv, 3, 1, pid=jp, cache=jc)
    assert jc.counters["stores"] == 1
    p.t.live.encode_slot(1, tv, 3, 1, pid=tp, cache=tc)
    assert tc.counters["hits"] == 1 and tc.counters["stores"] == 0
    for f in p.j.live.host:
        np.testing.assert_array_equal(p.t.live.host[f], p.j.live.host[f],
                                      err_msg=f)
    img = tc.get_table(key)
    for f in TT.TABLE_FIELDS:
        np.testing.assert_array_equal(img[f], p.t.live.host[f][1, :len(
            tv.insns)], err_msg=f)


def test_setup_shm_joins_the_cache_and_reuses_images(tmp_path):
    """setup_shm joins <root>/cache: a second worker's table attach of the
    same program reuses the first worker's image."""
    root = str(tmp_path)
    ws = []
    for wid in ("w0", "w1"):
        p = Pair()
        p.t.setup_shm(root, worker_id=wid)
        p.t.attach(p.load("count")[1], "uprobe:lv_block", mode="table")
        ws.append(p.t.artifact_cache.counters)
    assert ws[0]["stores"] == 1 and ws[0]["hits"] == 0
    assert ws[1]["stores"] == 0 and ws[1]["hits"] == 1
    assert os.path.isdir(os.path.join(root, "cache"))
