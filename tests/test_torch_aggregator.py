"""The port's fleet aggregator (repro_torch.core.daemon and the fleet half of
repro_torch.core.maps) against the JAX package's, on the CPU: every
fleet-half numpy twin bit for bit JAX's on seeded inputs; the torch fold
twins (t_hash_coalesce, t_group_summary_fold*) against the jnp and numpy
twins at the edges (empty, duplicate and zero-sum keys, i64 wrap); the
port's flat daemon and the JAX daemon over the same worker regions (torch,
JAX and mixed fleets) against the flat oracle of
test_shm_merge_differential, with the same status.json keys and counters
and the same fold journal; the seeded fault drills of test_faults.py on
a torch fleet; each package resuming from the other's journal; and the
bpftool-style CLI printing the same from both entry points."""
import contextlib
import dataclasses
import io
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core import daemon as JD, maps as JM, shm as JSH  # noqa: E402

from repro_torch.core import (daemon as TD, faults as TF, loader as TLd,  # noqa: E402,E501
                              maps as TM, shm as TSH)

from test_faults import _fast_cfg  # noqa: E402
from test_shm_merge_differential import (SPECS, _mark_worker_dead,  # noqa: E402,E501
                                         apply_event,
                                         assert_global_matches_oracle,
                                         gen_tape, oracle_states)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
T_SPECS = [TM.MapSpec(s.name, TM.MapKind(s.kind.value), s.max_entries,
                      rec_width=s.rec_width, num_shards=s.num_shards,
                      flags=dict(s.flags)) for s in SPECS]
SPEC_OF = {s.name: s for s in SPECS}
T_SPEC_OF = {s.name: s for s in T_SPECS}
# status.json fields that must agree between the two daemons ("time" and
# "health" transitions aside, which hold wall time / are compared whole)
STATUS_COUNTERS = ("alive", "dead", "stale", "cycles", "merged_updates",
                   "hash_dropped", "rb_heads", "rb_lost", "corrupt_skipped",
                   "coalesced_cycles", "stragglers", "hb_dead", "health",
                   "nodes", "stream_lost", "node_coalesced", "hash_shards",
                   "shard_publishes")


def port_cfg(cfg=None, **kw):
    """The port's AggregatorConfig with the fields of a JAX one."""
    base = dataclasses.asdict(cfg) if cfg is not None else {}
    return TD.AggregatorConfig(**{**base, **kw})


def mirror(root: str, twin: str) -> str:
    """A second root over the SAME worker regions (meta.json, progs/ and
    workers/ are links to root's) with a global view, journal and node
    registry of its own, so two daemons fold the same files."""
    os.makedirs(twin)
    for name in ("meta.json", "progs", "workers"):
        os.symlink(os.path.join(root, name), os.path.join(twin, name))
    return twin


class Fleet:
    """n worker regions in one root, written by the port's ShmRegion
    ("torch"), the JAX package's ("jax") or alternately ("mixed", torch
    first); each worker applies its share of a gen_tape tape to numpy maps
    and publishes cumulative snapshots."""

    def __init__(self, root: str, n: int, kind: str = "torch",
                 width: int = 1):
        self.root, self.n = root, n
        self.wids = [f"w{w:0{width}d}" for w in range(n)]
        self.regions = {}
        for w in range(n):
            k = kind if kind != "mixed" else ("torch", "jax")[w % 2]
            mod, specs = (TSH, T_SPECS) if k == "torch" else (JSH, SPECS)
            self.regions[w] = mod.ShmRegion.create(root, specs,
                                                   worker_id=self.wids[w])
        self.states = {w: JM.init_states(SPECS, np) for w in range(n)}

    def publish(self, w: int) -> None:
        self.regions[w].publish_device(self.states[w])

    def play(self, tape, rounds: int, polls=(), on_publish=None):
        """Apply the tape in `rounds` publish chunks per worker, calling
        every poll after each round."""
        per = {w: [t for t in tape if t[1] == w] for w in range(self.n)}
        chunks = {w: np.array_split(np.arange(len(per[w])), rounds)
                  for w in range(self.n)}
        for r in range(rounds):
            for w in range(self.n):
                for i in chunks[w][r]:
                    step, _, _, ev = per[w][i]
                    apply_event(self.states[w], ev, step)
                if on_publish is None:
                    self.publish(w)
                else:
                    on_publish(w)
            for poll in polls:
                poll()


def views(root: str) -> dict:
    g = TSH.GlobalView.attach(root)
    return {s.name: g.snapshot(s.name) for s in T_SPECS}


def assert_views_equal(a: dict, b: dict, what: str) -> None:
    assert set(a) == set(b), what
    for name in a:
        assert set(a[name]) == set(b[name]), f"{what} {name}"
        for f in a[name]:
            assert a[name][f].dtype == b[name][f].dtype, f"{what} {name}.{f}"
            np.testing.assert_array_equal(a[name][f], b[name][f],
                                          err_msg=f"{what} {name}.{f}")


def assert_status_alike(t_status: dict, j_status: dict) -> None:
    assert set(t_status) == set(j_status)
    for k in STATUS_COUNTERS:
        assert t_status[k] == j_status[k], k


def read_json(path: str) -> dict:
    with open(path) as fh:
        return json.load(fh)


# ------------------------------------------------------ fleet-half twins

def _random_table(rng, spec, n_ops: int) -> dict:
    """A HASH table after seeded inserts, adds and deletes (tombstones,
    broken chains), built by the JAX numpy twins."""
    st = JM.init_state(spec, np)
    for _ in range(n_ops):
        k = int(rng.integers(-3, 3 * spec.max_entries))
        op = rng.integers(3)
        if op == 0:
            JM.n_hash_update(st, k, int(rng.integers(-50, 50)))
        elif op == 1:
            JM.n_hash_fetch_add(st, k, int(rng.integers(-9, 9)))
        else:
            JM.n_hash_delete(st, k)
    return st


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_fleet_half_numpy_twins_match_jax(seed):
    rng = np.random.default_rng(seed)
    big = np.int64(1 << 62)
    # summary kinds: delta and in-place merge, wrapping near +-2^63
    for sp in SPECS:
        if not JM.is_summary_kind(sp.kind):
            continue
        assert TM.SUMMARY_FIELDS[T_SPEC_OF[sp.name].kind] == \
            JM.SUMMARY_FIELDS[sp.kind]
        shape = JM.init_state(sp, np)[JM.SUMMARY_FIELDS[sp.kind][0]].shape
        cur = {f: rng.integers(-big, big, shape) * 2
               for f in JM.SUMMARY_FIELDS[sp.kind]}
        base = {f: rng.integers(-big, big, shape) * 2 for f in cur}
        with np.errstate(over="ignore"):
            jd = JM.n_summary_delta(sp, cur, base)
            td = TM.n_summary_delta(T_SPEC_OF[sp.name], cur, base)
            ja = {f: a.copy() for f, a in base.items()}
            ta = {f: a.copy() for f, a in base.items()}
            JM.n_summary_merge(sp, ja, jd)
            TM.n_summary_merge(T_SPEC_OF[sp.name], ta, td)
        tdd = TM.t_summary_delta(T_SPEC_OF[sp.name], cur, base, device="cpu")
        tm = TM.t_summary_merge(T_SPEC_OF[sp.name], base, tdd, device="cpu")
        for f in cur:
            np.testing.assert_array_equal(td[f], jd[f])
            np.testing.assert_array_equal(ta[f], ja[f])
            np.testing.assert_array_equal(tdd[f].numpy(), jd[f])
            np.testing.assert_array_equal(tm[f].numpy(), ja[f])
    # hash: content, canonical layout, deltas (dict and array forms),
    # sharding
    for n in (8, 16):
        sp = JM.MapSpec("h", JM.MapKind.HASH, max_entries=n)
        tsp = TM.MapSpec("h", TM.MapKind.HASH, max_entries=n)
        cur, base = _random_table(rng, sp, 40), _random_table(rng, sp, 40)
        for st in (cur, base):
            jk, jv = JM.n_hash_content(st)
            tk, tv = TM.n_hash_content(st)
            np.testing.assert_array_equal(tk, jk)
            np.testing.assert_array_equal(tv, jv)
            assert dict(zip(tk.tolist(), tv.tolist())) == TM.n_hash_items(st)
            items = JM.n_hash_items(st)
            for f, a in JM.n_hash_canonical(sp, items).items():
                np.testing.assert_array_equal(
                    TM.n_hash_canonical(tsp, items)[f], a)
        ci, bi = JM.n_hash_items(cur), JM.n_hash_items(base)
        assert TM.n_hash_delta(ci, bi) == JM.n_hash_delta(ci, bi)
        args = (*JM.n_hash_content(cur), *JM.n_hash_content(base))
        for got, want in zip(TM.n_hash_delta_arrays(*args),
                             JM.n_hash_delta_arrays(*args)):
            np.testing.assert_array_equal(got, want)
        keys = rng.integers(-(1 << 63), (1 << 63) - 1, 50, dtype=np.int64)
        for shards in (1, 3, 4):
            np.testing.assert_array_equal(
                TM.n_shard_of_keys(keys, n, shards),
                JM.n_shard_of_keys(keys, n, shards))
            assert [TM.n_shard_of_key(int(k), n, shards) for k in keys] == \
                [JM.n_shard_of_key(int(k), n, shards) for k in keys]
    # ringbuf: tagged drain and the global interleave
    rb = SPEC_OF["rb"]
    tagged, total = [], 0
    for wid in ("w0", "w1", "w2"):
        st = JM.init_state(rb, np)
        for i in range(int(rng.integers(0, 15))):
            JM.n_ringbuf_emit(st, [int(rng.integers(0, 5)), i, seed])
        lo = int(rng.integers(0, 4))
        jt, jh = JM.n_ringbuf_tagged(st, wid, lo=lo, step_lane=0)
        tt, th = TM.n_ringbuf_tagged(st, wid, lo=lo, step_lane=0)
        assert th == jh and [t for t, _ in tt] == [t for t, _ in jt]
        for (_, a), (_, b) in zip(tt, jt):
            np.testing.assert_array_equal(a, b)
        tagged += jt
        total += jh
    want = JM.ringbuf_merge_global(rb, tagged, total)
    got = TM.ringbuf_merge_global(T_SPEC_OF["rb"], tagged, total)
    for f, a in want.items():
        np.testing.assert_array_equal(got[f], a)


I64_MAX, I64_MIN = (1 << 63) - 1, -(1 << 63)
COALESCE_CASES = {
    "empty": ([], []),
    "one": ([7], [0]),
    "duplicates": ([5, 3, 5, 5, 3, 9], [1, 2, 3, 4, 5, 6]),
    "zero_sum": ([4, 4, 2, 2, 8], [3, -3, 0, 0, -1]),
    "wrap": ([I64_MAX, I64_MAX, I64_MIN, -1, I64_MIN],
             [I64_MAX, 2, I64_MIN, I64_MIN, -1]),
    "random": None,
}


@pytest.mark.parametrize("case", sorted(COALESCE_CASES))
def test_hash_coalesce_twins(case):
    if COALESCE_CASES[case] is None:
        rng = np.random.default_rng(5)
        keys = rng.integers(-40, 40, 500).astype(np.int64)
        deltas = rng.integers(I64_MIN, I64_MAX, 500, dtype=np.int64)
    else:
        keys = np.array(COALESCE_CASES[case][0], np.int64)
        deltas = np.array(COALESCE_CASES[case][1], np.int64)
    wk, wd = JM.n_hash_coalesce(keys, deltas)
    for fn in (TM.n_hash_coalesce, JM.j_hash_coalesce,
               lambda k, d: TM.t_hash_coalesce(k, d, device="cpu")):
        gk, gd = fn(keys, deltas)
        assert gk.dtype == np.int64 and gd.dtype == np.int64
        np.testing.assert_array_equal(gk, wk)
        np.testing.assert_array_equal(gd, wd)
    if case == "zero_sum":
        assert 2 in wk.tolist() and 4 in wk.tolist()     # kept at sum 0


def _stacks(rng, ws, wrap: bool) -> dict:
    hi = (1 << 62) if wrap else 50
    out = {}
    for (name, shape), w in zip((("a", (16,)), ("p", (2, 8)),
                                 ("h", (64,))), ws):
        acc = rng.integers(-hi, hi, shape, dtype=np.int64) * (2 if wrap
                                                              else 1)
        cur = rng.integers(-hi, hi, (w, *shape), dtype=np.int64)
        base = rng.integers(-hi, hi, (w, *shape), dtype=np.int64)
        out[name] = {"values" if name != "h" else "bins": (acc, cur, base)}
    return out


@pytest.mark.parametrize("case", ["one_worker", "group", "wrap",
                                  "mixed_group_sizes", "empty"])
def test_group_summary_fold_twins(case):
    rng = np.random.default_rng(9)
    stacks = {"one_worker": lambda: _stacks(rng, (1, 1, 1), False),
              "group": lambda: _stacks(rng, (4, 4, 4), False),
              "wrap": lambda: _stacks(rng, (3, 3, 3), True),
              "mixed_group_sizes": lambda: _stacks(rng, (2, 5, 2), True),
              "empty": lambda: {}}[case]()
    with np.errstate(over="ignore"):
        want = JM.n_group_summary_fold_multi(stacks)
    got_t = TM.t_group_summary_fold_multi(stacks, device="cpu")
    got_j = JM.j_group_summary_fold_multi(stacks)
    with np.errstate(over="ignore"):
        got_n = TM.n_group_summary_fold_multi(stacks)
    for got in (got_t, got_j, got_n):
        assert set(got) == set(want)
        for n, d in want.items():
            assert set(got[n]) == set(d)
            for f, a in d.items():
                assert np.asarray(got[n][f]).shape == a.shape
                np.testing.assert_array_equal(np.asarray(got[n][f]), a)
    # the per-spec entry points agree with the multi form
    for name, spec in (("a", JM.MapSpec("a", JM.MapKind.ARRAY, 16)),
                       ("h", JM.MapSpec("h", JM.MapKind.LOG2HIST))):
        if name not in stacks:
            continue
        f = JM.SUMMARY_FIELDS[spec.kind][0]
        acc, cur, base = stacks[name][f]
        tsp = TM.MapSpec(spec.name, TM.MapKind(spec.kind.value),
                         spec.max_entries)
        with np.errstate(over="ignore"):
            np.testing.assert_array_equal(
                TM.n_group_summary_fold(tsp, {f: acc}, {f: cur},
                                        {f: base})[f], want[name][f])
        np.testing.assert_array_equal(
            TM.t_group_summary_fold(tsp, {f: acc}, {f: cur}, {f: base},
                                    device="cpu")[f], want[name][f])
        np.testing.assert_array_equal(
            JM.j_group_summary_fold(spec, {f: acc}, {f: cur}, {f: base})[f],
            want[name][f])


def test_fold_twins_ask_for_the_card_by_default(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    k = np.array([1, 2], np.int64)
    with pytest.raises(RuntimeError, match="CUDA"):
        TM.t_hash_coalesce(k, k)
    with pytest.raises(RuntimeError, match="CUDA"):
        TM.t_group_summary_fold_multi(_stacks(np.random.default_rng(0),
                                              (1, 1, 1), False))


# ---------------------------------------------- the flat daemon vs JAX's

def run_both(tmp_path, tape, n, kind="torch", rounds=3, cfg=None):
    """The same regions folded by the port's daemon (root) and the JAX
    daemon (its mirror), polled after every publish round and twice
    after the last. Returns (root, twin, port agg, JAX agg)."""
    cfg = cfg or JD.AggregatorConfig()
    root = str(tmp_path / "t")
    fleet = Fleet(root, n, kind)
    twin = mirror(root, str(tmp_path / "j"))
    ta = TD.Aggregator(root, config=port_cfg(cfg))
    ja = JD.Aggregator(twin, config=dataclasses.replace(cfg))
    fleet.play(tape, rounds, polls=(ta.poll_once, ja.poll_once))
    for _ in range(2):
        ta.poll_once()
        ja.poll_once()
    return root, twin, ta, ja


def assert_same_fold(root, twin, tape):
    assert_global_matches_oracle(root, oracle_states(tape))
    assert_global_matches_oracle(twin, oracle_states(tape))
    assert_views_equal(views(root), views(twin), "port vs JAX view")
    assert_status_alike(read_json(os.path.join(root, "global",
                                               "status.json")),
                        read_json(os.path.join(twin, "global",
                                               "status.json")))
    # the fold journal is the same document, byte for byte once parsed
    assert read_json(os.path.join(root, "global", "journal.json")) == \
        read_json(os.path.join(twin, "global", "journal.json"))


@pytest.mark.parametrize("n_workers", [1, 2, 3])
@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_flat_daemon_matches_jax_and_oracle(tmp_path, n_workers, seed):
    """test_random_tape_all_kinds's scenarios on a torch fleet."""
    tape = gen_tape(np.random.default_rng(seed), n_workers, n_events=80)
    root, twin, _, _ = run_both(tmp_path, tape, n_workers)
    assert_same_fold(root, twin, tape)


@pytest.mark.parametrize("kind,n_workers,seed", [
    ("mixed", 2, 4), ("mixed", 3, 5), ("jax", 2, 6), ("jax", 3, 7)])
def test_flat_daemon_mixed_and_jax_fleets(tmp_path, kind, n_workers, seed):
    """Torch and JAX workers in one fleet (and a JAX-only one), with
    sharded hash views: the same global and shard views from both."""
    tape = gen_tape(np.random.default_rng(seed), n_workers, n_events=90)
    root, twin, ta, ja = run_both(tmp_path, tape, n_workers, kind,
                                  cfg=JD.AggregatorConfig(hash_shards=3))
    assert_same_fold(root, twin, tape)
    ts, js = TSH.HashShards.attach(root), JSH.HashShards.attach(twin)
    for s in range(3):
        got, _, _ = ts.snapshot("hsh", s)
        want, _, _ = js.snapshot("hsh", s)
        for f in want:
            np.testing.assert_array_equal(got[f], want[f])
    assert ta.shard_publishes == ja.shard_publishes > 0


# ------------------------------------------------------------ fault drills

def chaos_fleet(root, tape, n, plan, rounds=4, cfg=None):
    """test_faults._chaos_fleet on a torch fleet with the port's daemon and
    the port's fault plane: publishes hit by torn_publish/stuck_odd are
    abandoned, a daemon crash restarts the Aggregator from its journal,
    and a clean round ends it."""
    cfg = port_cfg(cfg or _fast_cfg())
    fleet = Fleet(root, n)
    box = {"agg": TD.Aggregator(root, config=cfg), "restarts": 0}

    def publish(w):
        try:
            fleet.publish(w)
        except TF.TornPublish:
            pass                          # abandoned: the seqlock stays odd

    def poll():
        try:
            box["agg"].poll_once()
        except TF.InjectedCrash:
            box["agg"] = TD.Aggregator(root, config=cfg)
            box["restarts"] += 1
    with TF.plan(plan):
        fleet.play(tape, rounds, polls=(poll,), on_publish=publish)
    for w in range(n):
        fleet.publish(w)
    box["agg"].poll_once()
    return box["agg"], box["agg"].poll_once(), box["restarts"]


@pytest.mark.parametrize("fault,seed", [("torn_publish", 0),
                                        ("torn_publish", 1),
                                        ("stuck_odd", 0),
                                        ("corrupt_snapshot", 0),
                                        ("corrupt_snapshot", 1)])
def test_worker_fault_fires_and_converges(tmp_path, fault, seed):
    root = str(tmp_path / "shm")
    tape = gen_tape(np.random.default_rng(20 + seed), 2, n_events=60)
    plan = TF.FaultPlan(seed=seed, rates={fault: 0.6})
    agg, status, _ = chaos_fleet(root, tape, 2, plan)
    assert plan.counters[fault] >= 1
    if fault == "corrupt_snapshot":
        assert sum(agg.corrupt_skipped.values()) >= 1
        assert status["corrupt_skipped"] == agg.corrupt_skipped
    assert_global_matches_oracle(root, oracle_states(tape))


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_aggregator_crash_restart_bit_identical(tmp_path, seed):
    rng = np.random.default_rng(100 + seed)
    root = str(tmp_path / "shm")
    tape = gen_tape(rng, 3, n_events=80)
    plan = TF.FaultPlan(seed=seed, crash_at=int(rng.integers(1, 30)))
    _, _, restarts = chaos_fleet(root, tape, 3, plan, rounds=5)
    assert restarts == 1 and plan.counters["daemon_crash"] == 1
    assert_global_matches_oracle(root, oracle_states(tape))


def test_mixed_fault_matrix_converges(tmp_path):
    root = str(tmp_path / "shm")
    tape = gen_tape(np.random.default_rng(41), 3, n_events=90)
    plan = TF.FaultPlan(seed=1, crash_at=10,
                        rates={"torn_publish": 0.25, "stuck_odd": 0.15,
                               "corrupt_snapshot": 0.25,
                               "slow_worker": 0.1}, slow_s=0.0003)
    _, _, restarts = chaos_fleet(root, tape, 3, plan, rounds=5)
    assert restarts >= 1 and sum(plan.counters.values()) >= 2
    assert_global_matches_oracle(root, oracle_states(tape))


def test_dead_worker_harvested_and_restarted_worker_rebased(tmp_path):
    """A worker whose pid is gone is harvested once and retired (its
    contribution stays, it is listed dead in both daemons' status); a
    worker that reboots under the same id starts from a fresh baseline."""
    root = str(tmp_path / "t")
    fleet = Fleet(root, 3, "mixed")
    twin = mirror(root, str(tmp_path / "j"))
    ta, ja = TD.Aggregator(root), JD.Aggregator(twin)
    for w in range(3):
        fleet.states[w]["arr"]["values"][1] = 5 * (w + 1)
        fleet.publish(w)
    ta.poll_once()
    ja.poll_once()
    fleet.states[2]["arr"]["values"][1] += 100
    fleet.publish(2)
    _mark_worker_dead(root, "w2")
    # w0 reboots: a fresh boot id and zeroed maps under the same id
    fleet.regions[0] = TSH.ShmRegion.create(root, T_SPECS, worker_id="w0")
    fleet.states[0] = JM.init_states(SPECS, np)
    fleet.states[0]["arr"]["values"][1] = 2
    fleet.publish(0)
    for _ in range(2):
        st = ta.poll_once()
        js = ja.poll_once()
    assert "w2" in st["dead"] and "w2" not in st["alive"]
    assert st["health"]["w2"]["state"] == TD.DEAD
    assert int(views(root)["arr"]["values"][1]) == 5 + 10 + 115 + 2
    assert_views_equal(views(root), views(twin), "port vs JAX view")
    assert_status_alike(st, js)


# ------------------------------------------------- journals across packages

@pytest.mark.parametrize("first", ["jax", "port"])
def test_each_package_resumes_from_the_others_journal(tmp_path, first):
    """Two publish rounds folded by one package's daemon (journal on), then
    the other package's daemon is built on the same root, restores from
    that journal and folds the rest: the view is the oracle's and the
    cycle count continues."""
    root = str(tmp_path / "shm")
    tape = gen_tape(np.random.default_rng(12), 3, n_events=90)
    fleet = Fleet(root, 3, "mixed")
    make = {"jax": lambda: JD.Aggregator(root),
            "port": lambda: TD.Aggregator(root)}
    second = "port" if first == "jax" else "jax"
    box = {"agg": make[first]()}
    per = {w: [t for t in tape if t[1] == w] for w in range(3)}
    chunks = {w: np.array_split(np.arange(len(per[w])), 4) for w in range(3)}
    for r in range(4):
        if r == 2:
            cycles = box["agg"].cycles
            box["agg"] = make[second]()
            assert box["agg"].cycles == cycles
            assert set(box["agg"]._journal_workers) == set(fleet.wids)
        for w in range(3):
            for i in chunks[w][r]:
                step, _, _, ev = per[w][i]
                apply_event(fleet.states[w], ev, step)
            fleet.publish(w)
        box["agg"].poll_once()
    box["agg"].poll_once()
    assert box["agg"].cycles == 5
    assert_global_matches_oracle(root, oracle_states(tape))


# ------------------------------------------------------------------- CLI

def _cli(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def cli_root(tmp_path_factory):
    """A mixed fleet of four workers with a program published, folded by
    the port's tree (two nodes) with sharded hash views."""
    from repro_torch.core.treeagg import TreeAggregator
    root = str(tmp_path_factory.mktemp("cli") / "shm")
    fleet = Fleet(root, 4, "mixed")
    obj = TLd.build_object("count", "mov r0, 0\nexit", [], "uprobe",
                           attach_to="uprobe:block")
    fleet.regions[0].publish_program(obj.to_json(), "count")
    tape = gen_tape(np.random.default_rng(3), 4, n_events=120)
    tree = TreeAggregator(root, fan_in=2, depth=1,
                          config=TD.AggregatorConfig(device="cpu",
                                                     hash_shards=2))
    fleet.play(tape, 2, polls=(tree.poll_once,))
    tree.poll_once()
    return root


CLI_COMMANDS = {
    "map_dump_json": ["map", "dump", "--json"],
    "map_dump_text": ["map", "dump"],
    "map_top_hash": ["map", "top", "hsh", "-n", "5"],
    "map_top_json": ["map", "top", "arr", "--json"],
    "map_device": ["map", "dump", "pc", "--section", "device",
                   "--worker", "w1"],
    "map_shard": ["map", "dump", "hsh", "--shard", "1", "--json"],
    "fleet_health_json": ["fleet", "health", "--json"],
    "fleet_health": ["fleet", "health"],
    "prog_list": ["prog", "list"],
    "prog_list_json": ["prog", "list", "--json"],
    "prog_cache_stat": ["prog", "cache", "stat"],
    "node_ls": ["node", "ls"],
    "node_ls_json": ["node", "ls", "--json"],
}


@pytest.mark.parametrize("name", sorted(CLI_COMMANDS))
def test_cli_prints_the_same_from_both_packages(cli_root, name):
    argv = [cli_root] + CLI_COMMANDS[name]
    got = _cli(TD.main, argv)
    want = _cli(JD.main, argv)
    assert got == want
    assert got[0] == 0 and got[1]


def test_cli_map_dump_is_the_global_view(cli_root):
    _, out = _cli(TD.main, [cli_root, "map", "dump", "hsh", "--json"])
    (doc,) = json.loads(out)
    g = views(cli_root)["hsh"]
    for f in ("keys", "used", "values"):
        assert doc[f] == g[f].tolist()


def test_python_m_entry_points_print_the_same(cli_root):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    outs = [subprocess.run([sys.executable, "-m", mod, cli_root, "fleet",
                            "health", "--json"], env=env,
                           capture_output=True, text=True, timeout=120)
            for mod in ("repro_torch.core.daemon", "repro.core.daemon")]
    assert [o.returncode for o in outs] == [0, 0], outs[0].stderr
    assert outs[0].stdout == outs[1].stdout
    status = json.loads(outs[0].stdout)
    assert sorted(status["nodes"]) == ["n0_0", "n0_1"]
    assert {h["state"] for w, h in status["health"].items()
            if w.startswith("w")} == {TD.HEALTHY}


# ------------------------------------------------------ no card, no fold

def test_node_aggregator_asks_for_the_card_by_default(tmp_path,
                                                      monkeypatch):
    """With device_fold on (the default) a node aggregator's folds run on
    `device` ("cuda"): without a card building one raises before it
    registers anything; device_fold=False is the explicit numpy route."""
    from repro_torch.core.treeagg import NodeAggregator, TreeAggregator
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    root = str(tmp_path / "shm")
    Fleet(root, 2)
    with pytest.raises(RuntimeError, match="CUDA"):
        NodeAggregator(root, "n0", workers=["w0", "w1"])
    with pytest.raises(RuntimeError, match="CUDA"):
        TreeAggregator(root, fan_in=2)
    with pytest.raises(RuntimeError, match="CUDA"):
        TD.main([root, "agg", "--tree", "--once"])
    with pytest.raises(RuntimeError, match="CUDA"):
        TD.main([root, "node", "run", "n9", "--workers", "w0", "--once"])
    assert TSH.list_nodes(root) == []
    na = NodeAggregator(root, "n0", workers=["w0", "w1"],
                        config=TD.AggregatorConfig(device_fold=False))
    na.poll_once()
    assert TSH.list_nodes(root) == ["n0"]
