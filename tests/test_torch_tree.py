"""The port's tree aggregation (repro_torch.core.treeagg) against the JAX
package's, on the CPU: test_tree_agg_differential's topologies folded with
the torch fold twins on the CPU and with the numpy twins, bit for bit the
flat oracle and the JAX tree over the same regions (torch and mixed
fleets), with the same node status and journals; the tree drills of
test_tree_faults.py on the port (a node crash mid-fold and in the
emit/commit window, a corrupt stream batch, a dead node's batches
harvested, a worker dying under its node); a port tree resuming from a
JAX tree's journals and the reverse. The folds on the card are held to
the CPU's in test_torch_cuda.py."""
import dataclasses
import os

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro.core import daemon as JD, shm as JSH  # noqa: E402
from repro.core.treeagg import TreeAggregator as JTree  # noqa: E402

from repro_torch.core import daemon as TD, faults as TF, shm as TSH  # noqa: E402,E501
from repro_torch.core.treeagg import (NodeAggregator, TreeAggregator,  # noqa: E402,E501
                                      plan_tree)

from test_faults import _fast_cfg  # noqa: E402
from test_shm_merge_differential import (_mark_worker_dead,  # noqa: E402
                                         assert_global_matches_oracle,
                                         gen_tape, oracle_states)
from test_torch_aggregator import (Fleet, assert_status_alike,  # noqa: E402
                                   assert_views_equal, mirror, port_cfg,
                                   read_json, views)
from test_tree_agg_differential import TOPOLOGIES, _mark_node_dead  # noqa: E402,E501


def tree_cfg(device_fold=True, **kw):
    return TD.AggregatorConfig(device_fold=device_fold, device="cpu", **kw)


def unbooted(journal: dict) -> dict:
    """A journal without its child nodes' boot ids (each node aggregator
    draws its own)."""
    return {**journal, "node_children": {
        nid: {k: v for k, v in nc.items() if k != "boot"}
        for nid, nc in journal["node_children"].items()}}


def run_trees(tmp_path, tape, n, fan_in, depth, kind="torch",
              device_fold=True, rounds=3):
    """The same regions folded by the port's tree (root) and the JAX tree
    (its mirror), one full tree cycle after every publish round and one
    after the last."""
    root = str(tmp_path / "t")
    fleet = Fleet(root, n, kind, width=2)
    twin = mirror(root, str(tmp_path / "j"))
    tt = TreeAggregator(root, fan_in=fan_in, depth=depth,
                        config=tree_cfg(device_fold), worker_ids=fleet.wids)
    jt = JTree(twin, fan_in=fan_in, depth=depth,
               config=JD.AggregatorConfig(device_fold=device_fold),
               worker_ids=fleet.wids)
    fleet.play(tape, rounds, polls=(tt.poll_once, jt.poll_once))
    tt.poll_once()
    jt.poll_once()
    return root, twin, tt, jt


@pytest.mark.parametrize("fold", ["device", "numpy"])
@pytest.mark.parametrize("n_workers,fan_in,depth,seed", TOPOLOGIES[:4])
def test_tree_matches_flat_oracle_and_jax(tmp_path, n_workers, fan_in, depth,
                                          seed, fold):
    tape = gen_tape(np.random.default_rng(seed), n_workers,
                    n_events=max(150, 8 * n_workers))
    root, twin, tt, jt = run_trees(tmp_path, tape, n_workers, fan_in, depth,
                                   device_fold=fold == "device")
    assert_global_matches_oracle(root, oracle_states(tape))
    assert_views_equal(views(root), views(twin), "port vs JAX tree")
    assert_status_alike(read_json(os.path.join(root, "global",
                                               "status.json")),
                        read_json(os.path.join(twin, "global",
                                               "status.json")))
    assert [na.node_id for na in tt.node_aggs] == \
        [na.node_id for na in jt.node_aggs]
    for tn, jn in zip(tt.node_aggs, jt.node_aggs):
        base = TSH.node_base(root, tn.node_id)
        jbase = JSH.node_base(twin, jn.node_id)
        assert unbooted(read_json(os.path.join(base, "journal.json"))) == \
            unbooted(read_json(os.path.join(jbase, "journal.json")))
        assert tn.stream.head() == jn.stream.head() > 0


@pytest.mark.parametrize("fold", ["device", "numpy"])
def test_tree_over_a_mixed_fleet(tmp_path, fold):
    tape = gen_tape(np.random.default_rng(21), 6, n_events=180)
    root, twin, _, _ = run_trees(tmp_path, tape, 6, 3, 1, kind="mixed",
                                 device_fold=fold == "device")
    assert_global_matches_oracle(root, oracle_states(tape))
    assert_views_equal(views(root), views(twin), "port vs JAX tree")


def test_tree_matches_flat_daemon(tmp_path):
    """The tree and the flat Aggregator(device_fold=False) over the same
    regions publish the same view."""
    tape = gen_tape(np.random.default_rng(31), 8, n_events=200)
    root = str(tmp_path / "t")
    fleet = Fleet(root, 8, width=2)
    flat = mirror(root, str(tmp_path / "f"))
    tree = TreeAggregator(root, fan_in=4, depth=1, config=tree_cfg())
    agg = TD.Aggregator(flat, config=TD.AggregatorConfig(device_fold=False))
    fleet.play(tape, 3, polls=(tree.poll_once, agg.poll_once))
    tree.poll_once()
    agg.poll_once()
    assert_views_equal(views(root), views(flat), "tree vs flat")
    assert_global_matches_oracle(root, oracle_states(tape))


def test_plan_tree_is_jax_plan():
    from repro.core.treeagg import plan_tree as jplan
    for nw, fi, dp in [(4, 2, 1), (32, 8, 2), (7, 3, 3), (2, 2, 3),
                       (64, 8, 1)]:
        wids = [f"w{i:03d}" for i in range(nw)]
        assert plan_tree(wids, fan_in=fi, depth=dp) == \
            jplan(wids, fan_in=fi, depth=dp)


# ------------------------------------------------------------ tree drills

def chaos_tree(root, tape, n, plan, fan_in=2, depth=1, rounds=5):
    """test_tree_faults._chaos_tree on the port: a crash anywhere in the
    tree rebuilds the whole tree from its journals and streams."""
    cfg = port_cfg(_fast_cfg(), device="cpu")
    fleet = Fleet(root, n)

    def make():
        return TreeAggregator(root, fan_in=fan_in, depth=depth,
                              config=dataclasses.replace(cfg),
                              worker_ids=fleet.wids)
    box = {"tree": make(), "restarts": 0}

    def publish(w):
        try:
            fleet.publish(w)
        except TF.TornPublish:
            pass

    def poll():
        try:
            box["tree"].poll_once()
        except TF.InjectedCrash:
            box["tree"] = make()
            box["restarts"] += 1
    with TF.plan(plan):
        fleet.play(tape, rounds, polls=(poll,), on_publish=publish)
    for w in range(n):
        fleet.publish(w)
    box["tree"].poll_once()
    return box["tree"], box["tree"].poll_once(), box["restarts"]


@pytest.mark.parametrize("seed", [0, 1])
def test_node_crash_mid_fold_converges(tmp_path, seed):
    root = str(tmp_path / "shm")
    rng = np.random.default_rng(200 + seed)
    tape = gen_tape(rng, 4, n_events=80)
    plan = TF.FaultPlan(seed=seed, crash_at=int(rng.integers(1, 25)),
                        crash_who="n0_0")
    _, _, restarts = chaos_tree(root, tape, 4, plan)
    assert restarts == 1 and plan.counters["daemon_crash"] == 1
    assert_global_matches_oracle(root, oracle_states(tape))


@pytest.mark.parametrize("occurrence", [1, 2])
def test_node_crash_in_emit_commit_window_converges(tmp_path, occurrence):
    root = str(tmp_path / "shm")
    tape = gen_tape(np.random.default_rng(300 + occurrence), 4, n_events=80)
    plan = TF.FaultPlan(seed=occurrence, node_crash_at=occurrence)
    _, _, restarts = chaos_tree(root, tape, 4, plan)
    assert restarts == 1 and plan.counters["node_crash"] == 1
    assert_global_matches_oracle(root, oracle_states(tape))


def test_torn_and_corrupt_publishes_under_a_tree(tmp_path):
    root = str(tmp_path / "shm")
    tape = gen_tape(np.random.default_rng(51), 4, n_events=100)
    plan = TF.FaultPlan(seed=5, rates={"torn_publish": 0.05,
                                       "corrupt_snapshot": 0.5})
    tree, status, _ = chaos_tree(root, tape, 4, plan)
    assert plan.counters["torn_publish"] >= 1
    assert plan.counters["corrupt_snapshot"] >= 1
    assert sum(status["corrupt_skipped"].values()) >= 1
    assert_global_matches_oracle(root, oracle_states(tape))


def test_corrupt_stream_batch_detected_and_accounted(tmp_path):
    """A committed delta batch damaged on disk after the commit is skipped
    by the root and counted in stream_lost, never folded; the next clean
    batch folds."""
    root = str(tmp_path / "shm")
    fleet = Fleet(root, 2)
    for w in range(2):
        fleet.states[w]["arr"]["values"][0] = 3 * (w + 1)
        fleet.publish(w)
    node = NodeAggregator(root, "n0_0", workers=["w0", "w1"],
                          config=tree_cfg())
    plan = TF.FaultPlan(seed=1, rates={"stream_corrupt": 1.0})
    with TF.plan(plan):
        node.poll_once()
    assert plan.counters["stream_corrupt"] == 1
    root_agg = TD.Aggregator(root)
    status = root_agg.poll_once()
    assert status["stream_lost"] == {"n0_0": 1}
    assert int(views(root)["arr"]["values"][0]) == 0
    fleet.states[0]["arr"]["values"][0] += 7
    fleet.publish(0)
    node.poll_once()
    status = root_agg.poll_once()
    assert int(views(root)["arr"]["values"][0]) == 7
    assert status["stream_lost"] == {"n0_0": 1}


def test_dead_node_batches_harvested_then_retired(tmp_path):
    root = str(tmp_path / "shm")
    fleet = Fleet(root, 2, "mixed")
    for w in range(2):
        fleet.states[w]["arr"]["values"][0] = 7 * (w + 1)
        fleet.publish(w)
    node = NodeAggregator(root, "n0_0", workers=["w0", "w1"],
                          config=tree_cfg())
    node.poll_once()
    for w in range(2):
        fleet.states[w]["arr"]["values"][0] += 100
        fleet.publish(w)
    node.poll_once()
    assert node.stream.head() == 2
    _mark_node_dead(root, "n0_0")
    root_agg = TD.Aggregator(root)
    status = root_agg.poll_once()
    assert int(views(root)["arr"]["values"][0]) == 107 + 114
    assert status["nodes"]["n0_0"]["alive"] is False
    assert status["nodes"]["n0_0"]["last_seq"] == 2
    assert status["health"]["n0_0"]["state"] == TD.DEAD
    assert "w0" not in root_agg.workers and "w1" not in root_agg.workers


def test_worker_dies_under_its_node(tmp_path):
    root = str(tmp_path / "shm")
    fleet = Fleet(root, 4)
    for w in range(4):
        fleet.states[w]["arr"]["values"][2] = 10 * (w + 1)
        fleet.publish(w)
    tree = TreeAggregator(root, fan_in=2, config=tree_cfg())
    tree.poll_once()
    _mark_worker_dead(root, "w2")
    tree.poll_once()
    status = tree.poll_once()
    assert "w2" in status["dead"] and "w2" not in status["alive"]
    assert int(views(root)["arr"]["values"][2]) == 100


@pytest.mark.parametrize("first", ["jax", "port"])
def test_tree_resumes_from_the_other_packages_journals(tmp_path, first):
    """Two rounds folded by one package's tree (node and root journals on),
    the rest by the other package's tree built on the same root."""
    root = str(tmp_path / "shm")
    tape = gen_tape(np.random.default_rng(14), 4, n_events=120)
    fleet = Fleet(root, 4, "mixed")
    make = {"jax": lambda: JTree(root, fan_in=2, worker_ids=fleet.wids),
            "port": lambda: TreeAggregator(root, fan_in=2,
                                           config=tree_cfg(),
                                           worker_ids=fleet.wids)}
    box = {"tree": make[first](), "r": 0}

    def poll():
        box["r"] += 1
        if box["r"] == 3:
            box["tree"] = make["port" if first == "jax" else "jax"]()
        box["tree"].poll_once()
    fleet.play(tape, 4, polls=(poll,))
    box["tree"].poll_once()
    assert box["tree"].root_agg.cycles == 5
    assert_global_matches_oracle(root, oracle_states(tape))
