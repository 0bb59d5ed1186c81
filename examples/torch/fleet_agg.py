"""Fleet aggregation demo on the PyTorch port: THREE worker processes, ONE
global view. The twin of examples/fleet_agg.py, on `repro_torch`.

Each worker is an independent process running its own BpftimeRuntime with
a LOG2HIST probe in its probe stage, on its own device context; all three
join the same shm region under workers/<wid>/. The parent runs the
daemon's aggregation engine (`daemon.Aggregator`), which polls every
worker's seqlocked snapshots, merges the per-worker histograms with the
commutative delta-sum twins, and publishes one fleet-wide histogram under
<dir>/global/.

    PYTHONPATH=src python examples/torch/fleet_agg.py              # CUDA
    PYTHONPATH=src python examples/torch/fleet_agg.py --device cpu

Asserts (exits non-zero on failure):
  * the merged global LOG2HIST is bin-for-bin the SUM of what each worker
    measured locally;
  * every worker (including ones that already exited) is accounted for in
    the aggregation status;
  * the bpftool-style CLI can read the global view;
  * every worker boots its probe stage through the fleet artifact cache
    (`rt.aot_step`: the `torch.export` program of the stage), and a LATE
    joiner booting after the fleet has populated <root>/cache hits it --
    it loads the stored program, no trace;
  * act 2: a TWELVE-worker fleet aggregated through the hierarchical tree
    (worker -> node -> root, fan-in 4, delta streams, the node folds on
    --device) converges to the exact bin-wise sum AND comes out
    bit-identical to a flat aggregator merging the same publish content.

Workers start with `spawn`, so no process inherits the parent's device
context.
"""
import argparse
import json
import multiprocessing as mp
import os
import shutil
import sys
import tempfile
import time

import numpy as np

N_WORKERS = 3
N_STEPS = 4
EVENTS_PER_STEP = 64

HIST_RMS = """
    ldxdw r2, [r1+ctx:rms]
    lddw r1, map:fleet_hist
    call hist_add
    mov r0, 0
    exit
"""


def worker_main(root: str, wid: str, device: str) -> None:
    """One trainer-analogue process: probe stage on `device`, shm joined as
    workers/<wid>/, one publish per step."""
    import torch

    from repro_torch.core import events as E, jit as J, maps as M
    from repro_torch.core.runtime import BpftimeRuntime

    rt = BpftimeRuntime()
    spec = M.MapSpec("fleet_hist", M.MapKind.LOG2HIST)
    pid = rt.load_asm("fleet_hist_rms", HIST_RMS, [spec], "uprobe")
    rt.attach(pid, "uprobe:fleet_block")
    rt.setup_shm(root, worker_id=wid)     # auto-joins <root>/cache

    def build():
        return lambda rows, maps: rt.probe_stage(
            rows, maps, J.make_aux(device=device))[0]

    maps = rt.init_device_maps(device)
    sig = torch.zeros((EVENTS_PER_STEP, E.EVENT_WIDTH), dtype=torch.int64,
                      device=device)
    t0 = time.perf_counter()
    # boot through the fleet artifact cache: the first worker traces +
    # stores, later joiners load the stored program instead of tracing
    stage, cache_hit = rt.aot_step(build, (sig, maps),
                                   extra_key=("fleet_agg", EVENTS_PER_STEP))
    boot_ms = (time.perf_counter() - t0) * 1e3
    rt.publish_status()      # surface hit/miss counters in status.json
    with open(os.path.join(root, f"cachejoin_{wid}.json"), "w") as f:
        json.dump({"wid": wid, "hit": cache_hit, "boot_ms": boot_ms}, f)
    rng = np.random.default_rng(seed=int(wid[1:]))
    sid = E.SITES.get_or_create("fleet_block")
    for step in range(N_STEPS):
        rows = np.zeros((EVENTS_PER_STEP, E.EVENT_WIDTH), np.int64)
        rows[:, 0] = sid
        rows[:, 1] = E.KIND_ENTRY
        rows[:, 3] = step
        rows[:, 6] = rng.integers(1, 1 << 24, EVENTS_PER_STEP)  # rms (fx)
        maps = stage(torch.from_numpy(rows).to(device), maps)
        rt.publish(maps)
    # leave the locally-measured truth on disk for the parent's assertion
    np.save(os.path.join(root, f"expect_{wid}.npy"),
            maps["fleet_hist"]["bins"].cpu().numpy())


TREE_WORKERS = 12
TREE_FAN_IN = 4
TREE_ROUNDS = 4
TREE_EVENTS = 256


def tree_worker_main(root: str, wid: str) -> None:
    """Lightweight shm-only worker for the tree act: publishes LOG2HIST
    deltas straight through the map plane (no runtime -- the tree demo is
    about the aggregation topology, not program execution)."""
    from repro_torch.core import maps as M, shm as SH

    specs = [M.MapSpec("tree_hist", M.MapKind.LOG2HIST)]
    region = SH.ShmRegion.create(root, specs, worker_id=wid)
    state = M.init_states_np(specs)
    rng = np.random.default_rng(seed=int(wid[1:]))
    for _ in range(TREE_ROUNDS):
        np.add.at(state["tree_hist"]["bins"],
                  rng.integers(0, 64, TREE_EVENTS), 1)
        region.publish_device(state)
        time.sleep(0.01)
    np.save(os.path.join(root, f"expect_{wid}.npy"),
            np.asarray(state["tree_hist"]["bins"]))


def _run_tree_fleet(root: str, tree: bool, device: str) -> np.ndarray:
    """Spawn TREE_WORKERS publishers into `root` and aggregate them live --
    hierarchically (fan-in-4 tree of NodeAggregators, node folds on
    `device`) or flat -- returning the final global bins after the
    dead-worker harvest."""
    from repro_torch.core import daemon, shm as SH
    from repro_torch.core.treeagg import TreeAggregator

    def make_agg():
        if tree:
            return TreeAggregator(
                root, fan_in=TREE_FAN_IN, worker_ids=wids,
                config=daemon.AggregatorConfig(device=device))
        return daemon.Aggregator(root)

    ctx = mp.get_context("spawn")
    wids = [f"w{i:03d}" for i in range(TREE_WORKERS)]
    procs = [ctx.Process(target=tree_worker_main, args=(root, wid))
             for wid in wids]
    for p in procs:
        p.start()
    agg = None
    while any(p.is_alive() for p in procs):
        if agg is None and len(SH.list_workers(root)) == TREE_WORKERS:
            agg = make_agg()
        if agg is not None:
            agg.poll_once()
        time.sleep(0.02)
    for p in procs:
        p.join()
    assert all(p.exitcode == 0 for p in procs), \
        f"tree worker crashed: {[p.exitcode for p in procs]}"
    if agg is None:
        agg = make_agg()
    status = agg.poll_once()          # final harvest (dead-worker rule)
    assert set(status["alive"]) | set(status["dead"]) == set(wids), status
    expect = sum(np.load(os.path.join(root, f"expect_{w}.npy"))
                 for w in wids)
    merged = SH.GlobalView.attach(root).snapshot("tree_hist")["bins"]
    np.testing.assert_array_equal(merged, expect)
    return np.asarray(merged)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    root = tempfile.mkdtemp(prefix="bpftime_fleet_")
    try:
        return _run(root, args.device)
    finally:
        shutil.rmtree(root, ignore_errors=True)


def _run(root: str, device: str) -> int:
    from repro_torch.core import daemon, shm as SH

    ctx = mp.get_context("spawn")     # fresh interpreters, no inherited
    wids = [f"w{i}" for i in range(N_WORKERS)]      # device context
    procs = [ctx.Process(target=worker_main, args=(root, wid, device))
             for wid in wids]
    for p in procs:
        p.start()

    # aggregate WHILE the fleet runs (workers publish every step), then do
    # a final harvest once everyone has exited
    agg = None
    while any(p.is_alive() for p in procs):
        if agg is None and SH.list_workers(root):
            agg = daemon.Aggregator(root)
        if agg is not None:
            agg.poll_once()
        time.sleep(0.05)
    for p in procs:
        p.join()
    assert all(p.exitcode == 0 for p in procs), \
        f"worker crashed: {[p.exitcode for p in procs]}"
    if agg is None:
        agg = daemon.Aggregator(root)
    status = agg.poll_once()          # final harvest (dead-worker rule)

    merged = SH.GlobalView.attach(root).snapshot("fleet_hist")["bins"]
    expect = sum(np.load(os.path.join(root, f"expect_{w}.npy"))
                 for w in wids)
    print(f"fleet status: accounted={sorted(status['alive']) + sorted(status['dead'])} "
          f"merged_updates={status['merged_updates']}")
    print(daemon.render_log2_hist(merged, label="rms"))
    print(f"\nglobal total={int(merged.sum())} "
          f"(= {N_WORKERS} workers x {N_STEPS * EVENTS_PER_STEP} events)")

    assert sorted(status["alive"]) + sorted(status["dead"]) and \
        set(status["alive"]) | set(status["dead"]) == set(wids), status
    np.testing.assert_array_equal(merged, expect)
    assert int(merged.sum()) == N_WORKERS * N_STEPS * EVENTS_PER_STEP

    # the bpftool-style CLI reads the same global view
    rc = daemon.main([root, "map", "top", "fleet_hist", "-n", "3"])
    assert rc == 0
    print("OK: global histogram is the exact bin-wise sum of all workers")

    # -- fleet cold-join: a LATE worker boots the same world against the
    # now-populated artifact cache and must hit (load, no trace)
    late = ctx.Process(target=worker_main,
                       args=(root, f"w{N_WORKERS}", device))
    late.start()
    late.join()
    assert late.exitcode == 0, f"late joiner crashed: {late.exitcode}"
    with open(os.path.join(root, f"cachejoin_w{N_WORKERS}.json")) as f:
        join_info = json.load(f)
    assert join_info["hit"], \
        f"late joiner missed the warm artifact cache: {join_info}"
    rc = daemon.main([root, "prog", "cache", "stat"])
    assert rc == 0
    print(f"OK: late joiner w{N_WORKERS} warm cold-join in "
          f"{join_info['boot_ms']:.1f}ms (AOT cache hit)")

    # -- act 2: the SAME publish content (per-worker seeds) merged two
    # ways -- a fan-in-4 tree of NodeAggregators over delta streams, and
    # the flat single-consumer plane -- must land on ONE answer
    tree_root = tempfile.mkdtemp(prefix="bpftime_tree_")
    flat_root = tempfile.mkdtemp(prefix="bpftime_flat_")
    try:
        tree_bins = _run_tree_fleet(tree_root, True, device)
        flat_bins = _run_tree_fleet(flat_root, False, device)
    finally:
        shutil.rmtree(tree_root, ignore_errors=True)
        shutil.rmtree(flat_root, ignore_errors=True)
    np.testing.assert_array_equal(tree_bins, flat_bins)
    n_nodes = -(-TREE_WORKERS // TREE_FAN_IN)
    print(f"\ntree fleet: {TREE_WORKERS} workers -> {n_nodes} node "
          f"aggregators (fan-in {TREE_FAN_IN}) -> global root: "
          f"total={int(tree_bins.sum())} "
          f"(= {TREE_WORKERS} workers x {TREE_ROUNDS * TREE_EVENTS} events)")
    print("OK: hierarchical tree view is bit-identical to the flat merge")
    return 0


if __name__ == "__main__":
    sys.exit(main())
