"""Chaos drill on the PyTorch port: a 3-worker fleet survives a SIGKILLed
worker AND a daemon crash, and the recovered global view still converges
to the exact oracle. The twin of examples/chaos_drill.py, on `repro_torch`.

What happens:

  * three worker processes join one shm region and publish deterministic
    map updates over several rounds;
  * ONE worker installs a seed-driven FaultPlan that SIGKILLs it mid-
    publish (at the odd-seqlock window) — exactly what a trainer dying
    inside publish_device leaves behind;
  * the daemon aggregates the fleet, then CRASHES at an injected agg:*
    boundary point (InjectedCrash) and is RESTARTED — the new Aggregator
    resumes from the fold journal under global/;
  * the parent asserts: the victim's death is detected (pid gone, stuck-odd
    seqlock never surfaced), its last CONSISTENT contribution is retained,
    the survivors' full contributions merge, and the recovered global view
    is bit-identical to the replayed oracle;
  * `fleet health` renders the victim's transition to DEAD;
  * artifact-cache drill: a worker's stored step (the `torch.export`
    program `rt.aot_step` stores) is corrupted on the cache:post_store
    hook; the next joiner's CRC check detects it, DELETES the torn entry,
    and degrades to tracing again -- never crashes, never runs corrupted
    code -- and the re-stored program serves the joiner after that. The
    step runs on --device.

    PYTHONPATH=src python examples/torch/chaos_drill.py              # CUDA
    PYTHONPATH=src python examples/torch/chaos_drill.py --device cpu

The workers are shm-only (numpy) and start with `spawn`.

Exits non-zero on any failed invariant.
"""
import argparse
import json
import multiprocessing as mp
import os
import shutil
import signal
import sys
import tempfile
import time

import numpy as np

N_WORKERS = 3
ROUNDS = 4
VICTIM = "w1"
VICTIM_ROUNDS = 2          # consistent publishes before the SIGKILL

SPECS_ARGS = [("fleet_arr", "ARRAY", 8), ("fleet_hist", "LOG2HIST", 64)]


def _specs():
    from repro_torch.core import maps as M
    return [M.MapSpec(n, M.MapKind[k], max_entries=e)
            for n, k, e in SPECS_ARGS]


def _apply_round(states, w: int, r: int) -> None:
    """Deterministic per-round update: replayable as the oracle."""
    from repro_torch.core import maps as M
    M.n_array_fetch_add(states["fleet_arr"], w, r)
    M.n_hist_add(states["fleet_hist"], (r << 16) + w)


def worker_main(root: str, wid: str, kill_at: int | None,
                counter_file: str | None, go_file: str | None) -> None:
    from repro_torch.core import faults as F, maps as M, shm as SH

    if kill_at is not None:
        # SIGKILL self at the kill_at-th publish_begin — inside the odd
        # seqlock window, counters flushed to disk first
        F.install(F.FaultPlan(seed=0, kill_at=kill_at,
                              counter_file=counter_file))
    specs = _specs()
    region = SH.ShmRegion.create(root, specs, worker_id=wid)
    states = M.init_states_np(specs)
    w = int(wid[1:])
    for r in range(1, ROUNDS + 1):
        _apply_round(states, w, r)
        if go_file is not None and r == VICTIM_ROUNDS + 1:
            # wait until the daemon has folded our consistent publishes,
            # so the drill's oracle is deterministic
            while not os.path.exists(go_file):
                time.sleep(0.01)
        region.publish_device(states)      # the victim dies inside this
        time.sleep(0.02)


def _oracle():
    """Replay: survivors contribute all ROUNDS, the victim only what it
    published consistently before the SIGKILL."""
    from repro_torch.core import maps as M
    st = M.init_states_np(_specs())
    for w in range(N_WORKERS):
        last = VICTIM_ROUNDS if f"w{w}" == VICTIM else ROUNDS
        for r in range(1, last + 1):
            _apply_round(st, w, r)
    return st


def _run(root: str, device: str) -> int:
    counter_file = os.path.join(root, "victim_counters.json")
    go_file = os.path.join(root, "victim_go")
    ctx = mp.get_context("spawn")
    procs = {}
    for w in range(N_WORKERS):
        wid = f"w{w}"
        victim = wid == VICTIM
        procs[wid] = ctx.Process(
            target=worker_main,
            args=(root, wid, VICTIM_ROUNDS + 1 if victim else None,
                  counter_file if victim else None,
                  go_file if victim else None))
        procs[wid].start()
    try:
        return _drill(root, procs, counter_file, go_file, device)
    finally:
        for p in procs.values():           # never leak children on failure
            if p.is_alive():
                p.kill()
                p.join()


def _drill(root: str, procs: dict, counter_file: str, go_file: str,
           device: str) -> int:
    from repro_torch.core import daemon as D, faults as F, shm as SH

    # the first worker to register writes the region meta
    deadline = time.monotonic() + 60
    while len(SH.list_workers(root)) < N_WORKERS:
        if time.monotonic() > deadline:
            print("FAIL: workers never registered", file=sys.stderr)
            return 1
        time.sleep(0.02)

    # -- aggregate until the victim's consistent publishes are folded
    cfg = D.AggregatorConfig(snapshot_retries=10, backoff_base=1e-4,
                             backoff_max=2e-3)
    agg = D.Aggregator(root, config=cfg)
    deadline = time.monotonic() + 60
    while True:
        agg.poll_once()
        seq = agg.workers.get(VICTIM, {}).get("seq", 0)
        if seq >= 2 * VICTIM_ROUNDS:       # 2 seq ticks per publish
            break
        if time.monotonic() > deadline:
            print("FAIL: victim publishes never observed", file=sys.stderr)
            return 1
        time.sleep(0.02)
    print(f"folded {VICTIM_ROUNDS} consistent publishes from {VICTIM}")

    # -- daemon crash at an injected aggregation boundary + restart
    with F.plan(F.FaultPlan(seed=0, crash_at=2)):
        try:
            agg.poll_once()
            print("FAIL: injected daemon crash did not fire",
                  file=sys.stderr)
            return 1
        except F.InjectedCrash as e:
            print(f"daemon crashed (injected): {e}")
    agg = D.Aggregator(root, config=cfg)   # journal recovery
    print("daemon restarted from the fold journal")

    # -- release the victim into its fatal publish
    with open(go_file, "w") as f:
        f.write("go")
    procs[VICTIM].join(timeout=60)
    if procs[VICTIM].exitcode != -signal.SIGKILL:
        print(f"FAIL: victim exitcode {procs[VICTIM].exitcode}, expected "
              f"SIGKILL", file=sys.stderr)
        return 1
    with open(counter_file) as f:
        counters = json.load(f)["counters"]
    if counters["kill_worker"] != 1:
        print(f"FAIL: kill_worker counter {counters}", file=sys.stderr)
        return 1
    victim_region = SH.ShmRegion.attach(root, mode="r", worker_id=VICTIM)
    if int(victim_region.seq[0]) % 2 != 1:
        print("FAIL: victim seqlock not odd after mid-publish SIGKILL",
              file=sys.stderr)
        return 1
    print(f"{VICTIM} SIGKILLed mid-publish (seqlock left odd)")

    for wid, p in procs.items():
        if wid != VICTIM:
            p.join(timeout=120)

    # -- final polls: harvest the dead victim, fold the survivors' tails
    status = agg.poll_once()
    status = agg.poll_once()
    # survivors that already exited cleanly are harvested as dead too —
    # the drill's point is that the VICTIM is among them with its stuck-odd
    # final publish forfeited, not silently folded
    if VICTIM not in status["dead"]:
        print(f"FAIL: dead={status['dead']}", file=sys.stderr)
        return 1
    if status["health"][VICTIM]["state"] != D.DEAD:
        print(f"FAIL: health={status['health'][VICTIM]}", file=sys.stderr)
        return 1
    print(f"victim harvested: dead={status['dead']}, "
          f"health[{VICTIM}]={status['health'][VICTIM]['state']}")

    # -- the recovered global view is bit-identical to the oracle
    g = SH.GlobalView.attach(root)
    want = _oracle()
    for name, st in want.items():
        got = g.snapshot(name)
        for fieldname in got:
            if not np.array_equal(got[fieldname],
                                  np.asarray(st[fieldname])):
                print(f"FAIL: {name}.{fieldname}: {got[fieldname]} != "
                      f"{st[fieldname]}", file=sys.stderr)
                return 1
    arr = g.snapshot("fleet_arr")["values"]
    print(f"OK: global view converged to the oracle "
          f"(fleet_arr={arr[:N_WORKERS].tolist()}: survivors "
          f"{sum(range(1, ROUNDS + 1))}, victim "
          f"{sum(range(1, VICTIM_ROUNDS + 1))})")

    # -- fleet health CLI renders the transition
    rc = D.main([root, "fleet", "health"])
    if rc != 0:
        print("FAIL: fleet health CLI", file=sys.stderr)
        return 1

    # -- artifact cache corruption drill
    rc = _cache_drill(root, device)
    if rc != 0:
        return rc
    print("OK: chaos drill survived worker SIGKILL + daemon crash "
          "+ corrupted AOT artifact")
    return 0


def _cache_drill(root: str, device: str) -> int:
    """Corrupted artifact -> CRC detect -> degrade to tracing again.

    Worker 1 boots through the cache while the corrupt_artifact fault
    scribbles its stored program (post-CRC, exactly the torn-write a
    dying disk leaves behind). Worker 2 must see a MISS (never corrupted
    code), trace again, and re-store; worker 3 then hits the clean entry.
    All three produce identical outputs."""
    import torch

    from repro_torch.core import faults as F
    from repro_torch.core.maps import MapKind, MapSpec
    from repro_torch.core.runtime import BpftimeRuntime

    cache_dir = os.path.join(root, "cache")
    x = torch.arange(8.0, device=device)

    def boot():
        rt = BpftimeRuntime()
        rt.create_map(MapSpec("drill_counts", MapKind.ARRAY, max_entries=8))
        rt.enable_artifact_cache(cache_dir)
        compiled, hit = rt.aot_step(
            lambda: (lambda v: v * 2 + 1), (x,),
            extra_key=("cache_drill",))
        return rt.artifact_cache, compiled, hit

    with F.plan(F.FaultPlan(seed=0,
                            rates={"corrupt_artifact": 1.0})) as p:
        _, c1, hit1 = boot()              # populate -> fault scribbles it
        if hit1 or p.counters["corrupt_artifact"] != 1:
            print(f"FAIL: corrupt_artifact never fired (hit={hit1}, "
                  f"counters={p.counters})", file=sys.stderr)
            return 1
    print("stored AOT artifact corrupted (injected, post-CRC)")

    cache2, c2, hit2 = boot()             # CRC detects -> trace again
    if hit2 or cache2.counters["corrupt"] != 1:
        print(f"FAIL: corrupted artifact served or not detected "
              f"(hit={hit2}, counters={cache2.counters})", file=sys.stderr)
        return 1
    print("next joiner: CRC mismatch detected, torn entry deleted, "
          "degraded to recompile")

    cache3, c3, hit3 = boot()             # clean re-store serves again
    if not hit3:
        print(f"FAIL: recompiled artifact not reusable "
              f"(counters={cache3.counters})", file=sys.stderr)
        return 1
    if not (torch.equal(c1(x), c2(x)) and torch.equal(c2(x), c3(x))):
        print("FAIL: outputs diverged across the corruption drill",
              file=sys.stderr)
        return 1
    print("OK: corruption degraded to recompile; re-stored artifact "
          "hits again, outputs bit-identical")
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    root = tempfile.mkdtemp(prefix="bpftime_chaos_")
    try:
        return _run(root, args.device)
    finally:
        shutil.rmtree(root, ignore_errors=True)


if __name__ == "__main__":
    sys.exit(main())
