"""Deterministic fault injection for the fleet plane (DESIGN.md §11).

The shm/daemon boundary code calls ``faults.fire(point, **ctx)`` at named
production points; the default hook set is inert (one module-global check).
Installing a seed-driven :class:`FaultPlan` turns those call sites into
chaos injection points WITHOUT monkeypatching — the code path under test is
exactly the code path in production, per SafeBPF's "isolation claims are
only as strong as the failure modes actually tested".

Hook points (ctx keys in parentheses):

    shm:publish_begin     seqlock just went odd, publish in flight
    shm:publish_field     about to copy one field into the section
                          (map, field)
    shm:publish_commit    all fields + CRC written, seq still odd (section)
    shm:snapshot_begin    reader about to attempt a seqlocked read (name)
    agg:cycle_begin       aggregation cycle starting (cycle)
    agg:pre_merge         about to snapshot+fold one worker (wid, cycle)
    agg:post_merge        one worker folded into the accumulators (wid)
    agg:pre_publish       about to publish the merged global view
    agg:post_publish      global view published, journal not yet written
    agg:pre_journal       about to persist the fold journal
    agg:cycle_end         cycle complete, journal durable (cycle)
    node:pre_emit         node aggregator about to serialize + commit one
                          delta batch to its stream (node, seq, who)
    node:post_commit      delta batch durable on the stream, head bumped,
                          journal not yet written (node, seq, path, who)
    cache:post_store      AOT artifact payload + CRC meta just written to
                          the artifact cache (path, key)

All agg:* points carry ``who`` (the aggregator identity: ``"global"`` for
the root, the node id for a NodeAggregator), so a tree chaos schedule can
target one level of the tree without perturbing the others.

Fault classes (each has a counter, asserted by the chaos tests):

    torn_publish      abandon a publish mid-field-copy (partial section,
                      seqlock left odd)
    stuck_odd         abandon a publish right after the odd flip (seqlock
                      stuck odd with the previous consistent data intact)
    corrupt_snapshot  scribble bytes into a published section AFTER its CRC
                      was written (consistent seq, corrupt payload)
    kill_worker       SIGKILL the calling process mid-publish
    daemon_crash      raise InjectedCrash at a seeded aggregator point
                      (poll/fold/publish/journal boundary)
    pid_reuse         rewrite worker.json to a recycled pid (scenario
                      helper, see simulate_pid_reuse)
    slow_worker       seeded delay inside the publish window (skew)
    corrupt_artifact  scribble bytes into a stored cache artifact AFTER its
                      CRC meta was written — CRC-detectable on read, so the
                      cache must degrade to recompile, never serve it
    node_crash        raise InjectedCrash at a seeded node:* boundary point
                      (the emit/commit window of a node aggregator)
    stream_corrupt    scribble bytes into a committed delta batch AFTER its
                      CRC was embedded — the parent must detect it
                      (StreamCorruption) and count it as stream loss, never
                      fold a torn batch
"""
from __future__ import annotations

import json
import os
import signal
import time
from contextlib import contextmanager

import numpy as np

KINDS = ("torn_publish", "stuck_odd", "corrupt_snapshot", "kill_worker",
         "daemon_crash", "pid_reuse", "slow_worker", "corrupt_artifact",
         "node_crash", "stream_corrupt")

EIO = 5            # injected errno for syscall drills (override value -EIO)


class InjectedCrash(RuntimeError):
    """Deterministic daemon crash at an aggregator boundary point."""


class TornPublish(RuntimeError):
    """A publish abandoned mid-flight: section partially written (or not at
    all, for stuck_odd) and the seqlock left odd — exactly what a worker
    dying inside publish_device leaves behind."""


class FaultHooks:
    """Inert base hook set — production runs on this."""

    def fire(self, point: str, **ctx) -> None:
        pass


_active: FaultHooks | None = None


def install(hooks: FaultHooks) -> None:
    global _active
    _active = hooks


def uninstall() -> None:
    global _active
    _active = None


def active() -> bool:
    return _active is not None


def fire(point: str, **ctx) -> None:
    if _active is not None:
        _active.fire(point, **ctx)


@contextmanager
def plan(p: "FaultPlan"):
    """Install a plan for the duration of a with-block (tests)."""
    install(p)
    try:
        yield p
    finally:
        uninstall()


class FaultPlan(FaultHooks):
    """Seed-driven fault schedule. Same seed + same call sequence =>
    identical injections, so every chaos scenario replays exactly.

    rates      {kind: probability} rolled at that kind's natural point
    kill_at    1-based occurrence of shm:publish_begin at which the calling
               process SIGKILLs itself (workers install this)
    crash_at   1-based occurrence of any agg:* point at which InjectedCrash
               is raised (the daemon-crash schedule)
    crash_who  restrict crash_at / node_crash_at counting to agg:*/node:*
               points fired by this aggregator identity ("global" or a node
               id); None counts every aggregator — the flat behaviour
    node_crash_at  1-based occurrence of any node:* point at which
               InjectedCrash is raised (the node emit/commit window)
    counter_file  path the counters are flushed to before any destructive
               action (SIGKILL survives no in-process assertion)
    """

    def __init__(self, seed: int = 0, rates: dict | None = None, *,
                 kill_at: int | None = None, crash_at: int | None = None,
                 crash_who: str | None = None,
                 node_crash_at: int | None = None,
                 slow_s: float = 0.002, corrupt_nbytes: int = 8,
                 counter_file: str | None = None):
        self.rng = np.random.default_rng(seed)
        self.rates = dict(rates or {})
        unknown = set(self.rates) - set(KINDS)
        if unknown:
            raise ValueError(f"unknown fault kind(s): {sorted(unknown)}")
        self.kill_at = kill_at
        self.crash_at = crash_at
        self.crash_who = crash_who
        self.node_crash_at = node_crash_at
        self.slow_s = slow_s
        self.corrupt_nbytes = corrupt_nbytes
        self.counter_file = counter_file
        self.counters: dict[str, int] = {k: 0 for k in KINDS}
        self.points: dict[str, int] = {}
        self._agg_seen = 0
        self._node_seen = 0
        self._publish_begins = 0

    # ------------------------------------------------------------------ roll
    def _roll(self, kind: str) -> bool:
        rate = self.rates.get(kind, 0.0)
        if rate <= 0.0:
            return False
        # always draw, so the injection sequence depends only on the seed
        # and the call sequence, not on which kinds are enabled elsewhere
        return float(self.rng.random()) < rate

    def _count(self, kind: str) -> None:
        self.counters[kind] += 1

    def flush_counters(self) -> None:
        if self.counter_file:
            tmp = f"{self.counter_file}.tmp"
            with open(tmp, "w") as f:
                json.dump({"counters": self.counters,
                           "points": self.points}, f)
            os.replace(tmp, self.counter_file)

    # ------------------------------------------------------------------ fire
    def fire(self, point: str, **ctx) -> None:
        self.points[point] = self.points.get(point, 0) + 1
        if point.startswith("agg:"):
            if self.crash_who is not None and \
                    ctx.get("who", "global") != self.crash_who:
                return
            self._agg_seen += 1
            if self.crash_at is not None and self._agg_seen == self.crash_at:
                self._count("daemon_crash")
                self.flush_counters()
                raise InjectedCrash(f"{point} (occurrence {self._agg_seen})")
            return
        if point.startswith("node:"):
            if self.crash_who is not None and \
                    ctx.get("who", ctx.get("node")) != self.crash_who:
                return
            self._node_seen += 1
            if self.node_crash_at is not None and \
                    self._node_seen == self.node_crash_at:
                self._count("node_crash")
                self.flush_counters()
                raise InjectedCrash(f"{point} (occurrence {self._node_seen})")
            if point == "node:post_commit" and self._roll("stream_corrupt"):
                self._scribble_file(ctx["path"])
                self._count("stream_corrupt")
                self.flush_counters()
            return
        if point == "cache:post_store":
            if self._roll("corrupt_artifact"):
                self._scribble_file(ctx["path"])
                self._count("corrupt_artifact")
                self.flush_counters()
            return
        if ctx.get("role", "worker") != "worker":
            return      # publish-side fault classes model WORKER failures;
                        # the daemon's own global publish is failed via the
                        # agg:* crash schedule instead
        if point == "shm:publish_begin":
            self._publish_begins += 1
            if self.kill_at is not None and \
                    self._publish_begins == self.kill_at:
                self._count("kill_worker")
                self.flush_counters()
                os.kill(os.getpid(), signal.SIGKILL)
            if self._roll("stuck_odd"):
                self._count("stuck_odd")
                self.flush_counters()
                raise TornPublish("stuck_odd: publish abandoned at the "
                                  "odd flip")
            if self._roll("slow_worker"):
                self._count("slow_worker")
                time.sleep(self.slow_s * (0.5 + float(self.rng.random())))
        elif point == "shm:publish_field":
            if self._roll("torn_publish"):
                self._count("torn_publish")
                self.flush_counters()
                raise TornPublish(
                    f"torn_publish: abandoned before "
                    f"{ctx.get('map')}.{ctx.get('field')}")
        elif point == "shm:publish_commit":
            if self._roll("corrupt_snapshot"):
                self._scribble(ctx["section"])
                self._count("corrupt_snapshot")
                self.flush_counters()

    def _scribble(self, section: dict) -> None:
        """Flip bytes in one random field of one random map — AFTER the CRC
        was computed, so the corruption is CRC-detectable, never a valid
        alternate state."""
        names = sorted(section)
        name = names[int(self.rng.integers(len(names)))]
        fields = sorted(section[name])
        arr = section[name][fields[int(self.rng.integers(len(fields)))]]
        flat = arr.reshape(-1).view(np.uint8)
        n = min(self.corrupt_nbytes, flat.shape[0])
        idx = self.rng.integers(0, flat.shape[0], size=n)
        flat[idx] ^= np.uint8(0xA5)

    def _scribble_file(self, path: str) -> None:
        """Flip bytes in a stored artifact file in place — the CRC in its
        meta sidecar was already written, so the next read must detect it."""
        with open(path, "r+b") as f:
            data = bytearray(f.read())
            if not data:
                return
            n = min(self.corrupt_nbytes, len(data))
            for i in self.rng.integers(0, len(data), size=n):
                data[int(i)] ^= 0xA5
            f.seek(0)
            f.write(bytes(data))


# --------------------------------------------------------------------------
# scenario helpers
# --------------------------------------------------------------------------

def simulate_pid_reuse(root: str, wid: str, imposter_pid: int,
                       p: FaultPlan | None = None) -> None:
    """The pid-reuse hazard: the registered worker died and the OS handed
    its pid to an unrelated process. worker.json keeps the DEAD worker's
    identity (boot id, pid_start) but now names a live pid — exactly the
    state the aggregator must not mistake for a live worker."""
    path = os.path.join(root, "workers", str(wid), "worker.json")
    with open(path) as f:
        info = json.load(f)
    info["pid"] = int(imposter_pid)
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w") as f:
        json.dump(info, f)
    os.replace(tmp, path)
    if p is not None:
        p.counters["pid_reuse"] += 1


# --------------------------------------------------------------------------
# syscall-override failure drills (the paper's syscall-hook capability
# turned into a self-test of our own fault tolerance)
# --------------------------------------------------------------------------

# Overrides the syscall with -EIO while a shm/map-resident budget lasts:
# each invocation fetch-adds -1 and faults only while the OLD value was
# positive, so exactly `budget` consecutive calls fail, then the real
# implementation runs again — a transient-fault generator with eBPF-visible
# accounting (the drained budget is readable via `map dump`).
EIO_FILTER_ASM = """
    mov r6, 0
    stxdw [r10-8], r6
    lddw r1, map:{map}
    mov r2, r10
    add r2, -8
    mov r3, -1
    call map_fetch_add
    jsle r0, 0, out
    mov r1, -{err}
    call override_return
out:
    mov r0, 0
    exit
"""


def arm_syscall_fault(runtime, sys_name: str, budget: int, *,
                      err: int = EIO, map_name: str = "eio_budget",
                      prog_name: str | None = None) -> int:
    """Load + attach the transient-fault filter on `sys_name` with `budget`
    failures left. Returns the link id (detach to disarm). The budget map
    is created on the runtime if absent; re-arming just refills it."""
    from . import maps as M
    spec = M.MapSpec(map_name, M.MapKind.ARRAY, max_entries=1)
    if map_name not in runtime.host_maps:
        runtime.create_map(spec)
    runtime.host_maps[map_name]["values"][0] = int(budget)
    name = prog_name or f"eio_{sys_name}"
    asm = EIO_FILTER_ASM.format(map=map_name, err=int(err))
    pid = runtime.load_asm(name, asm, [spec], "filter")
    return runtime.attach(pid, f"filter:{sys_name}")


def drill_remaining(runtime, map_name: str = "eio_budget") -> int:
    """Failures left in the drill budget (<= 0 once the drill has drained
    and the syscall path recovered)."""
    return int(runtime.host_maps[map_name]["values"][0])
