"""bpftime-daemon analogue: a separate monitor/control process that

  * attaches to the shm region (no privileges over the trainer needed —
    plain file permissions, paper SP4);
  * reads live host maps and seqlocked device-map snapshots;
  * aggregates a FLEET of worker processes into one global map view
    (`Aggregator`, DESIGN.md §10): per-cycle delta extraction against a
    last-seen baseline, commutative merge per map kind, dead/stale worker
    detection, seqlocked publish under `<dir>/global/`;
  * renders bcc-style log2 histograms / counters;
  * queues load+attach requests the trainer applies at the next step
    boundary (injection-without-restart, paper C5) — fanned out to every
    worker of a fleet.

Usable as a library (tests) or CLI. bpftool-style subcommands:

    python -m repro_torch.core.daemon <shm_dir> map dump [MAP] [--section S]
    python -m repro_torch.core.daemon <shm_dir> map top MAP [-n K]
    python -m repro_torch.core.daemon <shm_dir> prog list
    python -m repro_torch.core.daemon <shm_dir> prog cache [ls|stat|purge [KEY]]
    python -m repro_torch.core.daemon <shm_dir> prog relocate NAME [--json]
    python -m repro_torch.core.daemon <shm_dir> attach OBJ.json [--target T]
                                [--mode auto|fused|table] [--no-promote]
    python -m repro_torch.core.daemon <shm_dir> detach LINK_ID
    python -m repro_torch.core.daemon <shm_dir> agg [--watch SECONDS] [--once]
    python -m repro_torch.core.daemon <shm_dir> fleet health [--json]

plus the legacy single-process watcher flags:

    python -m repro_torch.core.daemon <shm_dir> [--watch SECONDS] [--once]
                                [--attach OBJ --live] [--detach LINK_ID]
"""
from __future__ import annotations

import argparse
import base64
import json
import os
import sys
import time
from dataclasses import dataclass

import numpy as np

from . import faults, maps as M, shm as SH
from .maps import MapKind, MapSpec
from .shm import GlobalView, ShmRegion, SnapshotCorruption

from ..ft import fault_tolerance as FT


def render_log2_hist(bins: np.ndarray, label: str = "value") -> str:
    """bcc/bpftrace-style ASCII histogram (fixed-point Q47.16 bins)."""
    total = int(bins.sum())
    out = [f"{label:>16} : count    distribution"]
    if total == 0:
        return "\n".join(out + ["(empty)"])
    top = int(bins.max())
    nz = np.nonzero(bins)[0]
    lo, hi = int(nz.min()), int(nz.max())
    for b in range(lo, hi + 1):
        c = int(bins[b])
        bar = "*" * int(40 * c / top)
        # bin k holds fx values with bit_length == k; fx = v * 2^16
        lo_v = 0.0 if b == 0 else (1 << (b - 1)) / 65536.0
        hi_v = (1 << b) / 65536.0
        out.append(f"{lo_v:10.4g} -> {hi_v:<10.4g} : {c:<8d} |{bar}|")
    return "\n".join(out)


def _summarize_state(spec: MapSpec, st: dict) -> list[str]:
    lines = []
    if spec.kind == MapKind.LOG2HIST:
        lines.append(f"[{spec.name}] log2 histogram:")
        lines.append(render_log2_hist(st["bins"]))
    elif spec.kind == MapKind.ARRAY:
        nz = np.nonzero(st["values"])[0]
        kv = {int(i): int(st["values"][i]) for i in nz[:16]}
        lines.append(f"[{spec.name}] array: {kv}")
    elif spec.kind == MapKind.HASH:
        items = M.n_hash_items(st)
        kv = dict(sorted(items.items())[:16])
        lines.append(f"[{spec.name}] hash: {kv}")
    elif spec.kind == MapKind.PERCPU_ARRAY:
        tot = st["values"].sum(axis=0)
        nz = np.nonzero(tot)[0]
        lines.append(f"[{spec.name}] percpu (summed): "
                     f"{ {int(i): int(tot[i]) for i in nz[:16]} }")
    elif spec.kind == MapKind.RINGBUF:
        lines.append(f"[{spec.name}] ringbuf head={int(st['head'][0])} "
                     f"dropped={int(st['dropped'][0])}")
    return lines


def summarize(shm: ShmRegion, section: str = "device") -> str:
    lines = []
    for spec in shm.specs:
        st = (shm.snapshot_device(spec.name) if section == "device"
              else {f: np.array(a) for f, a in shm.host[spec.name].items()})
        lines.extend(_summarize_state(spec, st))
    return "\n".join(lines)


def request_load_attach(shm: ShmRegion, obj_json: str,
                        target: str | None = None,
                        live: bool = False, mode: str | None = None,
                        promote: bool = True) -> None:
    """Queue a load+attach through the trainer's unified attach API.

    mode: "auto" | "fused" | "table" (None keeps the legacy mapping —
    live=True means mode="table", otherwise mode="fused").  mode="table"
    (or live=True) goes live on the ALREADY-COMPILED step (no retrace) —
    watch `live_gen` in read_status() bump to confirm application; with
    promote=True the trainer's promotion engine then retrains the link
    onto the fused lane in the background (`promotions` in the status
    doc walks interp -> compiling -> fused)."""
    req = {"op": "load_attach", "object": obj_json, "target": target,
           "live": live or mode == "table", "promote": promote}
    if mode is not None:
        req["mode"] = mode
    shm.request(req)


def request_detach(shm: ShmRegion, link_id: int) -> None:
    shm.request({"op": "detach", "link_id": link_id})


# --------------------------------------------------------------------------
# aggregation engine (DESIGN.md §10)
# --------------------------------------------------------------------------

class SeqRegression(Exception):
    """A worker's seqlock went BACKWARDS: its shm section was re-created
    (restart) under the aggregator. The cycle's snapshot is a different
    incarnation's state and must be forfeited, never diffed."""


# per-worker health states (DESIGN.md §11) — deterministic, cycle-counted
# thresholds so the state machine is testable without wall-clock sleeps
HEALTHY = "HEALTHY"
DEGRADED = "DEGRADED"
STALE = "STALE"
DEAD = "DEAD"


@dataclass
class AggregatorConfig:
    """Aggregation-engine tunables (satellite: no more hardcoded constants
    in shm.py/daemon.py).

    Seqlock reads back off exponentially: the first retry sleeps
    `backoff_base` seconds, doubling per attempt up to `backoff_max` —
    a one-publish collision resolves in ~50us (vs the old fixed 1ms),
    while a stuck writer costs at most retries * backoff_max before the
    worker is demoted to stale for the cycle."""
    snapshot_retries: int = 50
    backoff_base: float = SH.BACKOFF_BASE
    backoff_max: float = SH.BACKOFF_MAX
    poll_interval: float = 2.0          # loop() cadence, seconds
    # health state machine (cycle-counted)
    degraded_after: int = 3             # merges with no seq advance
    quarantine_after: int = 2           # consecutive failed cycles
    quarantine_probe_retries: int = 2   # reduced budget while quarantined
    # back-pressure: skip the global rebuild+publish while a cycle folds
    # more than coalesce_threshold updates (None = always publish), but
    # never let more than publish_max_lag cycles go unpublished
    coalesce_threshold: int | None = None
    publish_max_lag: int = 4
    # crash recovery
    journal: bool = True
    # journal cadence: write the fold journal every K output events (root:
    # cycles; node: emits). Lag is safe — restores re-extract idempotently
    # against the journaled baselines — and amortizes the json encode on
    # the hot fleet path
    journal_every: int = 1
    # tree aggregation (DESIGN.md §15)
    # publish sharded global hash views (keyspace partitioned over the
    # home-slot hash); None = single unsharded view only
    hash_shards: int | None = None
    # node-level folds run as device reductions over the whole worker
    # group (False = numpy twins, bit-identical)
    device_fold: bool = True
    # the device the node-level folds run on; with device_fold and no
    # such device, building a node aggregator raises (no numpy fallback)
    device: str = "cuda"
    # ft wiring: heartbeats count aggregation cycles since the worker's
    # seqlock last advanced; step_time_map names a host ARRAY map of
    # per-step wall times the workers publish (sys_step_end probe)
    heartbeat_timeout_cycles: float = 5.0
    step_time_map: str | None = None
    straggler_factor: float = 1.5
    straggler_min_samples: int = 5


def _fresh_health() -> dict:
    return {"state": HEALTHY, "consec_fail": 0, "no_advance": 0,
            "quarantined": False, "transitions": []}


def _enc_arr(a) -> dict:
    """Journal array codec: raw little-endian int64 bytes, base64'd. An
    int-by-int JSON list costs ~40x the encode time at fleet scale (every
    worker baseline re-encodes each cycle); the decoder still accepts the
    old list form, so pre-existing journals restore unchanged."""
    a = np.ascontiguousarray(np.asarray(a), dtype="<i8")
    return {"s": list(a.shape),
            "z": base64.b64encode(a.tobytes()).decode("ascii")}


def _dec_arr(v) -> np.ndarray:
    if isinstance(v, dict):
        return np.frombuffer(base64.b64decode(v["z"]),
                             dtype="<i8").reshape(v["s"]).astype(np.int64)
    return np.asarray(v, np.int64)


def _enc_state(st: dict) -> dict:
    return {f: _enc_arr(a) for f, a in st.items()}


def _dec_state(d: dict) -> dict:
    return {f: _dec_arr(v) for f, v in d.items()}


def _enc_items(items: dict) -> dict:
    ks = sorted(items)
    k = np.fromiter(ks, np.int64, len(ks))
    v = (np.array([items[x] for x in ks], np.int64) if ks
         else np.zeros(0, np.int64))
    return {"k": _enc_arr(k), "v": _enc_arr(v)}


def _dec_items(x) -> dict:
    if isinstance(x, dict):
        k, v = _dec_arr(x["k"]), _dec_arr(x["v"])
        return dict(zip(k.tolist(), v.tolist()))
    return {int(k): int(v) for k, v in x}     # old list-of-pairs journals


class Aggregator:
    """Polls every worker's seqlocked device snapshots, extracts per-cycle
    deltas against a last-seen baseline, and folds them into one global
    view with the commutative merge twins (maps.n_summary_merge /
    n_hash_fetch_add_batch / ringbuf_merge_global).

    Failure/eviction rules:
      * a worker whose registered pid is gone is DEAD: its final on-disk
        snapshot is harvested ONCE (the mmap files outlive the process;
        a crash mid-publish leaves the seqlock odd and forfeits only that
        last delta), then it is excluded from polling — its already-merged
        contribution stays in the global view (summary aggregation keeps
        fleet totals). A dead worker id is RE-ADMITTED, with a fresh
        baseline, once a new incarnation appears under it (boot id
        changed);
      * a worker whose seqlock cannot be read within the retry budget
        (crashed mid-publish) is STALE for the cycle: skipped, baseline
        kept, retried next cycle; it turns dead once its pid goes;
      * a worker whose boot id changed RESTARTED: its baseline resets to
        zero so the fresh process's counts merge from scratch (the old
        incarnation's contribution stays, like a dead worker's);
      * a worker whose seqlock REGRESSED (a restart re-created the section
        under the aggregator — zeroed files, seq back to 0 — before
        worker.json caught up) forfeits that cycle's delta entirely: the
        zeroed snapshot must never fold as a negative delta. Merges are
        snapshot-all-then-fold, so a mid-cycle failure never lands a
        partial merge;
      * a worker whose section read back a CHECKSUM MISMATCH (consistent
        seqlock, damaged payload) is skipped for the cycle exactly like a
        stale one — corruption is detect-and-skip, never silent-merge —
        and counted in `corrupt_skipped`.

    Crash recovery (DESIGN.md §11): with config.journal on, the engine
    persists a fold journal under global/ at the END of every cycle (after
    the publish). A restarted aggregator resumes from the journaled
    accumulators + per-worker baselines: folds the crash lost in memory
    re-extract idempotently against the journaled baselines (worker
    snapshots are cumulative), so no delta is double-folded or lost and
    the recovered global view is bit-identical to an uninterrupted run
    (hash tables republish canonicalized, so accumulator layout drift
    after a restore is invisible).
    """

    # tree position: None = the global root; NodeAggregator overrides with
    # its node id. Children publishing delta streams under nodes/<nid>/ are
    # matched against this to wire the tree.
    _node_id: str | None = None

    def __init__(self, root: str, snapshot_retries: int | None = None,
                 config: AggregatorConfig | None = None):
        self.config = config or AggregatorConfig()
        if snapshot_retries is not None:
            self.config.snapshot_retries = snapshot_retries
        self.snapshot_retries = self.config.snapshot_retries
        self.root = root
        self.specs = SH.read_meta_specs(root)
        self.view = self._make_output()
        # global accumulators
        self.summary = {s.name: M.init_state_np(s) for s in self.specs
                        if M.is_summary_kind(s.kind)}
        self.hash_tbl = {s.name: M.init_state_np(s) for s in self.specs
                         if s.kind == MapKind.HASH}
        # keys lost because the UNION of worker keys overflowed the
        # (spec-sized) global table — counted and surfaced in the status,
        # never silent (the advanced baseline makes the loss permanent)
        self.hash_dropped = {s.name: 0 for s in self.specs
                             if s.kind == MapKind.HASH}
        # ringbuf: per-worker retained tagged records + per-worker heads.
        # rb_offset is each worker's PERMANENT stream base: past
        # incarnations' final heads, so a restarted worker's positions
        # continue after the old incarnation's instead of restarting at 0
        # (the global head must never regress).
        self.rb_tagged: dict[str, dict[str, list]] = \
            {s.name: {} for s in self.specs if s.kind == MapKind.RINGBUF}
        self.rb_heads: dict[str, dict[str, int]] = \
            {s.name: {} for s in self.specs if s.kind == MapKind.RINGBUF}
        self.rb_offset: dict[str, dict[str, int]] = \
            {s.name: {} for s in self.specs if s.kind == MapKind.RINGBUF}
        # per-worker step floor: interleave keys must be monotone in each
        # worker's emit order (maps.ringbuf_merge_global's window
        # argument), so step tags are clamped to never regress — a
        # restarted worker whose steps restart at 0 sorts after its old
        # incarnation, not before it
        self.rb_step_floor: dict[str, dict[str, int]] = \
            {s.name: {} for s in self.specs if s.kind == MapKind.RINGBUF}
        # ringbuf records overwritten in a worker's ring BEFORE the
        # aggregator read them (back-pressure drop accounting, explicit
        # in the status — never silent)
        self.rb_lost: dict[str, dict[str, int]] = \
            {s.name: {} for s in self.specs if s.kind == MapKind.RINGBUF}
        # per-worker poll state; dead maps worker id -> boot id at death,
        # so a NEW incarnation under the same id is re-admitted
        self.workers: dict[str, dict] = {}
        self.dead: dict[str, str | None] = {}
        self.health: dict[str, dict] = {}
        self.corrupt_skipped: dict[str, int] = {}
        self.cycles = 0
        self.merged_updates = 0
        self.coalesced_cycles = 0
        self._publish_lag = 0
        self.last_states: dict = {}
        self._published = False
        self._stragglers: list[str] = []
        self.hb = FT.HeartbeatMonitor(
            num_hosts=0, timeout_s=self.config.heartbeat_timeout_cycles)
        # tree aggregation (DESIGN.md §15): child node-aggregators feed this
        # level through seq-numbered delta streams instead of raw snapshots
        self.nodes: dict[str, dict] = {}
        self.stream_lost: dict[str, int] = {}     # gc'd/corrupt batches
        self.node_coalesced: dict[str, int] = {}  # subtree back-pressure
        self._subtree: dict[str, dict] = {}       # last alive/dead rollup
        self._journal_nodes: dict[str, dict] = {}
        self._journal_due = 0
        # sharded global hash views: root-only, dirty shards republished
        self.shards = None
        self._shard_last: dict[tuple, tuple] = {}
        self.shard_publishes = 0
        if self.config.hash_shards and self._node_id is None:
            self.shards = SH.HashShards.create(
                root, self.specs, int(self.config.hash_shards))
        # crash recovery: resume accumulators + baselines from the fold
        # journal the previous incarnation persisted at its last completed
        # cycle (missing/invalid journal = cold start)
        self._journal_workers: dict[str, dict] = {}
        self._journal_raw: dict | None = None
        if self.config.journal:
            self._restore_journal()

    # -------------------------------------------------------------- tree hooks
    def _make_output(self):
        """Where this level's merged state goes: the root publishes the
        seqlocked global view; a NodeAggregator emits delta batches into
        its stream instead."""
        return GlobalView.create(self.root, self.specs)

    def _who(self) -> str:
        return self._node_id or "global"

    # ---------------------------------------------------------------- journal
    def _journal_path(self) -> str:
        return os.path.join(self.root, "global", "journal.json")

    def _journal_dict(self) -> dict:
        workers = {}
        for wid, w in self.workers.items():
            b = w["base"]
            workers[wid] = {
                "boot": w["boot"], "seq": int(w.get("seq", 0)),
                "base": {
                    "summary": {n: _enc_state(st)
                                for n, st in b["summary"].items()},
                    "hash_items": {n: _enc_items(d)
                                   for n, d in b["hash_items"].items()},
                    "rb_head": {n: int(v)
                                for n, v in b["rb_head"].items()},
                }}
        return {
            "version": 1,
            "cycles": self.cycles,
            "merged_updates": self.merged_updates,
            "coalesced_cycles": self.coalesced_cycles,
            "summary": {n: _enc_state(st) for n, st in self.summary.items()},
            "hash_items": {n: _enc_items(M.n_hash_items(t))
                           for n, t in self.hash_tbl.items()},
            "hash_dropped": dict(self.hash_dropped),
            "rb_tagged": {n: {wid: [[list(tag), [int(x) for x in rec]]
                                    for tag, rec in buf]
                              for wid, buf in d.items()}
                          for n, d in self.rb_tagged.items()},
            "rb_heads": {n: dict(d) for n, d in self.rb_heads.items()},
            "rb_offset": {n: dict(d) for n, d in self.rb_offset.items()},
            "rb_step_floor": {n: dict(d)
                              for n, d in self.rb_step_floor.items()},
            "rb_lost": {n: dict(d) for n, d in self.rb_lost.items()},
            "corrupt_skipped": dict(self.corrupt_skipped),
            "dead": dict(self.dead),
            "workers": workers,
            "health": self.health,
            "hb_last": dict(self.hb.last),
            # tree: consumption cursors per child node stream. The stream
            # writer only GCs batches at or below the JOURNALED cursor (we
            # ack after journaling), so a crashed parent re-reads anything
            # folded-but-unjournaled idempotently.
            "node_children": {nid: {"boot": nc["boot"],
                                    "last_seq": int(nc["last_seq"]),
                                    "retired": bool(nc.get("retired"))}
                              for nid, nc in self.nodes.items()},
            "stream_lost": dict(self.stream_lost),
            "node_coalesced": dict(self.node_coalesced),
        }

    def _restore_journal(self) -> None:
        p = self._journal_path()
        if not os.path.exists(p):
            return
        try:
            with open(p) as f:
                j = json.load(f)
        except (OSError, ValueError):
            return               # unreadable journal: cold start
        if j.get("version") != 1:
            return
        self._journal_raw = j
        spec_of = {s.name: s for s in self.specs}
        self.cycles = int(j["cycles"])
        self.merged_updates = int(j["merged_updates"])
        self.coalesced_cycles = int(j.get("coalesced_cycles", 0))
        for n, d in j["summary"].items():
            if n in self.summary:
                self.summary[n] = _dec_state(d)
        for n, items in j["hash_items"].items():
            if n in self.hash_tbl:
                # canonical rebuild: content identical; layout drift is
                # invisible because publishes canonicalize again
                self.hash_tbl[n] = M.n_hash_canonical(
                    spec_of[n], _dec_items(items))
        self.hash_dropped.update(
            {n: int(v) for n, v in j["hash_dropped"].items()
             if n in self.hash_dropped})
        for n, d in j["rb_tagged"].items():
            if n in self.rb_tagged:
                self.rb_tagged[n] = {
                    wid: [(tuple(tag), np.asarray(rec, np.int64))
                          for tag, rec in buf]
                    for wid, buf in d.items()}
        for attr in ("rb_heads", "rb_offset", "rb_step_floor", "rb_lost"):
            mine = getattr(self, attr)
            for n, d in j[attr].items():
                if n in mine:
                    mine[n] = {wid: int(v) for wid, v in d.items()}
        self.corrupt_skipped = {w: int(v)
                                for w, v in j["corrupt_skipped"].items()}
        self._journal_nodes = {nid: dict(nc) for nid, nc in
                               j.get("node_children", {}).items()}
        self.stream_lost = {nid: int(v) for nid, v in
                            j.get("stream_lost", {}).items()}
        self.node_coalesced = {nid: int(v) for nid, v in
                               j.get("node_coalesced", {}).items()}
        self.dead = dict(j["dead"])
        self.health = j["health"]
        self.hb.last = {w: float(t) for w, t in j.get("hb_last", {}).items()}
        for wid, w in j["workers"].items():
            b = w["base"]
            self._journal_workers[wid] = {
                "boot": w["boot"], "seq": int(w["seq"]),
                "base": {
                    "summary": {n: _dec_state(st)
                                for n, st in b["summary"].items()},
                    "hash_items": {n: _dec_items(items)
                                   for n, items in b["hash_items"].items()},
                    "rb_head": {n: int(v)
                                for n, v in b["rb_head"].items()},
                }}

    # ---------------------------------------------------------------- workers
    def _fresh_baseline(self) -> dict:
        return {"summary": {s.name: M.init_state_np(s) for s in self.specs
                            if M.is_summary_kind(s.kind)},
                "hash_items": {s.name: {} for s in self.specs
                               if s.kind == MapKind.HASH},
                "rb_head": {s.name: 0 for s in self.specs
                            if s.kind == MapKind.RINGBUF}}

    def _worker_candidates(self) -> list[str]:
        """Workers THIS level polls directly. The root skips every worker a
        registered node-aggregator claims (dead or alive: the node's stream
        is that worker's only fold path — folding it directly too would
        double-count); NodeAggregator overrides with its assigned group."""
        claimed = SH.claimed_workers(self.root)
        return [w for w in SH.list_workers(self.root) if w not in claimed]

    def _discover(self) -> None:
        for wid in self._worker_candidates():
            if wid in self.workers:
                continue
            boot = SH.worker_info(self.root, wid).get("boot")
            if wid in self.dead:
                if boot == self.dead[wid]:
                    continue            # same incarnation: stays retired
                del self.dead[wid]      # new incarnation: re-admit
                for name in self.rb_offset:
                    self.rb_offset[name][wid] = \
                        self.rb_heads[name].get(wid, 0)
                self._set_state(wid, HEALTHY, "new_incarnation")
            jw = self._journal_workers.pop(wid, None)
            if jw is not None and jw["boot"] == boot:
                # crash recovery: resume from the journaled baseline, so
                # deltas the previous incarnation folded in memory (after
                # its last journal write) re-extract — and already-journaled
                # folds don't re-extract (idempotent re-fold)
                base, seq, adopt = jw["base"], jw["seq"], False
            else:
                # adopt mode (node cold start without a journal but with
                # emitted stream history): the first snapshot becomes the
                # baseline WITHOUT folding — already-emitted content must
                # never re-emit (forfeit the gap, never double-fold)
                base, seq = self._fresh_baseline(), 0
                adopt = getattr(self, "_adopt_admits", False)
            self.workers[wid] = {
                "region": ShmRegion.attach(self.root, mode="r",
                                           worker_id=wid),
                "boot": boot,
                "base": base,
                "seq": seq,
                "adopt": adopt,
            }
            if wid not in self.health:
                self.health[wid] = _fresh_health()
                self.hb.beat(wid, t=float(self.cycles))

    def _check_restart(self, wid: str, w: dict) -> None:
        boot = SH.worker_info(self.root, wid).get("boot")
        if boot != w["boot"]:
            w["boot"] = boot
            w["base"] = self._fresh_baseline()
            w["seq"] = 0
            w["adopt"] = False   # a fresh incarnation's deltas DO fold
            w["region"] = ShmRegion.attach(self.root, mode="r",
                                           worker_id=wid)
            # the old incarnation's ringbuf contribution stays: its final
            # head becomes the new incarnation's stream base
            for name in self.rb_offset:
                self.rb_offset[name][wid] = self.rb_heads[name].get(wid, 0)

    # ---------------------------------------------------------------- merge
    def _snapshot_worker(self, wid: str, w: dict,
                         retries: int | None = None) -> dict:
        """Seqlocked snapshot of ALL of one worker's maps (none folded yet,
        so a failure mid-cycle never lands a partial merge). Raises
        TimeoutError if the seqlock never settles, SnapshotCorruption on a
        checksum mismatch (damaged bytes behind a consistent seqlock),
        SeqRegression if the section was re-created under us (restart mid
        detection: zeroed files must never fold as a negative delta)."""
        cfg = self.config
        retries = cfg.snapshot_retries if retries is None else retries
        region = w["region"]
        snaps = {}
        seq_seen = w.get("seq", 0)
        for spec in self.specs:
            cur, seq, _ = region.snapshot_device_meta(
                spec.name, retries=retries,
                backoff_base=cfg.backoff_base, backoff_max=cfg.backoff_max)
            if seq < w.get("seq", 0):
                raise SeqRegression(wid)
            seq_seen = max(seq_seen, seq)
            snaps[spec.name] = cur
        w["seq"] = seq_seen
        return snaps

    def _adopt_baseline(self, wid: str, w: dict, snaps: dict) -> None:
        """Adopt-mode admission: the snapshot becomes the baseline without
        folding. Used when a node aggregator cold-starts over a stream it
        already emitted into (journal lost): the worker's cumulative state
        includes content the previous incarnation already emitted — fold
        nothing, forfeit the gap, never double-emit."""
        base = w["base"]
        for spec in self.specs:
            cur = snaps[spec.name]
            if M.is_summary_kind(spec.kind):
                base["summary"][spec.name] = cur
            elif spec.kind == MapKind.HASH:
                base["hash_items"][spec.name] = M.n_hash_items(cur)
            elif spec.kind == MapKind.RINGBUF:
                lane = spec.flags.get("step_lane")
                _, head = M.n_ringbuf_tagged(cur, wid, lo=0, step_lane=lane)
                base["rb_head"][spec.name] = head
                # align the permanent stream so the NEXT record's global
                # position continues right after the last emitted head
                self.rb_offset[spec.name][wid] = \
                    self.rb_heads[spec.name].get(wid, 0) - head

    def _fold_worker(self, wid: str, w: dict, snaps: dict) -> int:
        """Delta + fold of one worker's snapshots into this level's
        accumulators. Returns the number of updates merged."""
        if w.pop("adopt", False):
            self._adopt_baseline(wid, w, snaps)
            return 0
        base = w["base"]
        updates = 0
        for spec in self.specs:
            cur = snaps[spec.name]
            if M.is_summary_kind(spec.kind):
                delta = M.n_summary_delta(spec, cur, base["summary"][spec.name])
                M.n_summary_merge(spec, self.summary[spec.name], delta)
                updates += int(sum(np.abs(d).sum() for d in delta.values()))
                base["summary"][spec.name] = cur
            elif spec.kind == MapKind.HASH:
                items = M.n_hash_items(cur)
                adds, dels = M.n_hash_delta(items,
                                            base["hash_items"][spec.name])
                if adds:
                    keys = np.array([k for k, _ in adds], np.int64)
                    deltas = np.array([d for _, d in adds], np.int64)
                    M.n_hash_fetch_add_batch(self.hash_tbl[spec.name],
                                             keys, deltas)
                    resident = M.n_hash_slots(self.hash_tbl[spec.name])
                    lost = sum(1 for k, _ in adds if k not in resident)
                    self.hash_dropped[spec.name] += lost
                for k in dels:
                    M.n_hash_delete(self.hash_tbl[spec.name], k)
                updates += len(adds) + len(dels)
                base["hash_items"][spec.name] = items
            elif spec.kind == MapKind.RINGBUF:
                updates += self._fold_rb(spec, wid, base, cur)
        return updates

    def _fold_rb(self, spec: MapSpec, wid: str, base: dict,
                 cur: dict) -> int:
        """Fold one worker's ringbuf snapshot (shared by the per-worker and
        the node-level group fold paths — rings stay per-worker tuples)."""
        lane = spec.flags.get("step_lane")
        lo = base["rb_head"][spec.name]
        tagged, head = M.n_ringbuf_tagged(
            cur, wid, lo=lo, step_lane=lane)
        # records the ring overwrote before we read them — the
        # aggregator fell behind; accounted, never silent
        lost = max(0, (head - spec.max_entries) - lo)
        if lost:
            self.rb_lost[spec.name][wid] = \
                self.rb_lost[spec.name].get(wid, 0) + lost
        # shift this incarnation's local positions onto the
        # worker's permanent stream, and clamp step tags to the
        # worker's floor: the interleave key stays monotone in
        # emit order across restarts (records keep their real
        # step values — only the sort tags are clamped)
        off = self.rb_offset[spec.name].get(wid, 0)
        floor = self.rb_step_floor[spec.name].get(wid, 0)
        adj = []
        for (s, w_, i), rec in tagged:
            floor = max(floor, s)
            adj.append(((floor, w_, off + i), rec))
        tagged = adj
        self.rb_step_floor[spec.name][wid] = floor
        buf = self.rb_tagged[spec.name].setdefault(wid, [])
        buf.extend(tagged)
        del buf[:-spec.max_entries]     # ring retention mirror
        self.rb_heads[spec.name][wid] = off + head
        base["rb_head"][spec.name] = head
        return len(tagged)

    def _merge_worker(self, wid: str, w: dict,
                      retries: int | None = None) -> int:
        """Snapshot-all-then-fold for one worker (harvest/compat path)."""
        snaps = self._snapshot_worker(wid, w, retries=retries)
        return self._fold_worker(wid, w, snaps)

    # ---------------------------------------------------------------- health
    def _set_state(self, wid: str, to: str, reason: str) -> None:
        h = self.health.setdefault(wid, _fresh_health())
        if h["state"] != to:
            h["transitions"].append([self.cycles, h["state"], to, reason])
            h["state"] = to

    def _fail_event(self, wid: str, reason: str) -> None:
        h = self.health.setdefault(wid, _fresh_health())
        h["consec_fail"] += 1
        self._set_state(wid, STALE, reason)
        if not h["quarantined"] and \
                h["consec_fail"] >= self.config.quarantine_after:
            h["quarantined"] = True
            h["transitions"].append([self.cycles, STALE, STALE,
                                     "quarantined"])

    def _ok_event(self, wid: str, advanced: bool) -> None:
        h = self.health.setdefault(wid, _fresh_health())
        h["consec_fail"] = 0
        if h["quarantined"]:
            h["quarantined"] = False
            h["transitions"].append([self.cycles, h["state"], h["state"],
                                     "readmitted"])
        if advanced:
            h["no_advance"] = 0
            if h["state"] != HEALTHY:
                self._set_state(wid, HEALTHY, "recovered")
            self.hb.beat(wid, t=float(self.cycles))
        else:
            h["no_advance"] += 1
            if h["state"] == HEALTHY and \
                    h["no_advance"] >= self.config.degraded_after:
                self._set_state(wid, DEGRADED, "no_seq_advance")

    def _detect_stragglers(self) -> list[str]:
        """ft wiring: per-step wall times the workers' sys_step_end probes
        publish into a host ARRAY map become the daemon's straggler signal
        (paper SP4 — no cooperation from the trainer needed)."""
        name = self.config.step_time_map
        if not name:
            return []
        wids, rows = [], []
        for wid in sorted(self.workers):
            host = self.workers[wid]["region"].host
            if name in host:
                wids.append(wid)
                rows.append(np.asarray(host[name]["values"],
                                       np.float64).reshape(-1))
        if not rows:
            return []
        idx = FT.detect_stragglers(
            np.stack(rows), factor=self.config.straggler_factor,
            min_samples=self.config.straggler_min_samples)
        return [wids[i] for i in idx]

    # ---------------------------------------------------------------- cycle
    def poll_once(self) -> dict:
        """One aggregation cycle: discover, poll, merge, publish, journal.
        Returns the status dict also written to <dir>/global/status.json."""
        cfg = self.config
        faults.fire("agg:cycle_begin", cycle=self.cycles, who=self._who())
        self._discover()
        stale = []
        cycle_updates = 0
        polled = []
        for wid in sorted(self.workers):
            w = self.workers[wid]
            faults.fire("agg:pre_merge", wid=wid, cycle=self.cycles,
                        who=self._who())
            # restart detection FIRST, even for a dead worker: a worker
            # that restarted AND died within one poll interval must be
            # harvested against the new incarnation's (zero) baseline and
            # recorded dead under the new boot id — else its contribution
            # would be mis-diffed now and double-counted on re-admission
            self._check_restart(wid, w)
            if not SH.worker_alive(self.root, wid):
                try:        # harvest the final snapshot, then retire
                    cycle_updates += self._merge_worker(wid, w)
                except (TimeoutError, SeqRegression, SnapshotCorruption):
                    pass    # died mid-publish / restart under way:
                            # the last delta is forfeit
                self.dead[wid] = w["boot"]
                del self.workers[wid]
                self._set_state(wid, DEAD, "pid_gone")
                continue
            h = self.health.setdefault(wid, _fresh_health())
            retries = (cfg.quarantine_probe_retries if h["quarantined"]
                       else cfg.snapshot_retries)
            seq_before = w.get("seq", 0)
            try:
                snaps = self._snapshot_worker(wid, w, retries=retries)
            except SnapshotCorruption:
                self.corrupt_skipped[wid] = \
                    self.corrupt_skipped.get(wid, 0) + 1
                stale.append(wid)
                self._fail_event(wid, "snapshot_corrupt")
            except TimeoutError:
                stale.append(wid)       # crashed mid-publish? retry next
                self._fail_event(wid, "seqlock_timeout")
            except SeqRegression:
                stale.append(wid)
                self._fail_event(wid, "seq_regression")
            else:
                polled.append((wid, w, snaps, seq_before))
        # fold phase: every snapshot already taken, so a fold is pure-local
        # (NodeAggregator overrides this with one batched device pass over
        # the whole group)
        cycle_updates += self._fold_polled(polled)
        # tree: fold child node-aggregators' delta-stream batches
        cycle_updates += self._poll_node_children()
        self._stragglers = self._detect_stragglers()
        for wid in self._stragglers:
            if self.health.get(wid, {}).get("state") == HEALTHY:
                self._set_state(wid, DEGRADED, "straggler")
        self.merged_updates += cycle_updates
        self.cycles += 1
        # rebuild + republish only when something merged: idle polling
        # stays O(workers), not O(total map state). Back-pressure: while a
        # cycle folds more than coalesce_threshold updates the rebuild is
        # skipped (deltas coalesce in the accumulators; ring overruns are
        # counted in rb_lost), but never for more than publish_max_lag
        # cycles.
        publish_now = self._publish_cycle(cycle_updates)
        faults.fire("agg:pre_journal", who=self._who())
        self._maybe_journal(publish_now)
        hb_dead = [w for w in self.hb.dead(now=float(self.cycles))
                   if w in self.workers]
        status = {
            # alive/dead roll up the whole subtree: direct workers plus
            # everything the child-node batches reported below them
            "alive": sorted(set(self.workers) | {
                a for st in self._subtree.values()
                for a in st.get("alive", [])}),
            "dead": sorted(set(self.dead) | {
                d for st in self._subtree.values()
                for d in st.get("dead", [])}),
            "stale": stale,
            "cycles": self.cycles,
            "merged_updates": self.merged_updates,
            "hash_dropped": dict(self.hash_dropped),
            "rb_heads": {n: dict(h) for n, h in self.rb_heads.items()},
            "rb_lost": {n: dict(d) for n, d in self.rb_lost.items()},
            "corrupt_skipped": dict(self.corrupt_skipped),
            "coalesced_cycles": self.coalesced_cycles,
            "stragglers": self._stragglers,
            "hb_dead": hb_dead,
            "health": {w: {"state": h["state"],
                           "quarantined": h["quarantined"],
                           "transitions": h["transitions"]}
                       for w, h in self.health.items()},
            # tree: per-child-node consumption + back-pressure rollup
            "nodes": {nid: {"state": self.health.get(nid, {}).get(
                                "state", HEALTHY),
                            "last_seq": int(nc["last_seq"]),
                            "alive": not nc.get("retired", False),
                            "workers": nc.get("workers", []),
                            "subtree": self._subtree.get(nid, {})}
                      for nid, nc in self.nodes.items()},
            "stream_lost": dict(self.stream_lost),
            "node_coalesced": dict(self.node_coalesced),
            "hash_shards": int(self.config.hash_shards or 0),
            "shard_publishes": self.shard_publishes,
            "time": time.time(),
        }
        self._publish_status(status)
        faults.fire("agg:cycle_end", cycle=self.cycles, who=self._who())
        return status

    def _fold_polled(self, polled: list) -> int:
        """Fold every successfully-snapshotted worker, in worker-id order."""
        updates = 0
        for wid, w, snaps, seq_before in polled:
            updates += self._fold_worker(wid, w, snaps)
            faults.fire("agg:post_merge", wid=wid, who=self._who())
            self._ok_event(wid, advanced=w.get("seq", 0) > seq_before)
        return updates

    def _publish_cycle(self, cycle_updates: int) -> bool:
        """Rebuild + publish the global view (coalescing under
        back-pressure). Returns whether an output event happened this
        cycle; NodeAggregator overrides to emit a delta batch instead."""
        cfg = self.config
        publish_now = (bool(cycle_updates) or not self._published
                       or self._publish_lag > 0)   # flush pending coalesce
        if (publish_now and cfg.coalesce_threshold is not None
                and self._published
                and cycle_updates > cfg.coalesce_threshold
                and self._publish_lag + 1 < cfg.publish_max_lag):
            self._publish_lag += 1
            self.coalesced_cycles += 1
            publish_now = False
        if publish_now:
            self._publish_lag = 0
            faults.fire("agg:pre_publish", who=self._who())
            self.last_states = self.global_states()
            self.view.publish(self.last_states)
            self._publish_shards()
            self._published = True
            faults.fire("agg:post_publish", who=self._who())
        return publish_now

    def _publish_shards(self) -> None:
        """Republish DIRTY shards of the sharded global hash views: a
        shard whose key-partition content didn't change since its last
        publish is skipped, so steady-state republish cost scales with the
        touched keyspace, not the table size."""
        if self.shards is None:
            return
        n_sh = self.shards.n_shards
        for spec in self.specs:
            if spec.kind != MapKind.HASH:
                continue
            ck, cv = M.n_hash_content(self.hash_tbl[spec.name])
            sh = M.n_shard_of_keys(ck, spec.max_entries, n_sh)
            for s in range(n_sh):
                m = sh == s
                k_s, v_s = ck[m], cv[m]
                last = self._shard_last.get((spec.name, s))
                if last is not None and np.array_equal(last[0], k_s) \
                        and np.array_equal(last[1], v_s):
                    continue
                st = M.n_hash_canonical(
                    spec, dict(zip(k_s.tolist(), v_s.tolist())))
                self.shards.publish(spec.name, s, st)
                self._shard_last[(spec.name, s)] = (k_s, v_s)
                self.shard_publishes += 1

    def _publish_status(self, status: dict) -> None:
        self.view.publish_status(status)

    def _maybe_journal(self, output_happened: bool) -> None:
        cfg = self.config
        if not cfg.journal:
            # no crash-consistency promised: release child batches eagerly
            for nc in self.nodes.values():
                if nc.get("stream") is not None:
                    nc["stream"].ack(nc["last_seq"])
            return
        self._journal_due += 1
        if self._journal_due < max(1, cfg.journal_every):
            return
        if not self._journal_ok(output_happened):
            return
        SH._atomic_json(self._journal_path(), self._journal_dict())
        self._journal_due = 0
        self._post_journal()
        # ack only what the journal now covers: the stream writer GCs
        # acked batches, and a crashed parent must be able to re-read
        # anything newer than its last journal
        for nc in self.nodes.values():
            if nc.get("stream") is not None:
                nc["stream"].ack(nc["last_seq"])

    def _journal_ok(self, output_happened: bool) -> bool:
        return True          # root: any cycle boundary is consistent

    def _post_journal(self) -> None:
        pass

    # ------------------------------------------------------------ tree fold
    def _discover_nodes(self) -> None:
        """Admit child node-aggregators (nodes whose registered parent is
        this level). Dead nodes follow the worker rules: harvested once,
        retired, re-admitted with their stream cursor intact when a new
        incarnation (boot change) appears."""
        for nid in SH.list_nodes(self.root):
            info = SH.node_info(self.root, nid)
            if info.get("parent") != self._node_id:
                continue
            boot = info.get("boot")
            cur = self.nodes.get(nid)
            if cur is not None and cur["boot"] == boot:
                continue
            if cur is not None:
                last = int(cur["last_seq"])     # restart: cursor continues
                self._set_state(nid, HEALTHY, "new_incarnation")
            else:
                jn = self._journal_nodes.pop(nid, None)
                last = int(jn["last_seq"]) if jn else 0
            stream = (SH.DeltaStream.attach(self.root, nid)
                      if SH.DeltaStream.exists(self.root, nid) else None)
            if stream is not None and stream.head() < last:
                last = 0        # stream was wiped: node re-emits from zero
            self.nodes[nid] = {
                "boot": boot, "stream": stream, "last_seq": last,
                "workers": info.get("workers", []),
                "children": info.get("children", []),
            }
            if nid not in self.health:
                self.health[nid] = _fresh_health()
                self.hb.beat(nid, t=float(self.cycles))

    def _poll_node_children(self) -> int:
        """Consume every child node's delta stream past our cursor and fold
        the batches. Batches are idempotent WAL entries: a crashed parent
        re-reads anything past its journaled cursor; corrupt or GC'd-away
        batches are detect-and-skip, counted in stream_lost."""
        self._discover_nodes()
        updates = 0
        for nid in sorted(self.nodes):
            nc = self.nodes[nid]
            if nc.get("retired"):
                continue
            stream = nc.get("stream")
            if stream is None:
                if SH.DeltaStream.exists(self.root, nid):
                    nc["stream"] = stream = \
                        SH.DeltaStream.attach(self.root, nid)
                else:
                    continue
            faults.fire("agg:pre_merge", wid=nid, cycle=self.cycles,
                        who=self._who())
            before = nc["last_seq"]
            for seq, payload in stream.poll(nc["last_seq"]):
                if payload is None:
                    self.stream_lost[nid] = \
                        self.stream_lost.get(nid, 0) + 1
                else:
                    updates += self._fold_batch(nid, payload)
                nc["last_seq"] = seq
            faults.fire("agg:post_merge", wid=nid, who=self._who())
            if not SH.node_alive(self.root, nid):
                # harvest-once then retire (same contract as dead workers:
                # the merged contribution stays; a new boot re-admits)
                nc["retired"] = True
                self._set_state(nid, DEAD, "node_gone")
            else:
                self._ok_event(nid, advanced=nc["last_seq"] > before)
        return updates

    def _fold_batch(self, nid: str, payload: dict) -> int:
        """Fold one child delta batch into this level's accumulators. Every
        piece is commutative/idempotent-by-construction: summary deltas
        add, hash adds re-coalesce, ringbuf records carry their original
        (step, wid, pos) tags end-to-end (replayed positions below our
        per-worker head are skipped)."""
        js = payload["json"]
        arrs = payload["arrays"]
        spec_of = {s.name: s for s in self.specs}
        for key, arr in arrs.items():
            parts = key.split("/")
            if parts[0] == "summary" and parts[1] in self.summary:
                with np.errstate(over="ignore"):
                    self.summary[parts[1]][parts[2]] += \
                        np.asarray(arr, np.int64)
        for name in self.hash_tbl:
            ak = arrs.get(f"hash/{name}/keys")
            if ak is not None and ak.size:
                ad = np.asarray(arrs[f"hash/{name}/deltas"], np.int64)
                ak = np.asarray(ak, np.int64)
                M.n_hash_fetch_add_batch(self.hash_tbl[name], ak, ad)
                res_k, _ = M.n_hash_content(self.hash_tbl[name])
                lost = int(np.count_nonzero(~np.isin(ak, res_k)))
                if lost:
                    self.hash_dropped[name] += lost
            for k in js.get("hash_dels", {}).get(name, []):
                M.n_hash_delete(self.hash_tbl[name], int(k))
        for name, per_wid in js.get("rb_meta", {}).items():
            if name not in self.rb_tagged:
                continue
            spec = spec_of[name]
            for wid, meta in per_wid.items():
                buf = self.rb_tagged[name].setdefault(wid, [])
                cur_head = self.rb_heads[name].get(wid, 0)
                steps = arrs.get(f"rb/{name}/{wid}/steps")
                if steps is not None and np.asarray(steps).size:
                    poss = np.asarray(arrs[f"rb/{name}/{wid}/pos"],
                                      np.int64)
                    recs = np.asarray(arrs[f"rb/{name}/{wid}/recs"],
                                      np.int64)
                    for s, p, rec in zip(
                            np.asarray(steps, np.int64).tolist(),
                            poss.tolist(), recs):
                        if p < cur_head:
                            continue    # replayed batch: already folded
                        buf.append(((int(s), wid, int(p)), rec))
                    del buf[:-spec.max_entries]
                self.rb_heads[name][wid] = max(cur_head,
                                               int(meta["head"]))
                self.rb_step_floor[name][wid] = max(
                    self.rb_step_floor[name].get(wid, 0),
                    int(meta.get("floor", 0)))
                lost_d = int(meta.get("lost_delta", 0))
                if lost_d:
                    self.rb_lost[name][wid] = \
                        self.rb_lost[name].get(wid, 0) + lost_d
        for name, v in js.get("hash_dropped_delta", {}).items():
            if name in self.hash_dropped:
                self.hash_dropped[name] += int(v)
        for wid, v in js.get("corrupt_delta", {}).items():
            self.corrupt_skipped[wid] = \
                self.corrupt_skipped.get(wid, 0) + int(v)
        if js.get("coalesced_delta"):
            self.node_coalesced[nid] = \
                self.node_coalesced.get(nid, 0) + int(js["coalesced_delta"])
        for wid, h in js.get("health", {}).items():
            self.health[wid] = h        # transitive subtree health rollup
        self._subtree[nid] = {"alive": js.get("alive", []),
                              "dead": js.get("dead", []),
                              "stream_lost": js.get("stream_lost", {})}
        return int(js.get("updates", 0))

    def global_states(self) -> dict:
        """The merged global view, deterministic for a given set of worker
        contributions: summary kinds are element-wise sums, hash tables are
        canonicalized (sorted-key rebuild), ringbufs are the (step, wid,
        seq) interleave of every worker's retained records."""
        out = {}
        for spec in self.specs:
            if M.is_summary_kind(spec.kind):
                out[spec.name] = {f: a.copy()
                                  for f, a in self.summary[spec.name].items()}
            elif spec.kind == MapKind.HASH:
                items = M.n_hash_items(self.hash_tbl[spec.name])
                out[spec.name] = M.n_hash_canonical(spec, items)
            elif spec.kind == MapKind.RINGBUF:
                tagged = [t for buf in self.rb_tagged[spec.name].values()
                          for t in buf]
                total = sum(self.rb_heads[spec.name].values())
                out[spec.name] = M.ringbuf_merge_global(spec, tagged, total)
        return out

    def loop(self, watch: float | None = None, once: bool = False,
             out=sys.stdout) -> None:
        watch = self.config.poll_interval if watch is None else watch
        while True:
            status = self.poll_once()
            print(f"=== {time.strftime('%H:%M:%S')} agg cycle "
                  f"{status['cycles']} alive={status['alive']} "
                  f"dead={status['dead']} stale={status['stale']} "
                  f"merged={status['merged_updates']}", file=out)
            for spec in self.specs:
                if spec.name in self.last_states:
                    print("\n".join(_summarize_state(
                        spec, self.last_states[spec.name])), file=out)
            if once:
                break
            time.sleep(watch)


# --------------------------------------------------------------------------
# bpftool-style CLI
# --------------------------------------------------------------------------

_SUBCOMMANDS = ("map", "prog", "attach", "detach", "agg", "node", "fleet")


def _section_loader(root: str, section: str, worker: str | None):
    """One attach for the whole CLI invocation; returns name -> state."""
    if section == "global":
        view = GlobalView.attach(root)
        return view.snapshot
    region = ShmRegion.attach(root, mode="r", worker_id=worker)
    if section == "device":
        return region.snapshot_device
    return lambda name: {f: np.array(a) for f, a in region.host[name].items()}


def _default_section(root: str) -> str:
    return "global" if GlobalView.exists(root) else "device"


def _state_to_json(spec: MapSpec, st: dict) -> dict:
    return {"name": spec.name, "kind": spec.kind.value,
            **{f: np.asarray(a).tolist() for f, a in st.items()}}


def _top_entries(spec: MapSpec, st: dict, n: int) -> list[tuple]:
    """(key, value) rows sorted by value desc — bpftool's `map top`."""
    if spec.kind == MapKind.ARRAY:
        vals = np.asarray(st["values"])
        idx = np.argsort(-vals, kind="stable")[:n]
        return [(int(i), int(vals[i])) for i in idx if vals[i] != 0]
    if spec.kind == MapKind.PERCPU_ARRAY:
        tot = np.asarray(st["values"]).sum(axis=0)
        idx = np.argsort(-tot, kind="stable")[:n]
        return [(int(i), int(tot[i])) for i in idx if tot[i] != 0]
    if spec.kind == MapKind.HASH:
        items = M.n_hash_items(st)
        return sorted(items.items(), key=lambda kv: (-kv[1], kv[0]))[:n]
    if spec.kind == MapKind.LOG2HIST:
        bins = np.asarray(st["bins"])
        idx = np.argsort(-bins, kind="stable")[:n]
        return [(int(i), int(bins[i])) for i in idx if bins[i] != 0]
    if spec.kind == MapKind.RINGBUF:
        recs, _ = M.n_ringbuf_drain(
            {f: np.asarray(a) for f, a in st.items()}, 0)
        return [(i, tuple(r)) for i, r in enumerate(recs[-n:])]
    return []


def _cmd_map_shard(root: str, args) -> int:
    """`map dump|top --shard K`: one keyspace partition of the sharded
    global hash views (global/shards/), seqlock+CRC consistent."""
    if not SH.HashShards.exists(root):
        print("no sharded views published — run `agg --shards K` first",
              file=sys.stderr)
        return 1
    shards = SH.HashShards.attach(root)
    meta = SH.HashShards.read_meta(root)
    k = int(args.shard)
    if not 0 <= k < meta["n_shards"]:
        print(f"shard {k} out of range (n_shards={meta['n_shards']})",
              file=sys.stderr)
        return 1
    specs = [s for s in SH.read_meta_specs(root)
             if s.kind == MapKind.HASH and args.name in (None, s.name)]
    if not specs:
        print(f"no hash map matches {args.name!r} (shards hold hash maps "
              f"only)", file=sys.stderr)
        return 1
    out_json = []
    for spec in specs:
        st, seq, _ = shards.snapshot(spec.name, k)
        if args.action == "dump":
            if args.json:
                out_json.append({**_state_to_json(spec, st),
                                 "shard": k, "seq": seq})
            else:
                print(f"# shard={k}/{meta['n_shards']} seq={seq}")
                print("\n".join(_summarize_state(spec, st)))
        else:
            rows = _top_entries(spec, st, args.top_n)
            if args.json:
                out_json.append({"name": spec.name, "shard": k,
                                 "top": rows})
            else:
                print(f"[{spec.name}] shard {k}/{meta['n_shards']} "
                      f"top {len(rows)}:")
                for key, v in rows:
                    print(f"  {key:>8} : {v}")
    if args.json:
        print(json.dumps(out_json, indent=1))
    return 0


def _drop_accounting(root: str) -> list[str]:
    """Back-pressure/drop counters from the aggregation status, for the
    `map` footer: what the numbers being dumped do NOT include."""
    if not GlobalView.exists(root):
        return []
    status = GlobalView.attach(root).read_status()
    lines = []
    rb_lost = {n: d for n, d in status.get("rb_lost", {}).items()
               if any(d.values())}
    if rb_lost:
        lines.append(f"rb_lost={rb_lost}")
    hd = {n: v for n, v in status.get("hash_dropped", {}).items() if v}
    if hd:
        lines.append(f"hash_dropped={hd}")
    if status.get("coalesced_cycles"):
        lines.append(f"coalesced_cycles={status['coalesced_cycles']}")
    sl = {n: v for n, v in status.get("stream_lost", {}).items() if v}
    if sl:
        lines.append(f"stream_lost={sl}")
    return lines


def _cmd_map(root: str, args) -> int:
    if getattr(args, "shard", None) is not None:
        return _cmd_map_shard(root, args)
    specs = SH.read_meta_specs(root)
    section = args.section or _default_section(root)
    wids = SH.list_workers(root)
    if section == "global" and not GlobalView.exists(root):
        print("no global view published yet — run `agg` first, or pass "
              "--section device --worker W", file=sys.stderr)
        return 1
    if section in ("device", "host") and wids and args.worker is None:
        print(f"fleet layout: pass --worker (workers: {', '.join(wids)})",
              file=sys.stderr)
        return 1
    if args.worker is not None and _check_workers(root, [args.worker]):
        return 1
    chosen = [s for s in specs if args.name in (None, s.name)]
    if not chosen:
        print(f"no such map: {args.name}", file=sys.stderr)
        return 1
    load = _section_loader(root, section, args.worker)
    out_json = []
    for spec in chosen:
        st = load(spec.name)
        if args.action == "dump":
            if args.json:
                out_json.append(_state_to_json(spec, st))
            else:
                print(f"# section={section}"
                      + (f" worker={args.worker}" if args.worker else ""))
                print("\n".join(_summarize_state(spec, st)))
        else:  # top
            rows = _top_entries(spec, st, args.top_n)
            if args.json:
                out_json.append({"name": spec.name, "top": rows})
            else:
                print(f"[{spec.name}] top {len(rows)} ({section}):")
                for k, v in rows:
                    print(f"  {k:>8} : {v}")
    if args.json:
        print(json.dumps(out_json, indent=1))
    elif section == "global":
        footer = _drop_accounting(root)
        if footer:
            print("# drops: " + " ".join(footer))
    return 0


def _worker_cache_counters(root: str) -> dict:
    """wid -> artifact-cache hit/miss counters, from worker status.json."""
    out = {}
    for wid in SH.list_workers(root) or [None]:
        try:
            status = ShmRegion.attach(root, mode="r",
                                      worker_id=wid).read_status()
        except OSError:
            continue
        if status.get("cache"):
            out[wid or "-"] = status["cache"]
    return out


def _cmd_prog_cache(root: str, args) -> int:
    """`prog cache ls|stat|purge [KEY]` over the fleet artifact cache at
    <root>/cache (the directory setup_shm auto-joins)."""
    from .artifact_cache import ArtifactCache
    action = args.arg or "stat"
    if action not in ("ls", "stat", "purge"):
        print(f"prog cache: unknown action {action!r} (ls|stat|purge)",
              file=sys.stderr)
        return 2
    cache = ArtifactCache(os.path.join(root, "cache"))
    if action == "ls":
        rows = cache.ls()
        if args.json:
            print(json.dumps(rows, indent=1))
        else:
            print(f"{'KEY':26s} {'KIND':6s} {'BYTES':>10s}")
            for r in rows:
                print(f"{r['key']:26s} {r['kind']:6s} {r['size']:>10d}")
            print(f"{len(rows)} artifact(s), "
                  f"{sum(r['size'] for r in rows)} bytes")
        return 0
    if action == "purge":
        n = cache.purge(args.arg2)
        print(f"purged {n} artifact(s)"
              + (f" for key {args.arg2}" if args.arg2 else ""))
        return 0
    # stat: disk contents + per-worker hit/miss counters (status.json)
    st = cache.stats()
    evicted = sum(c.get("evicted", 0)
                  for c in _worker_cache_counters(root).values())
    out = {"root": st["root"], "entries": st["entries"],
           "bytes": st["bytes"], "max_bytes": st["max_bytes"],
           "evicted": evicted,
           "workers": _worker_cache_counters(root)}
    if args.json:
        print(json.dumps(out, indent=1))
        return 0
    budget = ("no budget" if out["max_bytes"] is None
              else f"budget {out['max_bytes']} bytes")
    print(f"artifact cache {out['root']}: {out['entries']} entr"
          f"{'y' if out['entries'] == 1 else 'ies'}, {out['bytes']} bytes "
          f"({budget}, {out['evicted']} evicted)")
    for wid, c in sorted(out["workers"].items()):
        print(f"  worker {wid}: hits={c.get('hits', 0)} "
              f"misses={c.get('misses', 0)} stores={c.get('stores', 0)} "
              f"corrupt={c.get('corrupt', 0)} "
              f"evicted={c.get('evicted', 0)}")
    return 0


def _cmd_prog_relocate(root: str, args) -> int:
    """`prog relocate NAME`: dry-run — abstract-verify the published
    object, print its relocation record, and show how it binds against
    this fleet's concrete registry (without touching any worker)."""
    from . import reloc
    from .loader import ProgramObject
    name = args.arg
    if not name:
        print("prog relocate needs a program name", file=sys.stderr)
        return 2
    progs = SH.read_programs(root)
    if name not in progs:
        print(f"no such program: {name} (loaded: {sorted(progs)})",
              file=sys.stderr)
        return 1
    obj = ProgramObject.from_json(progs[name])
    try:
        vabs = reloc.verify_relocatable(obj)
    except Exception as e:
        print(f"abstract verification failed: {e}", file=sys.stderr)
        return 1
    rows = reloc.relocation_table(vabs)
    specs = SH.read_meta_specs(root)
    fd_of = {s.name: i for i, s in enumerate(specs)}
    bound = err = None
    try:
        bound = reloc.resolve(vabs, fd_of, specs)
    except reloc.RelocationError as e:
        err = str(e)
    out = {"program": name, "tier": vabs.tier,
           "declared_maps": [ml.name for ml in vabs.reloc.map_layouts],
           "registry": [s.name for s in specs],
           "relocations": rows, "resolved": bound is not None,
           "error": err,
           "bound": reloc.relocation_table(bound) if bound else None}
    if args.json:
        print(json.dumps(out, indent=1))
        return 0 if bound else 1
    print(f"program {name}: {len(rows)} relocation(s), "
          f"declared maps {out['declared_maps']}")
    for r in rows:
        if r["kind"] == "map":
            print(f"  insn {r['insn']:3d}  map  {r['symbol']:16s} "
                  f"local_fd={r['local_fd']}  {r['disasm']}")
        else:
            print(f"  insn {r['insn']:3d}  ctx  {r['symbol']:16s} "
                  f"byte={r['byte']}  {r['disasm']}")
    if bound is not None:
        binds = ", ".join(
            f"{r['symbol']}->fd{r['bound_fd']}"
            for r in out["bound"] if r["kind"] == "map")
        print(f"resolves against registry {out['registry']}: "
              f"{binds or 'no map refs'}")
    else:
        print(f"does NOT resolve against this registry: {err}")
    return 0 if bound else 1


def _cmd_prog(root: str, args) -> int:
    from .loader import ProgramObject
    if args.action == "cache":
        return _cmd_prog_cache(root, args)
    if args.action == "relocate":
        return _cmd_prog_relocate(root, args)
    progs = SH.read_programs(root)
    wids = SH.list_workers(root)
    links: dict[str, list] = {}
    for wid in wids or [None]:
        try:
            status = ShmRegion.attach(root, mode="r",
                                      worker_id=wid).read_status()
        except OSError:
            continue
        promos = status.get("promotions", {})
        for lid, target in status.get("links", {}).items():
            pr = promos.get(lid, {})
            links.setdefault(wid or "-", []).append(
                (lid, target, pr.get("lane", "?"), pr.get("state", "?")))
    rows = []
    for name, obj_json in progs.items():
        obj = ProgramObject.from_json(obj_json)
        rows.append({"name": name, "type": obj.prog_type,
                     "attach_to": obj.attach_to,
                     "maps": [m["name"] for m in obj.maps]})
    if args.json:
        print(json.dumps({"programs": rows,
                          "links": {w: ls for w, ls in links.items()}},
                         indent=1))
        return 0
    print(f"{'NAME':20s} {'TYPE':12s} {'ATTACH_TO':24s} MAPS")
    for r in rows:
        print(f"{r['name']:20s} {r['type']:12s} "
              f"{str(r['attach_to']):24s} {','.join(r['maps'])}")
    for w, ls in sorted(links.items()):
        for lid, target, lane, state in ls:
            print(f"link {lid} -> {target} (worker {w}) "
                  f"lane={lane} promotion={state}")
    return 0


def _check_workers(root: str, requested) -> int:
    """0 if every requested worker id is registered, else 1 + message."""
    known = SH.list_workers(root)
    unknown = [w for w in (requested or []) if w not in known]
    if unknown:
        print(f"unknown worker(s): {', '.join(unknown)} "
              f"(registered: {', '.join(known) or 'none'})", file=sys.stderr)
        return 1
    return 0


def _cmd_attach(root: str, args) -> int:
    if _check_workers(root, args.worker):
        return 1
    with open(args.object) as f:
        obj_json = f.read()
    mode = args.mode or ("table" if args.live else None)
    req = {"op": "load_attach", "object": obj_json,
           "target": args.target, "live": args.live or mode == "table",
           "promote": not args.no_promote}
    if mode is not None:
        req["mode"] = mode
    wids = args.worker or SH.list_workers(root)
    if wids:
        reached = SH.fanout_request(root, req, wids)
        print(f"queued {'live ' if args.live else ''}load+attach of "
              f"{args.object} to workers {reached}")
    else:
        ShmRegion.attach(root).request(req)
        print(f"queued {'live ' if args.live else ''}load+attach "
              f"of {args.object}")
    return 0


def _cmd_detach(root: str, args) -> int:
    if _check_workers(root, args.worker):
        return 1
    req = {"op": "detach", "link_id": args.link_id}
    wids = args.worker or SH.list_workers(root)
    if wids:
        reached = SH.fanout_request(root, req, wids)
        print(f"queued detach of link {args.link_id} to workers {reached}")
    else:
        ShmRegion.attach(root).request(req)
        print(f"queued detach of link {args.link_id}")
    return 0


def _cmd_node(root: str, args) -> int:
    """`node run|ls|rm`: one level of the aggregation tree. `run` hosts a
    NodeAggregator for a worker group (its parent — another node or the
    global root — consumes the delta stream it emits); `ls` shows the
    registered tree topology + stream cursors; `rm` retires a node's
    registration (its stream stays for the parent to drain)."""
    from .treeagg import NodeAggregator
    if args.action == "ls":
        rows = []
        for nid in SH.list_nodes(root):
            info = SH.node_info(root, nid) or {}
            stream = SH.DeltaStream.attach(root, nid)
            rows.append({"node": nid, "parent": info.get("parent"),
                         "workers": info.get("workers", []),
                         "children": info.get("children", []),
                         "alive": SH.node_alive(root, nid),
                         "head": stream.head(), "acked": stream.acked()})
        if args.json:
            print(json.dumps(rows, indent=1))
            return 0
        if not rows:
            print("no nodes registered")
            return 0
        print(f"{'NODE':10s} {'PARENT':10s} {'ALIVE':6s} "
              f"{'HEAD':>6s} {'ACKED':>6s} WORKERS/CHILDREN")
        for r in rows:
            members = ",".join(r["workers"] + r["children"]) or "-"
            print(f"{r['node']:10s} {str(r['parent'] or '-'):10s} "
                  f"{('yes' if r['alive'] else 'no'):6s} "
                  f"{r['head']:>6d} {r['acked']:>6d} {members}")
        return 0
    if args.action == "rm":
        if not args.node_id:
            print("node rm needs a node id", file=sys.stderr)
            return 2
        if not SH.unregister_node(root, args.node_id):
            print(f"no such node: {args.node_id}", file=sys.stderr)
            return 1
        print(f"retired node {args.node_id} (stream left for the parent "
              f"to drain)")
        return 0
    # run
    if not args.node_id:
        print("node run needs a node id", file=sys.stderr)
        return 2
    workers = [w for w in (args.workers or "").split(",") if w]
    children = [c for c in (args.children or "").split(",") if c]
    if _check_workers(root, workers):
        return 1
    if not workers and not children:
        # group-only start: trainers that join with
        # --worker-group <node_id> are claimed dynamically
        print(f"node {args.node_id}: no explicit members — folding "
              f"workers that join group {args.node_id!r}")
    cfg = AggregatorConfig(device=args.device)
    if args.no_device_fold:
        cfg.device_fold = False
    na = NodeAggregator(root, args.node_id, workers=workers,
                        children=children, parent=args.parent, config=cfg)
    na.loop(watch=args.watch, once=args.once)
    return 0


def _cmd_fleet(root: str, args) -> int:
    """`fleet health`: the per-worker state machine the aggregation engine
    maintains (HEALTHY/DEGRADED/STALE/DEAD, quarantine, transitions) as
    published in global/status.json."""
    if not GlobalView.exists(root):
        print("no aggregated fleet — run `agg` first", file=sys.stderr)
        return 1
    status = GlobalView.attach(root).read_status()
    if not status:
        print("no aggregation status published yet", file=sys.stderr)
        return 1
    cache_by_worker = _worker_cache_counters(root)
    if args.json:
        print(json.dumps({**status, "cache": cache_by_worker}, indent=1))
        return 0
    print(f"fleet health @ cycle {status.get('cycles', 0)}: "
          f"alive={status.get('alive', [])} dead={status.get('dead', [])} "
          f"stale={status.get('stale', [])}")
    extras = []
    for key in ("stragglers", "hb_dead"):
        if status.get(key):
            extras.append(f"{key}={status[key]}")
    if any(status.get("corrupt_skipped", {}).values()):
        extras.append(f"corrupt_skipped={status['corrupt_skipped']}")
    if any(v for d in status.get("rb_lost", {}).values()
           for v in d.values()):
        extras.append(f"rb_lost={status['rb_lost']}")
    if status.get("coalesced_cycles"):
        extras.append(f"coalesced_cycles={status['coalesced_cycles']}")
    if any(status.get("stream_lost", {}).values()):
        extras.append(f"stream_lost={status['stream_lost']}")
    if status.get("hash_shards"):
        extras.append(f"hash_shards={status['hash_shards']} "
                      f"shard_publishes={status.get('shard_publishes', 0)}")
    if cache_by_worker:
        hits = sum(c.get("hits", 0) for c in cache_by_worker.values())
        misses = sum(c.get("misses", 0) for c in cache_by_worker.values())
        corrupt = sum(c.get("corrupt", 0) for c in cache_by_worker.values())
        extras.append(f"cache_hits={hits} cache_misses={misses}"
                      + (f" cache_corrupt={corrupt}" if corrupt else ""))
    if extras:
        print("  " + " ".join(extras))
    nodes = status.get("nodes", {})
    if nodes:
        print(f"{'NODE':12s} {'STATE':10s} {'SEQ':>6s} {'ALIVE':>6s} "
              f"WORKERS/SUBTREE")
        for nid, n in sorted(nodes.items()):
            sub = n.get("subtree", {})
            members = ",".join(n.get("workers", [])) or "-"
            if sub.get("alive"):
                members += f" (subtree alive={len(sub['alive'])})"
            print(f"{nid:12s} {n.get('state', '?'):10s} "
                  f"{n.get('last_seq', 0):>6d} "
                  f"{('yes' if n.get('alive') else 'no'):>6s} {members}")
    print(f"{'WORKER':12s} {'STATE':10s} {'QUARANTINED':12s} TRANSITIONS")
    for wid, h in sorted(status.get("health", {}).items()):
        print(f"{wid:12s} {h['state']:10s} "
              f"{('yes' if h.get('quarantined') else '-'):12s} "
              f"{len(h.get('transitions', []))}")
        for cyc, frm, to, reason in h.get("transitions", []):
            print(f"    cycle {cyc}: {frm} -> {to} ({reason})")
    return 0


def _main_bpftool(argv: list[str]) -> int:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.core.daemon")
    ap.add_argument("shm_dir")
    sub = ap.add_subparsers(dest="cmd", required=True)

    mp = sub.add_parser("map", help="dump or rank map contents")
    mp.add_argument("action", choices=("dump", "top"))
    mp.add_argument("name", nargs="?")
    mp.add_argument("--section", choices=("global", "device", "host"),
                    help="default: global if aggregated, else device")
    mp.add_argument("--worker", help="worker id for device/host sections")
    mp.add_argument("-n", "--top-n", type=int, default=10)
    mp.add_argument("--shard", type=int, default=None,
                    help="read one keyspace partition of the sharded "
                         "global hash views instead of a section")
    mp.add_argument("--json", action="store_true")

    pp = sub.add_parser("prog",
                        help="list programs/links, inspect the artifact "
                             "cache, or dry-run a relocation")
    pp.add_argument("action", choices=("list", "cache", "relocate"))
    pp.add_argument("arg", nargs="?",
                    help="cache: ls|stat|purge; relocate: program name")
    pp.add_argument("arg2", nargs="?",
                    help="cache purge: specific key (default: all)")
    pp.add_argument("--json", action="store_true")

    at = sub.add_parser("attach", help="queue load+attach (fleet fan-out)")
    at.add_argument("object", help="path to a ProgramObject json")
    at.add_argument("--target")
    at.add_argument("--mode", choices=("auto", "fused", "table"),
                    help="attach lane: auto picks the live table when it "
                         "is instantly available, fused forces the "
                         "epoch-bump (retrace) path, table forces the "
                         "live program table")
    at.add_argument("--no-promote", action="store_true",
                    help="pin a table-lane link to the interpreter "
                         "(skip background promotion to the fused lane)")
    at.add_argument("--live", action="store_true",
                    help="alias for --mode table (no retrace "
                         "in any worker)")
    at.add_argument("--worker", action="append",
                    help="restrict to worker id(s); default: all workers")

    dt = sub.add_parser("detach", help="queue a detach (fleet fan-out)")
    dt.add_argument("link_id", type=int)
    dt.add_argument("--worker", action="append")

    ag = sub.add_parser("agg", help="run the fleet aggregation engine")
    ag.add_argument("--watch", type=float, default=None,
                    help="poll cadence (default: AggregatorConfig."
                         "poll_interval)")
    ag.add_argument("--once", action="store_true")
    ag.add_argument("--tree", action="store_true",
                    help="hierarchical aggregation: group workers under "
                         "node-local aggregators (one process drives the "
                         "whole tree; use `node run` for one-process-per-"
                         "node fleets)")
    ag.add_argument("--fan-in", type=int, default=4,
                    help="workers (or child nodes) per node aggregator")
    ag.add_argument("--depth", type=int, default=1,
                    help="levels of node aggregators below the root")
    ag.add_argument("--shards", type=int, default=None,
                    help="also publish the global hash views partitioned "
                         "into K keyspace shards (map ... --shard K)")
    ag.add_argument("--device", default="cuda",
                    help="--tree: device of the node folds (default cuda)")

    nd = sub.add_parser("node", help="node-level aggregators (tree levels)")
    nd.add_argument("action", choices=("run", "ls", "rm"))
    nd.add_argument("node_id", nargs="?")
    nd.add_argument("--workers", help="comma-separated worker group")
    nd.add_argument("--children", help="comma-separated child node ids")
    nd.add_argument("--parent", help="parent node id (default: the root)")
    nd.add_argument("--watch", type=float, default=None)
    nd.add_argument("--once", action="store_true")
    nd.add_argument("--no-device-fold", action="store_true",
                    help="use the numpy fold twins instead of the device "
                         "reductions")
    nd.add_argument("--device", default="cuda",
                    help="device of the node folds (default cuda)")
    nd.add_argument("--json", action="store_true")

    fl = sub.add_parser("fleet", help="fleet health / failure introspection")
    fl.add_argument("action", choices=("health",))
    fl.add_argument("--json", action="store_true")

    args = ap.parse_args(argv)
    if args.cmd == "fleet":
        return _cmd_fleet(args.shm_dir, args)
    if args.cmd == "map":
        return _cmd_map(args.shm_dir, args)
    if args.cmd == "prog":
        return _cmd_prog(args.shm_dir, args)
    if args.cmd == "attach":
        return _cmd_attach(args.shm_dir, args)
    if args.cmd == "detach":
        return _cmd_detach(args.shm_dir, args)
    if args.cmd == "node":
        return _cmd_node(args.shm_dir, args)
    if args.cmd == "agg":
        cfg = AggregatorConfig()
        if args.shards:
            cfg.hash_shards = args.shards
        if args.tree:
            from .treeagg import TreeAggregator
            cfg.device = args.device
            TreeAggregator(args.shm_dir, fan_in=args.fan_in,
                           depth=args.depth, config=cfg).loop(
                watch=args.watch, once=args.once)
        else:
            Aggregator(args.shm_dir, config=cfg).loop(
                watch=args.watch, once=args.once)
        return 0
    return 2            # pragma: no cover - argparse enforces choices


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    if len(argv) >= 2 and argv[1] in _SUBCOMMANDS:
        return _main_bpftool(argv)

    ap = argparse.ArgumentParser()
    ap.add_argument("shm_dir")
    ap.add_argument("--watch", type=float, default=2.0)
    ap.add_argument("--once", action="store_true")
    ap.add_argument("--attach", help="path to a ProgramObject json to inject")
    ap.add_argument("--target", help="attach target for --attach")
    ap.add_argument("--live", action="store_true",
                    help="alias for --mode table (no retrace in the "
                         "target process)")
    ap.add_argument("--mode", choices=("auto", "fused", "table"))
    ap.add_argument("--no-promote", action="store_true")
    ap.add_argument("--detach", type=int, metavar="LINK_ID",
                    help="queue a detach of a previously applied link")
    args = ap.parse_args(argv)

    if not os.path.exists(os.path.join(args.shm_dir, "device", ".seq.npy")) \
            and SH.list_workers(args.shm_dir):
        print("fleet-layout region (no single-process section): use the "
              "subcommands — map/prog/attach/detach/agg", file=sys.stderr)
        return 1
    shm = ShmRegion.attach(args.shm_dir)
    if args.attach:
        with open(args.attach) as f:
            request_load_attach(shm, f.read(), args.target, live=args.live,
                                mode=args.mode,
                                promote=not args.no_promote)
        print(f"queued {'live ' if args.live else ''}load+attach "
              f"of {args.attach}")
        return
    if args.detach is not None:
        request_detach(shm, args.detach)
        print(f"queued detach of link {args.detach}")
        return
    while True:
        status = shm.read_status()
        print(f"=== {time.strftime('%H:%M:%S')} "
              f"programs: {list(shm.read_programs())} "
              f"live_gen: {status.get('live_gen', 0)} "
              f"links: {status.get('links', {})}")
        print(summarize(shm))
        if args.once:
            break
        time.sleep(args.watch)


if __name__ == "__main__":
    sys.exit(main())
