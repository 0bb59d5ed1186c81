# Hierarchical fleet aggregation (DESIGN.md §15): worker -> node-local
# aggregator -> global. A NodeAggregator folds its whole worker group in
# ONE batched device pass (the per-kind merge twins were designed
# commutative precisely so they reassociate into a tree), then forwards an
# incremental DELTA BATCH — not a full snapshot — up its seq-numbered
# stream. Every chaos-plane guarantee (CRC'd sections, fold journal,
# health machine, pid-reuse rules) holds at every level:
#
#   * the stream IS the node's write-ahead log: the journal is written only
#     at emit boundaries (accumulators == emit base), and batches past the
#     journaled emit seq survive GC so a restarted node replays its own
#     committed batches into the emit base — forfeit-never-double;
#   * the parent acks only its JOURNALED cursor, so a crashed parent
#     re-reads anything newer idempotently (ringbuf records keep their
#     original (step, wid, pos) tags; replayed positions are skipped);
#   * a node that cold-starts over a stream it already emitted into
#     (journal lost) ADOPTS its workers' snapshots as baselines: nothing
#     re-emits, the gap is forfeited, the parent never double-folds.

from __future__ import annotations

import copy
from functools import partial

import numpy as np

from ..device import resolve
from . import faults
from . import maps as M
from . import shm as SH
from .daemon import Aggregator, AggregatorConfig
from .maps import MapKind, MapSpec


def plan_tree(worker_ids, fan_in: int = 4, depth: int = 1) -> dict:
    """Contiguous grouping of sorted worker ids into an aggregation tree.
    Level-0 nodes fold workers; level-l nodes fold level-(l-1) node
    streams; the top level's nodes have parent None (the global root
    consumes them). Levels stop early once a single node covers
    everything — no chains of one-child nodes."""
    wids = sorted(map(str, worker_ids))
    fan_in = max(2, int(fan_in))
    depth = max(1, int(depth))
    levels: list[list[dict]] = []
    nodes: dict[str, dict] = {}
    cur = [{"kind": "worker", "id": w} for w in wids]
    for lvl in range(depth):
        if not cur or (lvl > 0 and len(cur) <= 1):
            break
        groups = [cur[i:i + fan_in] for i in range(0, len(cur), fan_in)]
        level_nodes = []
        for gi, grp in enumerate(groups):
            nd = {"id": f"n{lvl}_{gi}", "level": lvl, "parent": None,
                  "workers": [m["id"] for m in grp
                              if m["kind"] == "worker"],
                  "children": [m["id"] for m in grp if m["kind"] == "node"]}
            for m in grp:
                if m["kind"] == "node":
                    nodes[m["id"]]["parent"] = nd["id"]
            nodes[nd["id"]] = nd
            level_nodes.append(nd)
        levels.append(level_nodes)
        cur = [{"kind": "node", "id": nd["id"]} for nd in level_nodes]
    return {"levels": levels, "nodes": nodes}


class NodeAggregator(Aggregator):
    """One tree level: polls an assigned worker group (and/or child node
    streams), folds the whole group in one batched device reduction, and
    emits delta batches into its own stream for the parent level."""

    def __init__(self, root: str, node_id: str, workers=(), children=(),
                 parent: str | None = None,
                 config: AggregatorConfig | None = None):
        self.node_id = str(node_id)
        self._node_id = self.node_id
        self._assigned = sorted(map(str, workers))
        self.children_ids = sorted(map(str, children))
        self.parent = parent
        self._adopt_admits = False
        config = config or AggregatorConfig()
        if config.device_fold:
            resolve(config.device)    # no card: raise, never fold on numpy
        super().__init__(root, config=config)
        self._spec_of = {s.name: s for s in self.specs}
        self._emit_seq = 0
        self._journaled_emit_seq = 0
        self._emit_base = self._fresh_emit_base()
        head = self.stream.head()
        meta = None
        if self.config.journal and self._journal_raw:
            meta = self._journal_raw.get("node")
        if meta is not None:
            # journal written only at emit boundaries, so the restored
            # accumulators ARE the emit base at the journaled seq
            s_j = int(meta.get("emit_seq", 0))
            self._emit_base = self._emit_base_from_acc()
            if s_j <= head:
                self._emit_seq = self._journaled_emit_seq = s_j
                # replay OWN committed batches past the journal into the
                # emit base: already-emitted content must never re-emit
                for seq, payload in self.stream.poll(s_j):
                    if payload is not None:
                        self._replay_into_emit_base(payload)
                    self._emit_seq = seq
                self._journaled_emit_seq = s_j
            else:
                # stream wiped under an intact journal: emit only future
                # deltas; the parent's cursor resets along with the stream
                self._emit_seq = self._journaled_emit_seq = head
        elif head > 0:
            # cold start over an already-emitted stream (journal lost):
            # adopt-mode — first snapshots become baselines, no fold
            self._adopt_admits = True
            self._emit_seq = self._journaled_emit_seq = head
        elif self.config.journal:
            # true cold start: seed the seq-0 journal immediately, so a
            # crash inside the very FIRST commit->journal window recovers
            # through WAL replay instead of the content-forfeiting adopt
            # path (batch 1 would otherwise be durable downstream while
            # its workers' later traffic got adopted as baseline)
            SH._atomic_json(self._journal_path(), self._journal_dict())

    # -------------------------------------------------------------- plumbing
    def _make_output(self):
        self.info = SH.register_node(self.root, self.node_id, self.parent,
                                     self._assigned, self.children_ids)
        self.stream = SH.DeltaStream.create(self.root, self.node_id)
        return None

    def _journal_path(self) -> str:
        return SH.os.path.join(SH.node_base(self.root, self.node_id),
                               "journal.json")

    def _journal_dict(self) -> dict:
        d = super()._journal_dict()
        d["node"] = {"id": self.node_id, "emit_seq": int(self._emit_seq)}
        return d

    def _worker_candidates(self) -> list[str]:
        listed = set(SH.list_workers(self.root))
        # dynamic group claim: workers that registered with
        # group == this node id join the fold even if they started after
        # the node (launch/train.py --worker-group). The node.json claim
        # is refreshed IN PLACE (same boot id) so the parent does not
        # mistake the wider claim for a node restart.
        grouped = set(SH.workers_in_group(self.root, self.node_id))
        new = grouped - set(self._assigned)
        if new:
            self._assigned = sorted(set(self._assigned) | grouped)
            self.info = SH.update_node_workers(self.root, self.node_id,
                                               self._assigned)
        return [w for w in self._assigned if w in listed]

    def _journal_ok(self, output_happened: bool) -> bool:
        # only an emit boundary is journal-consistent for a node: the
        # journaled accumulators must equal the emit base
        return output_happened

    def _post_journal(self) -> None:
        self._journaled_emit_seq = self._emit_seq

    def _publish_status(self, status: dict) -> None:
        SH._atomic_json(SH.os.path.join(
            SH.node_base(self.root, self.node_id), "status.json"), status)

    # -------------------------------------------------------------- emit base
    def _fresh_emit_base(self) -> dict:
        return {
            "summary": {n: {f: np.zeros_like(np.asarray(a, np.int64))
                            for f, a in st.items()}
                        for n, st in self.summary.items()},
            "hash": {n: (M._EMPTY_I64, M._EMPTY_I64)
                     for n in self.hash_tbl},
            "rb_heads": {n: {} for n in self.rb_tagged},
            "rb_lost": {n: {} for n in self.rb_tagged},
            "counters": {"merged_updates": 0, "hash_dropped": {},
                         "corrupt": {}, "coalesced": 0},
        }

    def _emit_base_from_acc(self) -> dict:
        return {
            "summary": {n: {f: np.asarray(a, np.int64).copy()
                            for f, a in st.items()}
                        for n, st in self.summary.items()},
            "hash": {n: M.n_hash_content(t)
                     for n, t in self.hash_tbl.items()},
            "rb_heads": {n: dict(d) for n, d in self.rb_heads.items()},
            "rb_lost": {n: dict(d) for n, d in self.rb_lost.items()},
            "counters": {"merged_updates": int(self.merged_updates),
                         "hash_dropped": dict(self.hash_dropped),
                         "corrupt": dict(self.corrupt_skipped),
                         "coalesced": int(self.coalesced_cycles)},
        }

    def _replay_into_emit_base(self, payload: dict) -> None:
        js, arrs = payload["json"], payload["arrays"]
        eb = self._emit_base
        for key, arr in arrs.items():
            p = key.split("/")
            if p[0] == "summary" and p[1] in eb["summary"]:
                with np.errstate(over="ignore"):
                    eb["summary"][p[1]][p[2]] = (
                        eb["summary"][p[1]][p[2]]
                        + np.asarray(arr, np.int64))
        for name in eb["hash"]:
            ak = arrs.get(f"hash/{name}/keys")
            dels = js.get("hash_dels", {}).get(name, [])
            if (ak is None or not np.asarray(ak).size) and not dels:
                continue
            bk, bv = eb["hash"][name]
            d = dict(zip(bk.tolist(), bv.tolist()))
            if ak is not None and np.asarray(ak).size:
                ad = np.asarray(arrs[f"hash/{name}/deltas"], np.int64)
                for k, dv in zip(np.asarray(ak, np.int64).tolist(),
                                 ad.tolist()):
                    d[k] = int(np.int64(d.get(k, 0) + dv))
            for k in dels:
                d.pop(int(k), None)
            ks = np.fromiter(sorted(d), np.int64, len(d))
            eb["hash"][name] = (ks, np.array([d[k] for k in sorted(d)],
                                             np.int64)
                                if d else M._EMPTY_I64)
        for name, per_wid in js.get("rb_meta", {}).items():
            if name in eb["rb_heads"]:
                for wid, meta in per_wid.items():
                    eb["rb_heads"][name][wid] = max(
                        eb["rb_heads"][name].get(wid, 0),
                        int(meta["head"]))
                    eb["rb_lost"][name][wid] = \
                        eb["rb_lost"][name].get(wid, 0) + \
                        int(meta.get("lost_delta", 0))
        c = eb["counters"]
        c["merged_updates"] += int(js.get("updates", 0))
        for name, v in js.get("hash_dropped_delta", {}).items():
            c["hash_dropped"][name] = c["hash_dropped"].get(name, 0) + int(v)
        for wid, v in js.get("corrupt_delta", {}).items():
            c["corrupt"][wid] = c["corrupt"].get(wid, 0) + int(v)
        c["coalesced"] += int(js.get("coalesced_delta", 0))

    # -------------------------------------------------------------- group fold
    def _fold_polled(self, polled: list) -> int:
        """ONE batched device pass folds the whole worker group: summary
        fields stack into (W, *shape) arrays for a single jitted
        reduction; hash deltas extract vectorized, concatenate, coalesce
        per key (device segment-sum) and land in one fetch-add batch.
        Ringbufs stay per-worker tuples (tags are identity)."""
        updates = 0
        folds = []
        for wid, w, snaps, seq_before in polled:
            if w.pop("adopt", False):
                self._adopt_baseline(wid, w, snaps)
                faults.fire("agg:post_merge", wid=wid, who=self._who())
                self._ok_event(wid, advanced=w.get("seq", 0) > seq_before)
            else:
                folds.append((wid, w, snaps, seq_before))
        if not folds:
            return updates
        use_dev = bool(self.config.device_fold)
        group_stacks: dict[str, tuple] = {}
        for spec in self.specs:
            if not M.is_summary_kind(spec.kind):
                continue
            name = spec.name
            fields = M.SUMMARY_FIELDS[spec.kind]
            curs = {f: np.stack(
                [np.asarray(s[name][f], np.int64)
                 for _, _, s, _ in folds]) for f in fields}
            bases = {f: np.stack(
                [np.asarray(w["base"]["summary"][name][f], np.int64)
                 for _, w, _, _ in folds]) for f in fields}
            group_stacks[name] = (fields, curs, bases)
        if group_stacks:
            fold_in = {name: {f: (self.summary[name][f], curs[f], bases[f])
                              for f in fields}
                       for name, (fields, curs, bases)
                       in group_stacks.items()}
            fold_fn = (partial(M.t_group_summary_fold_multi,
                               device=self.config.device) if use_dev
                       else M.n_group_summary_fold_multi)
            new_accs = fold_fn(fold_in)
            for name, (fields, curs, bases) in group_stacks.items():
                with np.errstate(over="ignore"):
                    updates += int(sum(np.abs(curs[f] - bases[f]).sum()
                                       for f in fields))
                # np.array (not asarray): a device result views as
                # read-only, but the accumulator is merged in place by the
                # sequential paths (dead-worker harvest, quarantine)
                self.summary[name] = {f: np.array(new_accs[name][f],
                                                  np.int64)
                                      for f in fields}
                for _, w, s, _ in folds:
                    w["base"]["summary"][name] = s[name]
        for spec in self.specs:
            name = spec.name
            if M.is_summary_kind(spec.kind):
                pass
            elif spec.kind == MapKind.HASH:
                group_k, group_d, all_dels = [], [], []
                for wid, w, s, _ in folds:
                    ck, cv = M.n_hash_content(s[name])
                    base = w["base"]
                    bk, bv = base.setdefault("hash_arr", {}).get(
                        name, (None, None))
                    if bk is None:
                        items = base["hash_items"][name]
                        sk = sorted(items)
                        bk = np.fromiter(sk, np.int64, len(sk))
                        bv = (np.array([items[k] for k in sk], np.int64)
                              if sk else M._EMPTY_I64)
                    ak, ad, dk = M.n_hash_delta_arrays(ck, cv, bk, bv)
                    group_k.append(ak)
                    group_d.append(ad)
                    all_dels.extend(dk.tolist())
                    updates += int(ak.size + dk.size)
                    base["hash_arr"][name] = (ck, cv)
                    base["hash_items"][name] = dict(
                        zip(ck.tolist(), cv.tolist()))
                gk = (np.concatenate(group_k) if group_k
                      else M._EMPTY_I64)
                if gk.size:
                    gd = np.concatenate(group_d)
                    co = (partial(M.t_hash_coalesce,
                                  device=self.config.device) if use_dev
                          else M.n_hash_coalesce)
                    ck2, cd2 = co(gk, gd)
                    M.n_hash_fetch_add_batch(self.hash_tbl[name], ck2, cd2)
                    res_k, _ = M.n_hash_content(self.hash_tbl[name])
                    lost = int(np.count_nonzero(~np.isin(ck2, res_k)))
                    if lost:
                        self.hash_dropped[name] += lost
                for k in all_dels:     # owner-only dels: order-safe
                    M.n_hash_delete(self.hash_tbl[name], int(k))
            elif spec.kind == MapKind.RINGBUF:
                for wid, w, s, _ in folds:
                    updates += self._fold_rb(spec, wid, w["base"], s[name])
        for wid, w, _, seq_before in folds:
            faults.fire("agg:post_merge", wid=wid, who=self._who())
            self._ok_event(wid, advanced=w.get("seq", 0) > seq_before)
        return updates

    # -------------------------------------------------------------- emission
    def _build_batch(self) -> dict:
        """The delta between the accumulators and the emit base, as one
        atomic batch; advances the emit base to the current accumulators."""
        arrs: dict[str, np.ndarray] = {}
        js: dict = {"node_id": self.node_id, "cycle": int(self.cycles)}
        eb = self._emit_base
        for name, acc in self.summary.items():
            for f in M.SUMMARY_FIELDS[
                    self._spec_of[name].kind]:
                a = np.asarray(acc[f], np.int64)
                with np.errstate(over="ignore"):
                    d = a - eb["summary"][name][f]
                if np.any(d):
                    arrs[f"summary/{name}/{f}"] = d
                eb["summary"][name][f] = a.copy()
        hash_dels: dict[str, list] = {}
        for name, tbl in self.hash_tbl.items():
            ck, cv = M.n_hash_content(tbl)
            bk, bv = eb["hash"][name]
            ak, ad, dk = M.n_hash_delta_arrays(ck, cv, bk, bv)
            if ak.size:
                arrs[f"hash/{name}/keys"] = ak
                arrs[f"hash/{name}/deltas"] = ad
            if dk.size:
                hash_dels[name] = [int(k) for k in dk]
            eb["hash"][name] = (ck, cv)
        if hash_dels:
            js["hash_dels"] = hash_dels
        rb_meta: dict[str, dict] = {}
        for name, per_wid in self.rb_tagged.items():
            spec = self._spec_of[name]
            meta: dict[str, dict] = {}
            wids = set(per_wid) | set(self.rb_heads[name]) \
                | set(self.rb_lost[name])
            for wid in sorted(wids):
                buf = per_wid.get(wid, [])
                head = int(self.rb_heads[name].get(wid, 0))
                eh = int(eb["rb_heads"][name].get(wid, 0))
                lost_cum = int(self.rb_lost[name].get(wid, 0))
                lost_prev = int(eb["rb_lost"][name].get(wid, 0))
                if head <= eh and lost_cum <= lost_prev:
                    continue
                # records that fell out of the retention window before we
                # forwarded them: the node fell behind — accounted upward
                start = buf[0][0][2] if buf else head
                gap = max(0, min(start, head) - eh)
                if gap:
                    self.rb_lost[name][wid] = lost_cum = lost_cum + gap
                new = [(t, r) for (t, r) in buf if t[2] >= eh]
                entry: dict = {
                    "head": head,
                    "floor": int(self.rb_step_floor[name].get(wid, 0))}
                if lost_cum > lost_prev:
                    entry["lost_delta"] = lost_cum - lost_prev
                eb["rb_lost"][name][wid] = lost_cum
                if new:
                    arrs[f"rb/{name}/{wid}/steps"] = np.array(
                        [t[0] for t, _ in new], np.int64)
                    arrs[f"rb/{name}/{wid}/pos"] = np.array(
                        [t[2] for t, _ in new], np.int64)
                    arrs[f"rb/{name}/{wid}/recs"] = np.stack(
                        [np.asarray(r, np.int64) for _, r in new])
                meta[wid] = entry
                eb["rb_heads"][name][wid] = head
            if meta:
                rb_meta[name] = meta
        if rb_meta:
            js["rb_meta"] = rb_meta
        c = eb["counters"]
        js["updates"] = max(0, int(self.merged_updates)
                            - c["merged_updates"])
        c["merged_updates"] = int(self.merged_updates)
        hdd = {}
        for name, v in self.hash_dropped.items():
            pv = c["hash_dropped"].get(name, 0)
            if v > pv:
                hdd[name] = int(v - pv)
                c["hash_dropped"][name] = int(v)
        if hdd:
            js["hash_dropped_delta"] = hdd
        cd = {}
        for wid, v in self.corrupt_skipped.items():
            pv = c["corrupt"].get(wid, 0)
            if v > pv:
                cd[wid] = int(v - pv)
                c["corrupt"][wid] = int(v)
        if cd:
            js["corrupt_delta"] = cd
        co = int(self.coalesced_cycles) - c["coalesced"]
        if co > 0:
            js["coalesced_delta"] = co
            c["coalesced"] = int(self.coalesced_cycles)
        # transitive rollup: this level's health map already contains the
        # subtree's entries (child batches fold their health into ours)
        js["health"] = self.health
        sub_alive = [a for st in self._subtree.values()
                     for a in st.get("alive", [])]
        sub_dead = [d for st in self._subtree.values()
                    for d in st.get("dead", [])]
        js["alive"] = sorted(set(self.workers) | set(sub_alive))
        js["dead"] = sorted(set(self.dead) | set(sub_dead))
        if self.stream_lost:
            js["stream_lost"] = dict(self.stream_lost)
        return {"json": js, "arrays": arrs}

    def _membership(self) -> tuple:
        """What the parent knows about this subtree's liveness/health —
        a change here is emit-worthy even with zero data updates (a dead
        worker must propagate up the tree without waiting for traffic)."""
        sub_alive = [a for st in self._subtree.values()
                     for a in st.get("alive", [])]
        sub_dead = [d for st in self._subtree.values()
                    for d in st.get("dead", [])]
        return (tuple(sorted(set(self.workers) | set(sub_alive))),
                tuple(sorted(set(self.dead) | set(sub_dead))),
                tuple(sorted((w, h["state"])
                             for w, h in self.health.items())))

    def _publish_cycle(self, cycle_updates: int) -> bool:
        cfg = self.config
        membership = self._membership()
        publish_now = (bool(cycle_updates) or not self._published
                       or self._publish_lag > 0
                       or membership != getattr(self, "_last_membership",
                                                None))
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
            seq = self._emit_seq + 1
            faults.fire("node:pre_emit", node=self.node_id, seq=seq,
                        who=self._who())
            batch = self._build_batch()
            path = self.stream.emit(seq, batch)
            self._emit_seq = seq
            self._published = True
            self._last_membership = membership
            faults.fire("node:post_commit", node=self.node_id, seq=seq,
                        path=path, who=self._who())
            faults.fire("agg:post_publish", who=self._who())
            # GC is bounded by BOTH cursors: the parent's ack (it folded
            # and journaled the batch) and our own journaled emit seq (the
            # batch is still our recovery WAL until the journal covers it)
            self.stream.gc(self._journaled_emit_seq
                           if cfg.journal else None)
        return publish_now


class TreeAggregator:
    """Drives a whole aggregation tree in one process (tests, benchmarks,
    and the CLI's --tree mode; production fleets run each NodeAggregator
    in its own process via `node run`). Nodes poll leaves-first so one
    tree cycle moves every worker delta all the way to the root view."""

    def __init__(self, root: str, fan_in: int = 4, depth: int = 1,
                 config: AggregatorConfig | None = None,
                 worker_ids=None):
        self.root = root
        self.config = config or AggregatorConfig()
        wids = sorted(worker_ids if worker_ids is not None
                      else SH.list_workers(root))
        self.plan = plan_tree(wids, fan_in=fan_in, depth=depth)
        self.node_aggs: list[NodeAggregator] = []
        for level in self.plan["levels"]:
            for nd in level:
                self.node_aggs.append(NodeAggregator(
                    root, nd["id"], workers=nd["workers"],
                    children=nd["children"], parent=nd["parent"],
                    config=copy.copy(self.config)))
        self.root_agg = Aggregator(root, config=copy.copy(self.config))

    @property
    def view(self):
        return self.root_agg.view

    def poll_once(self) -> dict:
        for na in self.node_aggs:
            na.poll_once()
        return self.root_agg.poll_once()

    def global_states(self) -> dict:
        return self.root_agg.global_states()

    def loop(self, watch: float | None = None, once: bool = False,
             out=None) -> None:
        import sys
        import time
        out = sys.stdout if out is None else out
        watch = self.config.poll_interval if watch is None else watch
        while True:
            status = self.poll_once()
            nodes = status.get("nodes", {})
            print(f"=== {time.strftime('%H:%M:%S')} tree cycle "
                  f"{status['cycles']} nodes={sorted(nodes)} "
                  f"alive={status['alive']} dead={status['dead']} "
                  f"merged={status['merged_updates']}", file=out)
            if once:
                break
            time.sleep(watch)


__all__ = ["plan_tree", "NodeAggregator", "TreeAggregator", "MapSpec"]
