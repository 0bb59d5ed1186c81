"""Continuous-batching serve engine (host side).

Fixed-slot batcher: B decode slots; finished/empty slots are refilled from
the queue each iteration (prefill for one request at a time into its slot).
Admission and eviction are framework syscalls, so eBPF filter programs can
reject requests (rate limiting / policy -- the paper's syscall filtering in
the serving plane) and tracepoints can account per-request tokens.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

from .. import telemetry as T
from ..configs.base import ModelConfig
from ..device import resolve
from ..models import registry as MR
from . import prefill_graph as PG
from .steps import make_decode_step


@dataclass
class Request:
    rid: int
    prompt: list[int]
    max_new: int = 16
    out: list[int] = field(default_factory=list)
    done: bool = False
    rejected: bool = False


class ServeEngine:
    def __init__(self, params, cfg: ModelConfig, *, slots: int = 4,
                 max_seq: int = 128, runtime=None, eos: int = -1,
                 shm_dir: str | None = None,
                 worker_id: str | None = None, device="cuda"):
        self.device = resolve(device)
        self.params = params
        # what the model serves on: every leaf it uses only through a cast
        # to the compute type held in that type; one object at every call,
        # so the decode graphs are captured once
        self.serving_params = MR.serving_params(params, cfg)
        self.cfg = cfg
        self.slots = slots
        self.max_seq = max_seq
        self.runtime = runtime
        self.eos = eos
        if runtime is not None and shm_dir:
            # serve workers join the same fleet plane as trainers: per-step
            # map snapshots publish under workers/<wid>/ and live attach
            # requests fan in through this worker's control queue
            runtime.setup_shm(shm_dir, worker_id=worker_id)
        self.cache = MR.make_cache(cfg, slots, max_seq, torch.float32,
                                   self.device)
        self.active: list[Request | None] = [None] * slots
        self.maps = runtime.init_device_maps(self.device) if runtime else {}
        # the engine passes back the cache the step returned, so the step
        # may replay its model work from CUDA graphs over caches it owns
        self._decode = make_decode_step(cfg, runtime, graphs=True)
        # where `prefill_graph.engages`, a prefill replays its model work
        # from a graph of its padded length (`serve/prefill_graph.py`),
        # every bucket captured at the first `submit_all`
        self._prefill_graphs = None
        self.step_count = 0
        self.events = 0               # probe rows collected by decode steps

    @property
    def last_tape(self):
        """(rows, maps_in, step) of the last probed decode step, or None.
        maps_in's live table is the one the step ran, from its generation's
        snapshot: a sync since then has written the step's buffer."""
        last = self._decode.last
        if last is None:
            return None
        rows, maps, step, gen = last
        if gen is not None and "__live_table__" in maps:
            maps = {**maps, "__live_table__": self.runtime.live_table_at(
                gen, rows.device)}
        return rows, maps, step

    # ------------------------------------------------------------- admission
    def _admit(self, req: Request, fault_retries: int = 3) -> bool:
        """Admission faults vs vetoes: a NEGATIVE override code from the
        sys_serve_admit filter is a transient fault -- retried up to
        fault_retries times before the request degrades to rejected. A
        non-negative override is a policy rejection: final immediately."""
        if self.runtime is None:
            return True
        for _ in range(fault_retries + 1):
            res = self.runtime.syscalls.invoke(
                "sys_serve_admit", [req.rid, len(req.prompt), req.max_new],
                impl=lambda: True)
            if not res.overridden:
                return True
            if not res.fault:
                break                # policy veto: final
        req.rejected = True
        req.done = True
        return False

    def _prefill_slot(self, slot: int, req: Request):
        """Single-request prefill (unprobed) into its slot of the cache:
        replayed from the graph of its padded length where the graphed
        prefill engages and the prompt fits a bucket, else eager. The
        keyed record `serve.prefill_graph` counts the call."""
        with T.span("serve.prefill"):
            n = len(req.prompt)
            T.count("serve.prefill_tokens", n)
            graphs = self._prefill_graphs
            if (graphs is not None and PG.engages(self.cfg, self.cache)
                    and graphs.bucket(n) is not None):
                last, c1 = graphs(req.prompt)
            else:
                T.count("serve.prefill_graph", ("eager", 0))
                toks = torch.tensor([req.prompt], dtype=torch.int64,
                                    device=self.device)
                c1 = MR.make_cache(self.cfg, 1, self.max_seq,
                                   torch.float32, self.device)
                logits, c1 = MR.prefill_fn(self.serving_params,
                                           {"tokens": toks}, c1, self.cfg)
                last = logits[:, -1]
            # the engine owns its cache: write the slot in place
            with T.span("serve.slot_write"):
                for full, one in zip(self.cache["blocks"], c1["blocks"]):
                    for f in full:
                        full[f][:, slot] = one[f][:, 0]
                self.cache["pos"][slot] = c1["pos"][0]
            nxt = int(torch.argmax(last[0, :self.cfg.vocab_size]))
            req.out.append(nxt)

    # ------------------------------------------------------------- main loop
    def submit_all(self, requests: list[Request]) -> list[Request]:
        queue = list(requests)
        for r in queue:
            self._admit(r)
        pending = [r for r in queue if not r.rejected]
        if self._prefill_graphs is None and PG.engages(self.cfg, self.cache):
            # every bucket before the first request is served
            self._prefill_graphs = PG.PrefillGraphs(
                self.cfg, self.max_seq, self.serving_params, self.device)
            self._prefill_graphs.capture_all()

        while pending or any(self.active):
            with T.span("serve.iteration"):
                self._iteration(pending)
        return requests

    def _iteration(self, pending: list[Request]) -> None:
        """One pass of the loop: control, refills, the batched decode over
        the occupied slots, publish, the token read, retirement."""
        if self.runtime is not None and self.runtime.shm is not None:
            # daemon injection point: live attach requests land on the
            # running decode step without rebuilding it
            self.runtime.poll_control()
            self.maps = self.runtime.sync_live_table(self.maps)
        with T.span("serve.refill"):
            for s in range(self.slots):
                if self.active[s] is None and pending:
                    req = pending.pop(0)
                    self._prefill_slot(s, req)
                    self.active[s] = req
        # batched decode over occupied slots
        toks = [[r.out[-1] if r is not None and r.out else 0]
                for r in self.active]
        nxt, _, self.cache, self.maps = self._decode(
            self.serving_params,
            torch.tensor(toks, dtype=torch.int64, device=self.device),
            self.cache, self.maps, self.step_count)
        if self._decode.last is not None:
            self.events += self._decode.last[0].shape[0]
        self.step_count += 1
        if self.runtime is not None:
            with T.span("serve.publish"):
                self.runtime.publish(self.maps)   # no-op without shm
        with T.span("serve.read"):
            nxt = nxt.tolist()
        with T.span("serve.retire"):
            counting = T.on()
            for s, r in enumerate(self.active):
                if r is None:
                    continue
                if counting:
                    # the position this step decoded the slot at
                    T.count("serve.decode_position",
                            len(r.prompt) + len(r.out) - 1)
                r.out.append(int(nxt[s]))
                if (len(r.out) >= r.max_new or int(nxt[s]) == self.eos
                        or len(r.prompt) + len(r.out) >= self.max_seq - 1):
                    r.done = True
                    if self.runtime is not None:
                        self.runtime.syscalls.invoke(
                            "sys_serve_evict", [r.rid, len(r.out)],
                            impl=lambda: True)
                    self.active[s] = None
