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

from ..configs.base import ModelConfig
from ..device import resolve
from ..models import registry as MR
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
        self._decode = make_decode_step(cfg, runtime)
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
        """Single-request prefill (unprobed) into its slot of the cache."""
        toks = torch.tensor([req.prompt], dtype=torch.int64,
                            device=self.device)
        c1 = MR.make_cache(self.cfg, 1, self.max_seq, torch.float32,
                           self.device)
        logits, c1 = MR.prefill_fn(self.params, {"tokens": toks}, c1,
                                   self.cfg)
        # the engine owns its cache: write the slot in place
        for full, one in zip(self.cache["blocks"], c1["blocks"]):
            for f in full:
                full[f][:, slot] = one[f][:, 0]
        self.cache["pos"][slot] = c1["pos"][0]
        nxt = int(torch.argmax(logits[0, -1, :self.cfg.vocab_size]))
        req.out.append(nxt)

    # ------------------------------------------------------------- main loop
    def submit_all(self, requests: list[Request]) -> list[Request]:
        queue = list(requests)
        for r in queue:
            self._admit(r)
        pending = [r for r in queue if not r.rejected]

        while pending or any(self.active):
            if self.runtime is not None and self.runtime.shm is not None:
                # daemon injection point: live attach requests land on the
                # running decode step without rebuilding it
                self.runtime.poll_control()
                self.maps = self.runtime.sync_live_table(self.maps)
            # refill slots
            for s in range(self.slots):
                if self.active[s] is None and pending:
                    req = pending.pop(0)
                    self._prefill_slot(s, req)
                    self.active[s] = req
            # batched decode over occupied slots
            toks = [[r.out[-1] if r is not None and r.out else 0]
                    for r in self.active]
            nxt, _, self.cache, self.maps = self._decode(
                self.params,
                torch.tensor(toks, dtype=torch.int64, device=self.device),
                self.cache, self.maps, self.step_count)
            if self._decode.last is not None:
                self.events += self._decode.last[0].shape[0]
            self.step_count += 1
            if self.runtime is not None:
                self.runtime.publish(self.maps)   # no-op without shm
            nxt = nxt.tolist()
            for s, r in enumerate(self.active):
                if r is None:
                    continue
                r.out.append(int(nxt[s]))
                if (len(r.out) >= r.max_new or int(nxt[s]) == self.eos
                        or len(r.prompt) + len(r.out) >= self.max_seq - 1):
                    r.done = True
                    if self.runtime is not None:
                        self.runtime.syscalls.invoke(
                            "sys_serve_evict", [r.rid, len(r.out)],
                            impl=lambda: True)
                    self.active[s] = None
        return requests
