"""Fault tolerance: heartbeats, straggler detection, restart-from-checkpoint,
elastic re-mesh.

The bpftime twist: the *telemetry that feeds these decisions comes from the
probe runtime* — per-step wall times land in a shared-memory ARRAY map via
the sys_step_end tracepoint, so the (unprivileged, out-of-process) daemon
detects stragglers/stalls without touching the trainer (paper SP4). On a
real cluster each host runs one HeartbeatMonitor; here single-process tests
simulate missed beats and dead hosts.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

import numpy as np


@dataclass
class HeartbeatMonitor:
    """Tracks per-host liveness. beat() on every step; dead() lists hosts
    whose last beat is older than `timeout_s`. Hosts are integer ranks
    when num_hosts > 0; with num_hosts=0 the monitor tracks whatever ids
    have ever beaten (the fleet daemon's string worker ids)."""
    num_hosts: int
    timeout_s: float = 60.0
    last: dict = field(default_factory=dict)
    clock: object = time.monotonic

    def beat(self, host, t: float | None = None):
        self.last[host] = self.clock() if t is None else t

    def dead(self, now: float | None = None) -> list:
        now = self.clock() if now is None else now
        hosts = (range(self.num_hosts) if self.num_hosts
                 else sorted(self.last))
        return [h for h in hosts
                if now - self.last.get(h, -1e30) > self.timeout_s]


def detect_stragglers(step_times: np.ndarray, *, factor: float = 1.5,
                      min_samples: int = 5) -> list[int]:
    """step_times: [hosts, window] seconds (0 = missing). A host is a
    straggler when its median step time exceeds factor x fleet median."""
    if step_times.ndim != 2 or step_times.shape[1] < 1:
        return []
    med = []
    for h in range(step_times.shape[0]):
        v = step_times[h][step_times[h] > 0]
        med.append(np.median(v) if len(v) >= min_samples else np.nan)
    med = np.asarray(med)
    fleet = np.nanmedian(med)
    if not np.isfinite(fleet):
        return []
    return [int(h) for h in range(len(med))
            if np.isfinite(med[h]) and med[h] > factor * fleet]


@dataclass
class ElasticPlan:
    """Given a device loss, the new mesh shape + what must happen."""
    old_shape: tuple
    new_shape: tuple
    action: str             # 'continue' | 'reshard' | 'halt'
    lost: int = 0


def plan_elastic(mesh_shape: tuple[int, ...], devices_lost: int,
                 *, model_axis_last: bool = True) -> ElasticPlan:
    """Shrink the DATA axis (never the model axis — TP degree is baked into
    layouts) to the largest size that keeps all remaining devices busy.
    Restart path: reshard the latest checkpoint onto the new mesh
    (ckpt.restore with new shardings) and continue."""
    *lead, model = mesh_shape if model_axis_last else (*mesh_shape, 1)
    total = int(np.prod(mesh_shape))
    remaining = total - devices_lost
    if devices_lost == 0:
        return ElasticPlan(mesh_shape, mesh_shape, "continue")
    new_data = remaining // model
    if new_data < 1:
        return ElasticPlan(mesh_shape, mesh_shape, "halt", devices_lost)
    if len(lead) == 2:       # (pod, data, model): fold pods into data
        new_shape = (1, new_data, model)
    else:
        new_shape = (new_data, model)
    return ElasticPlan(mesh_shape, new_shape, "reshard", devices_lost)


@dataclass
class TrainSupervisor:
    """Restart-from-checkpoint supervisor: wraps the step loop; on failure
    (exception or dead host), restores the latest checkpoint and resumes.
    Tested with injected failures in tests/test_ft.py (JAX) and
    tests/test_torch_ckpt.py. The step is read with int(), which takes a
    tensor on any device."""
    ckpt_dir: str
    save_every: int = 10
    max_restarts: int = 3
    restarts: int = 0

    def run(self, state, step_fn, data_next, total_steps: int,
            save_fn, restore_fn, failure_hook=None):
        step = int(state["step"])
        while step < total_steps:
            try:
                if failure_hook is not None:
                    failure_hook(step)
                batch = data_next()
                if batch is None:      # eBPF filter skipped the batch
                    continue
                state, metrics = step_fn(state, batch)
                step = int(state["step"])
                if step % self.save_every == 0:
                    save_fn(step, state)
            except _Injected as e:
                self.restarts += 1
                if self.restarts > self.max_restarts:
                    raise
                state = restore_fn()
                step = int(state["step"])
        return state


class _Injected(RuntimeError):
    """Injected failure type used by tests (stands in for host loss)."""
