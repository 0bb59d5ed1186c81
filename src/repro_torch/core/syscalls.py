"""Framework-syscall tracepoints — the syscall-hook (zpoline) analogue.

Every host-side runtime service (data fetch, checkpoint save, logging,
serve admission, collective-group launch, ...) is routed through a
SyscallTable. Attached `tracepoint` programs observe sys_enter/sys_exit;
attached `filter` programs on sys_enter may call override_return(v) to SKIP
the real implementation and force a return code — the paper's programmatic
syscall filtering (C2), e.g. blocking checkpoints or dropping bad batches.

Host programs execute on the numpy map twins (optionally shm-backed so the
daemon sees updates live), via the reference interpreter — host code is
not latency-critical, and this keeps device/host semantics identical.
"""
from __future__ import annotations

import time
from dataclasses import dataclass, field

from . import vm
from .maps import MapSpec

# stable syscall numbering (the framework's "syscall table")
SYSCALL_IDS = {
    "sys_data_fetch": 1,
    "sys_checkpoint_save": 2,
    "sys_checkpoint_restore": 3,
    "sys_log": 4,
    "sys_serve_admit": 5,
    "sys_serve_evict": 6,
    "sys_collective_launch": 7,
    "sys_shm_publish": 8,
    "sys_step_begin": 9,
    "sys_step_end": 10,
    "sys_heartbeat": 11,
    "sys_elastic_resize": 12,
}


def _signed64(v: int) -> int:
    """The VM keeps registers as u64; override values round-trip through
    that, so a filter injecting -EIO hands back 2^64-5. Interpret override
    return codes as signed 64-bit, like the kernel does."""
    v &= (1 << 64) - 1
    return v - (1 << 64) if v >= (1 << 63) else v


@dataclass
class SyscallResult:
    value: object          # real impl return (None if overridden/skipped)
    ret_code: int          # integer code seen by exit probes
    overridden: bool
    override_val: int = 0

    @property
    def fault(self) -> bool:
        """Convention for callers: a NEGATIVE override return code is an
        injected transient fault (-errno) — retry with bounds, then
        degrade. A non-negative override is a policy veto — skip
        immediately, no retry."""
        return self.overridden and self.ret_code < 0


@dataclass
class _Hook:
    prog_name: str
    insns: list
    map_specs: list[MapSpec]
    phase: str             # 'enter' | 'exit'


class SyscallTable:
    """Host syscall dispatch with eBPF enter/exit hooks."""

    def __init__(self, host_maps: dict, map_specs: list[MapSpec],
                 pid: int = 0):
        self.host_maps = host_maps            # numpy twins (possibly shm)
        self.map_specs = map_specs
        self.hooks: dict[tuple[str, str], list[_Hook]] = {}
        self.pid = pid
        self.counts: dict[str, int] = {}

    def attach(self, sys_name: str, phase: str, prog_name: str, insns,
               map_specs):
        if sys_name not in SYSCALL_IDS:
            raise KeyError(f"unknown syscall {sys_name}")
        if phase not in ("enter", "exit"):
            raise ValueError(phase)
        self.hooks.setdefault((sys_name, phase), []).append(
            _Hook(prog_name, insns, map_specs, phase))

    def detach(self, sys_name: str, phase: str, prog_name: str):
        key = (sys_name, phase)
        self.hooks[key] = [h for h in self.hooks.get(key, [])
                           if h.prog_name != prog_name]

    def _run_hooks(self, key, ctx_words) -> vm.Aux | None:
        """Run hooks; returns the first aux with override set (if any)."""
        override = None
        for h in self.hooks.get(key, []):
            aux = vm.Aux(time_ns=time.monotonic_ns(), cpu=0, pid=self.pid)
            vm.run(h.insns, vm.pack_ctx(ctx_words), h.map_specs,
                   self.host_maps, aux)
            if aux.override_set and override is None:
                override = aux
        return override

    def invoke(self, sys_name: str, args: list[int], impl,
               ret_code_of=lambda v: 0) -> SyscallResult:
        """args: up to 5 ints (the eBPF ctx view of the call)."""
        sid = SYSCALL_IDS[sys_name]
        self.counts[sys_name] = self.counts.get(sys_name, 0) + 1
        a = (list(args) + [0] * 5)[:5]
        ctx = [sid, *a, 0]  # ret slot = 0 on enter

        ov = self._run_hooks((sys_name, "enter"), ctx)
        if ov is not None:
            rc = _signed64(ov.override_val)
            self._run_hooks((sys_name, "exit"), [sid, *a, rc])
            return SyscallResult(value=None, ret_code=rc, overridden=True,
                                 override_val=rc)

        value = impl()
        rc = int(ret_code_of(value))
        self._run_hooks((sys_name, "exit"), [sid, *a, rc])
        return SyscallResult(value=value, ret_code=rc, overridden=False)
