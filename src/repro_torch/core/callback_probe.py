"""\"Kernel-mode\" probe baseline -- the analogue of kernel uprobes.

Events cross the device->host boundary (the int3 trap and double context
switch of the paper): the tape is copied to the host, which waits for the
device; each event runs in the reference interpreter (`vm.run`) on the
host numpy maps; the device waits for the host before the next step. The
JAX package inserts the same round trip with `io_callback`; here it is a
direct call. This is the baseline the in-step probe stage beats.
"""
from __future__ import annotations

from . import vm


def host_probe_stage(runtime, event_rows, step: int) -> int:
    """Run every device attachment of `runtime` over `event_rows` i64[N, 16]
    on the host: side effects land in runtime.host_maps. Returns the number
    of events (the JAX package's token)."""
    rows_np = event_rows.detach().cpu().numpy()     # the trap: wait, copy
    attach = sorted(runtime.device_attach.items())
    for (sid, kind), pids in attach:
        mask = (rows_np[:, 0] == sid) & (rows_np[:, 1] == kind)
        for pid in pids:
            p = runtime.progs[pid]
            for row in rows_np[mask]:
                row = row.copy()
                row[3] = int(step)
                ctx = vm.pack_ctx([int(x) for x in row])
                vm.run(p.insns, ctx, runtime.map_specs, runtime.host_maps,
                       vm.Aux(time_ns=int(step), pid=runtime.syscalls.pid))
    return int(rows_np.shape[0])
