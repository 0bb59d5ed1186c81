"""opensnoop analogue on the PyTorch port: trace framework syscalls (data
fetches, checkpoint saves) with enter/exit tracepoints + a ring buffer,
and FILTER some of them (syscall-hook override). The twin of
examples/opensnoop_syscalls.py, on `repro_torch`: the ring buffer is a
host map, drained with `maps.n_ringbuf_drain`.

    PYTHONPATH=src python examples/torch/opensnoop_syscalls.py      # CUDA
    PYTHONPATH=src python examples/torch/opensnoop_syscalls.py --device cpu
"""
import argparse
import shutil
import sys
import tempfile

from repro_torch.ckpt import checkpoint as CK
from repro_torch.configs import registry
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.core import maps as M
from repro_torch.core.runtime import BpftimeRuntime
from repro_torch.core.syscalls import SYSCALL_IDS
from repro_torch.data.pipeline import SyntheticDataset
from repro_torch.train.train_step import init_train_state, make_train_step

SNOOP = """
    ldxdw r6, [r1+ctx:sys_id]
    stxdw [r10-32], r6
    ldxdw r6, [r1+ctx:arg0]
    stxdw [r10-24], r6
    ldxdw r6, [r1+ctx:ret]
    stxdw [r10-16], r6
    lddw r1, map:events
    mov r2, r10
    add r2, -32
    mov r3, 24
    mov r4, 0
    call ringbuf_output
    mov r0, 0
    exit
"""

NO_CKPT_BEFORE_STEP5 = """
    ldxdw r6, [r1+ctx:arg0]     ; step number
    jge r6, 5, allow
    mov r1, -13                 ; -EACCES
    call override_return
    allow:
    mov r0, 0
    exit
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    rt = BpftimeRuntime()
    rb = M.MapSpec("events", M.MapKind.RINGBUF, max_entries=64, rec_width=3)
    pid = rt.load_asm("snoop", SNOOP, [rb], "tracepoint")
    rt.attach(pid, "tracepoint:sys_data_fetch:exit")
    rt.attach(pid, "tracepoint:sys_checkpoint_save:exit")
    flt = rt.load_asm("nockpt", NO_CKPT_BEFORE_STEP5, [], "filter")
    rt.attach(flt, "filter:sys_checkpoint_save")

    cfg = registry.smoke("mamba2-780m")
    tcfg = TrainConfig(warmup=2)
    state = init_train_state(cfg, tcfg, rt, device=args.device)
    step = make_train_step(cfg, tcfg, rt)
    data = SyntheticDataset(cfg, ShapeConfig("o", 32, 4, "train"), tcfg,
                            runtime=rt)

    ckpt_dir = tempfile.mkdtemp(prefix="opensnoop_ckpt_")
    try:
        for _ in range(8):
            state, m = step(state, data.next())
            CK.save(ckpt_dir, int(state["step"]), state, runtime=rt)
        latest = CK.latest(ckpt_dir)
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    print(f"latest committed checkpoint: step {latest} "
          "(steps 1-4 were vetoed by the filter)\n")

    names = {v: k for k, v in SYSCALL_IDS.items()}
    recs, _ = M.n_ringbuf_drain(rt.host_maps["events"], 0)
    print(f"{'SYSCALL':24s} {'ARG0':>6s} {'RET':>5s}")
    for sid, arg0, ret in recs[-16:]:
        print(f"{names.get(sid, sid):24s} {arg0:6d} {ret:5d}")

    assert latest == 8, f"filter should only block steps < 5, got {latest}"
    assert recs, "ring buffer should have captured syscall records"
    assert any(names.get(sid) == "sys_checkpoint_save" and ret != 0
               for sid, _a, ret in recs), "no vetoed save was traced"
    print("OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
