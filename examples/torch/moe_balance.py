"""MoE router monitoring on the PyTorch port -- the expert-balance use
case: per-expert load in an eBPF map + drop-rate histogram, watched during
training of a (reduced) llama4-scout MoE. The twin of
examples/moe_balance.py, on `repro_torch`.

    PYTHONPATH=src python examples/torch/moe_balance.py              # CUDA
    PYTHONPATH=src python examples/torch/moe_balance.py --device cpu
"""
import argparse
import sys

from repro_torch.configs import registry
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.core import maps as M
from repro_torch.core.daemon import render_log2_hist
from repro_torch.core.runtime import BpftimeRuntime
from repro_torch.data.pipeline import SyntheticDataset
from repro_torch.train.train_step import init_train_state, make_train_step

# moe.load site emits the router's per-expert token counts as stats:
# mean*E = tokens routed; we histogram the MAX load (imbalance indicator)
# and count drops per step.
BALANCE = """
    ldxdw r2, [r1+ctx:max]       ; max per-expert load this step
    lddw r1, map:load_hist
    call hist_add
    mov r0, 0
    exit
"""
DROPS = """
    ldxdw r6, [r1+ctx:mean]      ; drops count (scalar tensor -> mean)
    mov r7, 0
    stxdw [r10-8], r7
    lddw r1, map:total_drops
    mov r2, r10
    add r2, -8
    arsh r6, 16                  ; fixed-point -> integer
    mov r3, r6
    call map_fetch_add
    mov r0, 0
    exit
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    rt = BpftimeRuntime()
    p1 = rt.load_asm("balance", BALANCE,
                     [M.MapSpec("load_hist", M.MapKind.LOG2HIST)])
    rt.attach(p1, "probe:moe.load")
    p2 = rt.load_asm("drops", DROPS,
                     [M.MapSpec("total_drops", M.MapKind.ARRAY,
                                max_entries=4)])
    rt.attach(p2, "probe:moe.drops")

    cfg = registry.smoke("llama4-scout-17b-a16e")
    tcfg = TrainConfig(warmup=2)
    state = init_train_state(cfg, tcfg, rt, device=args.device)
    step = make_train_step(cfg, tcfg, rt)
    data = SyntheticDataset(cfg, ShapeConfig("m", 64, 8, "train"), tcfg,
                            runtime=rt)
    for _ in range(6):
        state, m = step(state, data.next())

    print("max per-expert load histogram (per router invocation):")
    print(render_log2_hist(state["maps"]["load_hist"]["bins"].cpu().numpy(),
                           label="max load"))
    drops = int(state["maps"]["total_drops"]["values"][0])
    print(f"\ntotal capacity drops across run: {drops}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
