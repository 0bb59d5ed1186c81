"""Quickstart on the PyTorch port: write an eBPF program, verify it,
attach it to a model's probe sites, run a few training steps, read the
maps. The twin of examples/quickstart.py, on `repro_torch`.

    PYTHONPATH=src python examples/torch/quickstart.py              # CUDA
    PYTHONPATH=src python examples/torch/quickstart.py --device cpu
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

# 1. an eBPF program, in our assembler (the clang stand-in): count events
#    per layer and histogram activation RMS -- bcc-style, zero model changes
PROG = """
    mov r9, r1                    ; save ctx (calls clobber r1-r5)
    ldxdw r6, [r1+ctx:layer]      ; CO-RE-lite ctx field relocation
    stxdw [r10-8], r6
    lddw r1, map:layer_hits       ; symbolic map reloc (libbpf-style)
    mov r2, r10
    add r2, -8
    mov r3, 1
    call map_fetch_add
    ldxdw r2, [r9+ctx:rms]        ; Q47.16 fixed-point activation RMS
    lddw r1, map:rms_hist
    call hist_add
    mov r0, 0
    exit
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    rt = BpftimeRuntime()
    pid = rt.load_asm(                  # load = relocate + VERIFY + jit
        "quickstart", PROG,
        maps=[M.MapSpec("layer_hits", M.MapKind.ARRAY, max_entries=64),
              M.MapSpec("rms_hist", M.MapKind.LOG2HIST)])
    rt.attach(pid, "uprobe:block")      # fire on every block entry

    # 2. train a small model -- the probe stage runs inside the step, on
    #    the step's device
    cfg = registry.smoke("llama3.2-1b")
    tcfg = TrainConfig(warmup=2)
    state = init_train_state(cfg, tcfg, rt, device=args.device)
    step = make_train_step(cfg, tcfg, rt)
    data = SyntheticDataset(cfg, ShapeConfig("q", 64, 8, "train"), tcfg,
                            runtime=rt)
    for i in range(5):
        state, metrics = step(state, data.next())
        print(f"step {i}: loss={float(metrics['loss']):.4f}")

    # 3. read the maps (device tensors: one copy to the host, here)
    hits = state["maps"]["layer_hits"]["values"].cpu().numpy()
    print(f"\nper-layer probe hits: {hits[:cfg.num_layers].tolist()}")
    print("\nactivation RMS histogram (bcc-style):")
    print(render_log2_hist(state["maps"]["rms_hist"]["bins"].cpu().numpy(),
                           label="rms"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
