"""End-to-end run on the PyTorch port: train a ~100M-param llama-family
model for a few hundred steps with checkpointing, resume, and full bpftime
instrumentation. The twin of examples/train_e2e.py, on `repro_torch`.

    PYTHONPATH=src python examples/torch/train_e2e.py --steps 300   # CUDA
    PYTHONPATH=src python examples/torch/train_e2e.py --device cpu --steps 4
    (defaults to 40 steps; checkpoints every 10 steps under the temporary
     directory, rerun with --resume to continue from the latest)
"""
import argparse
import dataclasses
import os
import sys
import tempfile
import time

from repro_torch.ckpt import checkpoint as CK
from repro_torch.configs import registry
from repro_torch.configs.base import ShapeConfig, TrainConfig
from repro_torch.core import maps as M
from repro_torch.core.daemon import render_log2_hist
from repro_torch.core.runtime import BpftimeRuntime
from repro_torch.data.pipeline import SyntheticDataset
from repro_torch.train.train_step import init_train_state, make_train_step

PROG = """
    mov r9, r1                   ; save ctx across helper calls
    ldxdw r6, [r1+ctx:layer]
    stxdw [r10-8], r6
    lddw r1, map:layer_hits
    mov r2, r10
    add r2, -8
    mov r3, 1
    call map_fetch_add
    ldxdw r2, [r9+ctx:rms]
    lddw r1, map:act_hist
    call hist_add
    mov r0, 0
    exit
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=40)
    ap.add_argument("--resume", action="store_true")
    args = ap.parse_args(argv)

    # ~100M params: llama3.2 family, 12 layers, d=512 (84M + embeddings)
    cfg = dataclasses.replace(
        registry.get("llama3.2-1b"), num_layers=12, d_model=512, num_heads=8,
        num_kv_heads=4, head_dim=64, d_ff=2048, vocab_size=32768,
        dtype="float32")
    print(f"model: {cfg.param_counts()['total'] / 1e6:.0f}M params")

    rt = BpftimeRuntime()
    pid = rt.load_asm("watch", PROG, [
        M.MapSpec("layer_hits", M.MapKind.ARRAY, max_entries=64),
        M.MapSpec("act_hist", M.MapKind.LOG2HIST)])
    rt.attach(pid, "uprobe:block")

    tcfg = TrainConfig(warmup=20, total_steps=max(args.steps, 100), lr=6e-4,
                       microbatch=2)
    shape = ShapeConfig("e2e", seq_len=64, global_batch=4, mode="train")
    ckpt_dir = os.path.join(tempfile.gettempdir(), "train_e2e_ckpt")

    state = init_train_state(cfg, tcfg, rt, device=args.device)
    if args.resume and CK.latest(ckpt_dir) is not None:
        state = CK.restore(ckpt_dir, CK.latest(ckpt_dir), state, runtime=rt,
                           device=args.device)
        print(f"resumed from step {int(state['step'])}")

    data = SyntheticDataset(cfg, shape, tcfg, runtime=rt)
    data.step = int(state["step"])          # checkpointable cursor
    step = make_train_step(cfg, tcfg, rt, probe_mode="vectorized")

    t0 = time.time()
    losses, writers = [], []
    while int(state["step"]) < args.steps:
        batch = data.next()
        if batch is None:
            continue
        state, m = step(state, batch)
        s = int(state["step"])
        losses.append(float(m["loss"]))
        if s % 10 == 0:
            writers.append(CK.save(ckpt_dir, s, state, runtime=rt,
                                   blocking=False))
            print(f"step {s:4d}  loss {losses[-1]:.4f}  "
                  f"gnorm {float(m['grad_norm']):.3f}  "
                  f"{(time.time() - t0) / max(s, 1):.2f}s/step")
    for w in writers:                       # the writes finish before exit
        if w is not None:
            w.join()

    if losses:
        print(f"\nloss: {losses[0]:.3f} -> {losses[-1]:.3f} over "
              f"{len(losses)} steps")
    hits = state["maps"]["layer_hits"]["values"].cpu().numpy()
    print(f"probe hits/layer: {hits[:cfg.num_layers].tolist()}")
    print(render_log2_hist(state["maps"]["act_hist"]["bins"].cpu().numpy(),
                           label="act rms"))
    print(f"latest checkpoint: step {CK.latest(ckpt_dir)} at {ckpt_dir} "
          "(rerun with --resume)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
