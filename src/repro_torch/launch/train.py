"""End-to-end training driver, on the GPU by default.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen2-0.5b \
        --steps 50 [--full] [--batch 8 --seq 64] [--device cpu] \
        [--probes] [--shm DIR [--worker-id w0]] [--ckpt DIR --save-every 2]

`--smoke` (the default) trains the reduced config of the architecture;
`--full` trains it at its published widths. Integration points exercised
here (the paper's workflow, §3.2):
  * probes attach/detach between steps WITHOUT restarting training -- an
    attach_epoch change rebuilds the step, state carries over;
  * a shm control plane lets an external daemon read the maps after every
    step and inject programs live;
  * per-step syscalls (data fetch, checkpoint, step begin and end) run
    their eBPF hooks; filter programs can veto batches or checkpoints;
  * with the live lane on, table attaches land on the running step at the
    next `sync_live_table`, and promoted links hand the loop the step
    their promotion built.

TRAIN_PROBES is the instrumentation chip_smoke.py trains with.
"""
from __future__ import annotations

import argparse
import time

import torch

# Per-layer ARRAY and HASH counters on block entry (as in serving), an rms
# LOG2HIST of the gradient norm, a RINGBUF record (step, numel, mean,
# nan_cnt) of every loss, and a NaN guard: a filter on the loss that calls
# override_return when its NaN-count lane is non-zero, which vetoes the
# step's update. Each entry: (name, asm text, map spec (name, kind,
# max_entries, rec_width) or None, program type, target).
_COUNT = """
    ldxdw r6, [r1+ctx:layer]
    stxdw [r10-8], r6
    lddw r1, map:{map}
    mov r2, r10
    add r2, -8
    mov r3, 1
    call map_fetch_add
    mov r0, 0
    exit
"""
_HIST_RMS = """
    ldxdw r2, [r1+ctx:rms]
    lddw r1, map:tr_gnorm_hist
    call hist_add
    mov r0, 0
    exit
"""
_RB_LOSS = """
    ldxdw r6, [r1+ctx:step]
    stxdw [r10-32], r6
    ldxdw r6, [r1+ctx:numel]
    stxdw [r10-24], r6
    ldxdw r6, [r1+ctx:mean]
    stxdw [r10-16], r6
    ldxdw r6, [r1+ctx:nan_cnt]
    stxdw [r10-8], r6
    lddw r1, map:tr_loss_rb
    mov r2, r10
    add r2, -32
    mov r3, 32
    mov r4, 0
    call ringbuf_output
    mov r0, 0
    exit
"""
NAN_GUARD = """
    ldxdw r6, [r1+ctx:nan_cnt]
    jeq r6, 0, ok
    mov r1, 1
    call override_return
    ok:
    mov r0, 0
    exit
"""
TRAIN_PROBES = [
    ("tr_count", _COUNT.format(map="tr_layer_counts"),
     ("tr_layer_counts", "array", 128, 4), "uprobe", "uprobe:block"),
    ("tr_hash", _COUNT.format(map="tr_key_hash"),
     ("tr_key_hash", "hash", 256, 4), "uprobe", "uprobe:block"),
    ("tr_hist", _HIST_RMS, ("tr_gnorm_hist", "log2hist", 64, 4), "uprobe",
     "probe:grad.norm"),
    ("tr_rb", _RB_LOSS, ("tr_loss_rb", "ringbuf", 64, 4), "uprobe",
     "probe:loss"),
    ("tr_nan_guard", NAN_GUARD, None, "uprobe", "probe:loss"),
]


def attach_train_probes(rt):
    """Load TRAIN_PROBES into `rt` and attach them on the fused lane;
    returns the links."""
    from ..core.maps import MapKind, MapSpec
    links = []
    for name, text, spec, ptype, target in TRAIN_PROBES:
        maps = [] if spec is None else [
            MapSpec(spec[0], MapKind(spec[1]), spec[2], rec_width=spec[3])]
        pid = rt.load_asm(name, text, maps, ptype)
        links.append(rt.attach(pid, target, mode="fused"))
    return links


def run_training(arch: str, *, steps: int = 20, smoke: bool = True,
                 runtime=None, shm_dir: str | None = None,
                 worker_id: str | None = None,
                 worker_group: str | None = None,
                 ckpt_dir: str | None = None, save_every: int = 0,
                 probe_mode: str = "scan", seq_len: int = 64,
                 batch: int = 8, microbatch: int = 0, log_every: int = 10,
                 on_step=None, max_data_skips: int = 1000,
                 cache_dir: str | None = None, device="cuda"):
    """Train `arch` for `steps` steps on `device` (CUDA unless the caller
    passes "cpu"). Returns (state, history); history holds one dict of
    floats per step (loss, grad_norm, lr, vetoed). on_step(step, state,
    metrics) runs after each step. With a runtime, `shm_dir` joins the
    shm plane (as <shm_dir>/workers/<worker_id>/ with an id) and
    `cache_dir` names the artifact cache of table images (default
    <shm_dir>/cache); `ckpt_dir` with `save_every` saves a blocking
    checkpoint every `save_every` steps."""
    from ..configs import registry
    from ..configs.base import ShapeConfig, TrainConfig
    from ..data.pipeline import SyntheticDataset
    from ..device import resolve
    from ..train.train_step import init_train_state, make_train_step
    from ..ckpt import checkpoint as CK

    dev = resolve(device)
    cfg = registry.smoke(arch) if smoke else registry.get(arch)
    tcfg = TrainConfig(microbatch=microbatch, remat=True, warmup=10,
                       total_steps=steps)
    shape = ShapeConfig("driver", seq_len, batch, "train")
    if runtime is not None and cache_dir:
        # explicit cache dir wins over the <shm>/cache default setup_shm
        # would otherwise join
        runtime.enable_artifact_cache(cache_dir)
    if runtime is not None and shm_dir:
        # worker_id=None keeps the single-process layout; with an id, this
        # trainer joins <shm_dir>/workers/<wid>/ so a fleet daemon can
        # aggregate several trainers into one global map view; worker_group
        # names the node aggregator that folds this trainer in a
        # hierarchical fleet
        runtime.setup_shm(shm_dir, worker_id=worker_id, group=worker_group)

    data = SyntheticDataset(cfg, shape, tcfg, runtime=runtime)
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    state = init_train_state(cfg, tcfg, runtime, gen, dev)

    step_fns: dict[int, object] = {}

    def build_step():
        return make_train_step(cfg, tcfg, runtime, probe_mode=probe_mode)

    def get_step_fn():
        """The step for the current attach set: rebuilt when a probe is
        attached or detached, so the state carries over. A promoted table
        link hands over the step its promotion built (core/promote.py)."""
        epoch = runtime.attach_epoch if runtime else 0
        if epoch not in step_fns:
            promoted = runtime.take_promoted_step() if runtime else None
            step_fns[epoch] = promoted or build_step()
        return step_fns[epoch]

    def arm_promotion(batch_np):
        """Hand the promotion engine the loop's step builder and its call
        arguments, so table-lane links attached later converge to the
        fused lane without a build in the loop."""
        if runtime is None or runtime.live is None \
                or runtime._promoter is not None:
            return
        runtime.enable_promotion(build_step, (state, batch_np))

    history = []
    t0 = time.time()
    skips = 0          # consecutive vetoed/faulted batches: bounded spin
    s = 0
    while s < steps:
        if runtime is not None:
            runtime.poll_control()
            state["maps"] = runtime.sync_live_table(state["maps"])
            runtime.syscalls.invoke("sys_step_begin", [s], impl=lambda: None)
        batch_np = data.next()
        if batch_np is None:                 # vetoed/faulted batch
            skips += 1
            if max_data_skips and skips >= max_data_skips:
                raise RuntimeError(
                    f"data pipeline yielded no batch {skips} times in a "
                    f"row -- a filter is vetoing every fetch")
            continue
        skips = 0
        arm_promotion(batch_np)              # no-op after the first batch
        state, metrics = get_step_fn()(state, batch_np)
        history.append({k: float(v) for k, v in metrics.items()})
        s = int(state["step"])
        if runtime is not None:
            runtime.publish(state["maps"])
            runtime.syscalls.invoke(
                "sys_step_end", [s, int(1e6 * (time.time() - t0))],
                impl=lambda: None)
        if ckpt_dir and save_every and s % save_every == 0:
            CK.save(ckpt_dir, s, state, runtime=runtime, blocking=True)
        if on_step is not None:
            on_step(s, state, metrics)
        if log_every and s % log_every == 0:
            print(f"step {s}: loss={history[-1]['loss']:.4f} "
                  f"gnorm={history[-1]['grad_norm']:.3f} "
                  f"({(time.time() - t0) / max(s, 1):.2f}s/step)")
    return state, history


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen2-0.5b")
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--smoke", action="store_true", default=True,
                    help="train the reduced config (the default)")
    ap.add_argument("--full", dest="smoke", action="store_false",
                    help="train the config at its published widths")
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--shm")
    ap.add_argument("--worker-id",
                    help="join the fleet layout as <shm>/workers/<id>/")
    ap.add_argument("--worker-group",
                    help="aggregation group: the node aggregator that "
                         "folds this trainer in a hierarchical fleet")
    ap.add_argument("--ckpt")
    ap.add_argument("--save-every", type=int, default=0)
    ap.add_argument("--cache",
                    help="artifact cache directory of table images "
                         "(defaults to <shm>/cache when --shm is given)")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--probes", action="store_true",
                    help="attach TRAIN_PROBES on the fused lane")
    args = ap.parse_args(argv)

    from ..core.runtime import BpftimeRuntime
    rt = BpftimeRuntime() if (args.shm or args.cache or args.probes) \
        else None
    if args.probes:
        attach_train_probes(rt)
    state, hist = run_training(
        args.arch, steps=args.steps, smoke=args.smoke, runtime=rt,
        shm_dir=args.shm, worker_id=args.worker_id,
        worker_group=args.worker_group, ckpt_dir=args.ckpt,
        save_every=args.save_every, batch=args.batch, seq_len=args.seq,
        cache_dir=args.cache, device=args.device)
    print(f"final loss {hist[-1]['loss']:.4f} after {len(hist)} steps")


if __name__ == "__main__":
    main()
