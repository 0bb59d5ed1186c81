"""A training cell: the port's train step (`make_train_step`,
`init_train_state`) at the configuration's preset, with the training
probes (`launch/train.TRAIN_PROBES`) on the fused lane, driven by the
benchmark's own loop over seeded batches.

Set-up builds one train state from the seed's weights and drives it
through the mix's `check_steps` first steps by the same call and feed as
the window; it keeps what the check compares (the loss records the probe
stage wrote, each leaf's gradient norm as AdamW took it at step 1, read
back from its first moment, and each leaf's change after the last check
step, against the leaf made again from the seed). The window starts at
the end of set-up; every step ends in a host read of its loss. Tokens
count from the steps that ended inside the window, over the time to the
end of the last one. After the window the reference follows the check
steps from the same weights and batches."""
from __future__ import annotations

import contextlib
import statistics

import numpy as np
import torch

from . import cell as C, pattern as P, traffic as TR, weights as W
from .reference import probes as RP
from .reference.train import flat, train_readings

B1 = 0.9                      # AdamW's first-moment decay in the port


def build(cell: C.Cell, seed: int, device, faults=()):
    from repro_torch.configs.base import ModelConfig, TrainConfig
    from repro_torch.core.runtime import BpftimeRuntime
    from repro_torch.launch import train as T
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)
    m, t = cell.config["model"], cell.config["train"]
    cfg = ModelConfig(**m)
    tcfg = TrainConfig(
        microbatch=t.get("microbatch", 0), remat=t["remat"],
        optimizer=t["optimizer"], lr=t["lr"], warmup=t["warmup"],
        total_steps=t["total_steps"], weight_decay=t["weight_decay"],
        clip_norm=t["clip_norm"], param_dtype=t["param_dtype"],
        compute_dtype=t["compute_dtype"])
    rt = BpftimeRuntime()
    T.attach_train_probes(rt)
    params = W.make_params(seed, cell.config, device)
    state = init_train_state(cfg, tcfg, rt, device=device, params=params)
    step = make_train_step(cfg, tcfg, rt, probe_mode="fused")
    return state, _faulty(step, faults)


def _faulty(step, faults):
    if not faults:
        return step

    def faulty(state, batch):
        if "half_batch" in faults:
            # half of the rows left out; the loss is the mean over the rest
            dim = 1 if batch["tokens"].dim() == 3 else 0
            n = batch["tokens"].shape[dim] // 2
            batch = {k: v.narrow(dim, 0, n) for k, v in batch.items()}
        new, metrics = step(state, batch)
        if "frozen_state" in faults:
            new = {**new, "params": state["params"], "opt": state["opt"]}
        return new, metrics
    return faulty


@contextlib.contextmanager
def flash_recorder(run: C.Run):
    """Appends (kind, BH, BKH, S, hd, causal) of every flash kernel launch
    to run.flash_launches while the block runs."""
    from repro_torch.kernels import flash_attention as FA
    saved = FA.flash_fwd_cuda, FA.flash_bwd_cuda

    def fwd(q, k, v, causal=True):
        run.flash_launches.append(("fwd", q.shape[0], k.shape[0],
                                   q.shape[1], q.shape[2], bool(causal)))
        return saved[0](q, k, v, causal)

    def bwd(q, k, v, o, lse, do, causal=True):
        run.flash_launches.append(("bwd", q.shape[0], k.shape[0],
                                   q.shape[1], q.shape[2], bool(causal)))
        return saved[1](q, k, v, o, lse, do, causal)
    FA.flash_fwd_cuda, FA.flash_bwd_cuda = fwd, bwd
    try:
        yield
    finally:
        FA.flash_fwd_cuda, FA.flash_bwd_cuda = saved


def _tracer(run: C.Run):
    from repro_torch.core import events as E
    from repro_torch.core.runtime import BpftimeRuntime
    from repro_torch.models import registry as MR, ssm
    from . import profiling as P
    stack = contextlib.ExitStack()
    stack.enter_context(P.ranged({
        "forward": (MR, "loss_fn"),
        "backward": (torch.autograd, "grad"),
        "emit": (E.Collector, "emit_tensor_event"),
        "probe_stage": (BpftimeRuntime, "probe_stage"),
        "ssd_chunked": (ssm, "ssd_chunked")}))
    stack.enter_context(flash_recorder(run))
    return stack, P.Window()


def run(cell: C.Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, faults=()):
    """One run: (Run record, the numbers the check compares, attempted,
    failed). faults: as serve_cell.run; "control" also runs the float8
    reference in the program's place and reads its numbers
    ("<name>_control")."""
    from repro_torch.core.runtime import to_numpy
    tr, m = cell.traffic, cell.config["model"]
    micro = cell.config["train"].get("microbatch", 0)
    n_mb = tr["batch"] // micro if micro else 1
    if device.type == "cuda":
        torch.empty(1, device=device)      # the allocator, before its reset
        torch.cuda.reset_peak_memory_stats(device)
    state, step = build(cell, seed, device, faults)
    vetoed, n_steps = 0, 0

    def one(s):
        nonlocal state, vetoed, n_steps
        state, met = step(state, TR.train_batch(tr, cell.config, seed, s,
                                                device))
        float(met["loss"])                   # the step's host read
        vetoed += int(met["vetoed"])
        n_steps += 1

    n_check = tr["check_steps"]
    for s in range(n_check):
        one(s)
        if s == 0:
            grad_norms = {k: float(v.norm()) / (1 - B1)
                          for k, v in flat(state["opt"]["m"]).items()}
    records = RP.ring_records(to_numpy(state["maps"])["tr_loss_rb"], 0,
                              n_mb * n_check)
    change_norms = {
        k: float((v.float() - W.first_value(seed, cell.config, k, device)
                  ).norm())
        for k, v in flat(state["params"]).items()}

    rec = C.Run(mode="train", config=cell.config, traffic=tr,
                tokens_per_step=tr["batch"] * tr["seq_len"])
    tracing = _tracer(rec) if trace else None
    C.sync(device)
    t0 = C.now()
    rec.setup_s = t0 - t_start
    deadline = t0 + seconds
    s = n_check
    while True:
        durations = [b - a for a, b in rec.steps]
        if durations and C.now() + statistics.median(durations) > deadline:
            break
        if tracing is not None and len(rec.steps) == 0:
            tracing[0].__enter__()
            tracing[1].start()
        a = C.now()
        one(s)
        b = C.now()
        s += 1
        if tracing is not None and len(rec.steps) + 1 == tr["trace_steps"]:
            rec.trace = tracing[1].stop()
            tracing[0].close()
            rec.traced_steps = tr["trace_steps"]
            tracing = None
        if b > deadline:
            break
        rec.steps.append((a, b))
    if tracing is not None:
        rec.trace = tracing[1].stop()
        tracing[0].close()
        rec.traced_steps = len(rec.steps)
    rec.window = (t0, rec.steps[-1][1] if rec.steps else t0)
    C.sync(device)
    if device.type == "cuda":
        rec.peak_bytes = torch.cuda.max_memory_allocated(device)
    maps = to_numpy(state["maps"])
    del state, step
    if device.type == "cuda":
        torch.cuda.empty_cache()

    params = W.make_params(seed, cell.config, device)
    batches = [TR.as_microbatches(TR.train_batch(tr, cell.config, seed, s,
                                                 device))
               for s in range(n_check)]
    ref = train_readings(params, batches, cell.config, n_check)
    values = compare(ref, records, grad_norms, change_norms)
    if "control" in faults:
        low = train_readings(params, batches, cell.config, n_check,
                             precision="float8")
        fx = [[0, 0, round(x * RP.FX_ONE), 0] for st in low["losses"]
              for x in st]
        values.update({f"{k}_control": v for k, v in compare(
            ref, np.asarray(fx, np.int64), low["grad_norms"],
            low["change_norms"]).items()})
    del params, batches
    # every layer's block entry counts at its superblock's id
    ids, per_id = P.stacked(m), n_mb * n_steps * P.superblock(m)
    values["counter_errors"] = (
        RP.counter_errors(maps["tr_layer_counts"], per_id, ids, "array")
        + RP.counter_errors(maps["tr_key_hash"], per_id, ids, "hash"))
    values["hist_count_error"] = RP.hist_total_error(maps["tr_gnorm_hist"],
                                                     n_steps)
    values["ring_head_error"] = RP.ring_head_error(maps["tr_loss_rb"],
                                                   n_mb * n_steps)
    values["vetoed_steps"] = vetoed
    return rec, values, n_steps, vetoed


def leaf_gaps(got: dict, want: dict, keep=None) -> dict:
    """Per leaf, |got - want| over the larger of want's norm of that leaf
    and of the median leaf."""
    med = statistics.median(want.values())
    return {k: abs(got[k] - w) / max(w, med) for k, w in want.items()
            if keep is None or k in keep}


def compare(ref: dict, records, grad_norms: dict, change_norms: dict) -> dict:
    """The numbers of the training check: the worst relative gap of a
    microbatch's loss record; the median over the leaves of a leaf's
    step-1 gradient-norm gap and of its change gap after the check steps.
    Leaves whose reference gradient is under a thousandth of the median
    leaf's (moved by round-off alone under AdamW) are left out of the
    change. The cell's limits file says which are compared; the worst
    leaf of each is reported beside them for calibrate.py (PERF.md says
    why none of these is compared)."""
    losses = [x for step in ref["losses"] for x in step]
    med = statistics.median(ref["grad_norms"].values())
    moved = {k for k, g in ref["grad_norms"].items() if g >= 1e-3 * med}
    grad = leaf_gaps(grad_norms, ref["grad_norms"])
    change = leaf_gaps(change_norms, ref["change_norms"], moved)
    return {
        "loss_gap": RP.loss_record_gap(records, losses),
        "grad_gap": statistics.median(grad.values()),
        "update_gap": statistics.median(change.values()),
        "grad_gap_worst_leaf": max(grad.values()),
        "update_gap_worst_leaf": max(change.values()),
        # where the worst leaves are (read by calibrate.py, not compared)
        "grad_gap_leaves": _worst(grad),
        "update_gap_leaves": _worst(change),
    }


def _worst(gaps: dict, n: int = 3) -> list:
    top = sorted(gaps.items(), key=lambda kv: -kv[1])[:n]
    return ["/".join(map(str, k)) + f"={v:.3g}" for k, v in top]
