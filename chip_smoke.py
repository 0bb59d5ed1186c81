#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py              # all phases; needs one CUDA device
    python3 chip_smoke.py --kernels    # phases 1-2 only (build + checks)

Phases:
  1. build the five Hopper kernel sources from src/repro_torch/kernels/csrc
     with nvcc (one process per source, in parallel); print each bf16 flash
     kernel's registers, spill bytes and shared memory (ptxas -v) and its
     HGMMA (wgmma) instructions in `cuobjdump -sass` of the library, and
     fail if one has no HGMMA; print the same ptxas numbers and the stack
     frame for every tensor_stats, hash, ringbuf and interpreter kernel,
     beside the dynamic shared memory each asks for, and fail if the
     interpreter has a stack frame;
  2. hold each kernel against its plain PyTorch version on the card, at the
     main paths' shapes and at stress shapes, and time both: the device
     time per launch (torch.profiler) beside the host's time per wrapper
     call. tensor_stats through its dict and its row entry (the row's
     Q47.16 lanes bit for bit `to_fx` of the kernel's stats); the hash
     kernel on its shared and its global route; the ring-buffer apply
     (data, head and the dropped lap count) from heads that lap; the table
     interpreter on an eight-slot table of both sub-lanes at 49, 600 and
     4096 events (every helper, full HASH maps, fuel cut short; at 49 and
     4096 also its per-phase split from the kernel's clock64() stamps and
     the instructions the plain version executed), on a branching HASH
     program forced onto the vec sub-lane on the shared and the global
     route, on the ISA traps and on every fuzz-corpus program on each
     sub-lane that takes it, against the plain version on CPU copies;
     flash attention forward and backward also
     against scaled_dot_product_attention's forward and its backward alone
     (the yardsticks, never called by the port), and the backward twice for
     bit-identity;
  3. serve qwen2-0.5b at full width (bf16, random weights from a seed):
     8 requests, 4 slots, max_seq 128, max_new 8, the sys_serve_admit filter
     at limit 12, and four probes on the fused lane (ARRAY and HASH layer
     counters on uprobe:block, an rms LOG2HIST on uretprobe:block, a RINGBUF
     record on probe:logits); the serving kernels must have launched on
     this path and tensor_stats once per collected event. The smoke-width
     model is also served on the card and on the CPU and the two compared;
  4. replay the last decode step's tape through the scan and vectorized
     modes: their map states must equal the fused lane's bit for bit;
  5. serve again warm (host clock), with the probes and with no device
     probe attached, and once under torch.profiler: device busy share,
     device time by kernel group, and the device operations (kernels,
     copies, fills) each collected event costs, which must be exactly one
     tensor_stats launch;
  6. the live lane while qwen2-0.5b serves at full width: the phase 3
     runtime with `enable_live_attach(arm=LIVE_ARM)` before the engine is
     built; after the first requests, three programs (launch/serve.py
     LIVE_PROBES: a vec, a sequential and a vec slot) are attached with
     mode="table" and synced, the rest served; then one is detached and a
     fourth attached with promote=True, served on the table, and promoted
     to the fused lane at the next sync under enable_promotion(...,
     background=False). Fails unless the decode step object is unchanged,
     the interpreter launched once per probed step, every probed step's
     map states equal a replay through a runtime with the same programs
     on the fused lane and a replay through the table lane with the table
     of the generation the step ran, and one probed decode step on a side
     stream gives the default stream's tokens, tape and maps. Prints the
     attach-to-run latency, warm ms per decode step with the three
     programs on the table lane, the fused lane and not attached, us per
     event on one decode tape for the fused lane, the table lane and
     callback_probe's host round trip, and the interpreter alone with the
     serving table on that tape (device us, host us, phase split);
  7. train qwen2-0.5b at full width through launch/train.run_training:
     seq 4096, global batch 4 in microbatches of 2, AdamW, remat, 3 steps,
     the TRAIN_PROBES set on the fused lane (layer counters, a gradient-norm
     histogram, a loss record and a NaN guard); every attention layer runs
     the flash kernels, forward (and again in the remat recompute) and
     backward, and all five kernels must have launched. Then one more step
     under torch.profiler (device busy share, time by kernel group, device
     operations per event, again exactly one), and two steps with no
     program attached;
  8. one training step of the smoke-width model (f32) at seq 4096 on the
     card and on the CPU from the same weights and batch: loss, gradient
     norm, updated parameters and maps compared;
  9. the fleet worker and durable training, in a temporary directory it
     deletes: (a) phase 3's model, probes and admission filter with the
     live lane, served by ServeEngine(shm_dir=..., worker_id="w0"); after
     4 requests a load_attach of LIVE_PROBES[0] (mode "table") is queued
     through a second ShmRegion handle, after 4 more a detach of the link
     status.json reports, then 2 more. Fails unless the decode step is
     unchanged, both requests applied without error, the interpreter
     launched once per probed step and the program counted on exactly the
     steps it was attached, every probed step equals a fused-lane replay,
     status.json shows the program in live_slots and then not, and a
     reader process (spawn, the port alone) reads every map of w0 with an
     even seq and a valid CRC, bit for bit the engine's maps. Prints the
     host us per publish (median, p90), the bytes per publish, the ms from
     queueing the request to the end of the first probe stage that ran
     it, and warm ms per decode step with the shm plane and without, in
     turns. (b) one training step at phase 7's shape and probes with
     grad_compression="int8": the int8 round trip of its clipped gradients
     on the card bit for bit the same function on CPU copies; its device
     ms and the compression error. (c) run_training for 2 steps as shm
     worker t0 with a blocking checkpoint after each; step_1 restored into
     a fresh state on the card and step 2 taken again with the same
     batch: parameters, optimizer state, step and maps equal step_2's
     files bit for bit, and t0's published maps the final state's. Prints
     the GB per checkpoint and the seconds to save and to restore;
 10. the fleet aggregator and the grammar fuzzer, in a temporary
     directory it deletes: (a) four ServeEngine workers w000-w003 on the
     card (phase 6's runtime each, one set of phase 3's weights) serve
     seeded requests in turns while a spawned process (the port alone)
     runs TreeAggregator(fan_in=2, depth=1) with its node folds on the
     card; after w000's turn of round 2 `python -m
     repro_torch.core.daemon <root> attach LIVE_PROBES[0] --mode table
     --worker w001 --worker w002` queues an attach, after its turn of
     round 3 the matching detach. Fails unless the root's global view is
     bit for bit the flat oracle (the workers' final published maps
     folded by the numpy twins) and a fresh flat Aggregator's, `fleet
     health --json` shows four HEALTHY workers, two nodes and no
     stream_lost or hash_dropped, `map dump` of the HASH map is the global
     view, the program counted on w001 and w002 only while attached, and
     their probed steps equal a fused-lane replay. Prints host ms per node
     and root cycle, the node fold's device ms beside the numpy twin's on
     the same stacks, ms from a publish to the first root view that holds
     it, and the CLI request's ms from queue to first run. (b) 64 worker
     regions with benchmarks/probe_pipeline.py's fleet-scale specs and
     schedule (384 events a worker a round, 7 rounds after a warm one)
     folded by a tree of fan-in 8 on the card, the same tree with the
     numpy twins and the flat Aggregator: all three views bit for bit
     equal; median ms per node, root and flat cycle. (c) the port's fuzz
     harness over seeds 0-99 and more within 30 s, every lane on the
     card, and every tests/corpus case: no mismatch; cases, lanes by
     kind, interpreter launches, seconds.

Prints a JSON line of per-kernel numbers, the card's name and power limit,
and as its last line {"ok": true, "device": {...}}. Any failure exits
non-zero; without CUDA, or without the repository beside it, it exits
non-zero before printing any result. No JAX is imported.
"""
from __future__ import annotations

import contextlib
import gc
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# published peaks of the H100 SXM at its 700 W power limit (NVIDIA data
# sheet): device memory, f32 outside the tensor cores, bf16 dense on them
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
BF16_OPS_PER_S = 989e12
STATS_TOL = 2e-5
# flash attention: the tolerances are `kernels/flash_attention.TOL_*`,
# shared with the tests (f32 as test_flash_kernel.py; bf16 o one rounding
# apart, lse within 1e-4, gradients with atol scaled by their largest
# magnitude -- the plain version rounds each q head's dk/dv share to bf16
# before the rep-group sum, the kernel rounds the sum once -- and within
# 1e-2 in relative norm per output)
# the bf16 flash kernels (namespace sm90 of csrc/flash_attention_sm90.cuh)
FLASH_SM90 = ("fwd_kernel", "dkv_kernel", "dq_kernel")
# the smoke-width training step card vs CPU (f32, TF32 off), whose sums run
# in other orders: loss, gradient norm and each gradient leaf within 1e-4
# relative, updated parameters within 3e-5 absolute, a tenth of the first
# step's AdamW move (lr 3e-4 x sign(g))
TRAIN_CMP_TOL = 1e-4
TRAIN_PARAM_TOL = 3e-5
SEED = 0


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bound_ms(nbytes: float, ops: float,
             ops_per_s: float = F32_OPS_PER_S) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_PER_S, ops / ops_per_s
    return (max(tb, to) * 1e3, "bytes" if tb >= to else "operations")


def cuda_ms(torch, fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of fn() over `reps` back-to-back calls (CUDA
    events, after warm-up)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / reps


# --------------------------------------------------------------------------
# phase 1: what the build made of the bf16 flash kernels
# --------------------------------------------------------------------------

def _sm90_label(mangled: str):
    """`dkv_kernel<64>` for a mangled sm90 flash kernel's name, else None."""
    for k in FLASH_SM90:
        m = re.search(rf"sm90\d+{k}ILi(\d+)E", mangled)
        if m:
            return f"{k}<{m.group(1)}>"
    return None


def ptxas_report(log: str, label=None) -> dict:
    """{kernel: registers, stack frame and spill bytes, shared memory} of
    the kernels that `label` names (default: the bf16 flash kernels), from
    nvcc's -Xptxas=-v output."""
    label = label or _sm90_label
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )(\w+)", line)
        if m:
            cur = label(m.group(1))
            if cur:
                out.setdefault(cur, {})
            continue
        if cur is None:
            continue
        m = re.search(r"(\d+) bytes stack frame", line)
        if m:
            out[cur]["stack_frame"] = int(m.group(1))
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            out[cur]["spill_stores"] = int(m.group(1))
            out[cur]["spill_loads"] = int(m.group(2))
        m = re.search(r"Used (\d+) registers", line)
        if m:
            out[cur]["registers"] = int(m.group(1))
            m = re.search(r"(\d+) bytes smem", line)
            out[cur]["static_smem"] = int(m.group(1)) if m else 0
    return out


def sass_hgmma(build):
    """{kernel: HGMMA instructions} of the bf16 flash kernels in
    `cuobjdump -sass` of the built library, or None without cuobjdump."""
    import shutil
    tool = Path(build.nvcc()).with_name("cuobjdump")
    tool = str(tool) if tool.exists() else shutil.which("cuobjdump")
    if tool is None:
        return None
    sass = subprocess.run([tool, "-sass", str(build.path("flash_attention"))],
                          capture_output=True, text=True, timeout=300)
    if sass.returncode != 0:
        fail(f"cuobjdump -sass failed: {sass.stderr.strip()[:500]}")
    counts, cur = {}, None
    for line in sass.stdout.splitlines():
        m = re.search(r"Function : (\w+)", line)
        if m:
            cur = _sm90_label(m.group(1))
            if cur:
                counts[cur] = 0
            continue
        if cur and "HGMMA" in line:
            counts[cur] += 1
    return counts


def check_build(build) -> dict:
    """Phase 1's report on the bf16 flash kernels; fails if one has no
    HGMMA instruction."""
    regs = ptxas_report(build.BUILD_LOG.get("flash_attention", ""))
    hgmma = sass_hgmma(build)
    if hgmma is None:
        print("  cuobjdump not found: HGMMA instructions not counted",
              flush=True)
    names = sorted(set(regs) | set(hgmma or {}))
    if len(names) != len(FLASH_SM90) * 4:
        fail(f"phase 1: expected {len(FLASH_SM90) * 4} bf16 flash kernels "
             f"(3 kernels x 4 head dims), found {names}")
    for name in names:
        r = regs.get(name, {})
        if hgmma is not None:
            r["hgmma"] = hgmma.get(name, 0)
        print(f"  {name}: {r.get('registers')} registers, spill stores "
              f"{r.get('spill_stores')} B, loads {r.get('spill_loads')} B, "
              f"static shared memory {r.get('static_smem')} B (the tiles "
              f"are dynamic), HGMMA {r.get('hgmma', 'not counted')}",
              flush=True)
        regs[name] = r
    if hgmma is not None and any(hgmma.get(n, 0) == 0 for n in names):
        fail(f"a bf16 flash kernel has no HGMMA instruction: {hgmma}")
    return regs


def _probe_label(mangled: str):
    """`stats_kernel<bf16,row>`, `hash_shared` or `ringbuf_emit` for a
    mangled probe kernel's name, else None."""
    m = re.search(r"stats_kernelILb(\d)ELb(\d)E", mangled)
    if m:
        flags = [f for f, on in zip(("bf16", "row"), m.groups())
                 if on == "1"]
        return f"stats_kernel<{','.join(flags) or 'f32'}>"
    m = re.search(r"(hash_shared|hash_global|ringbuf_emit|table_interp)",
                  mangled)
    return m.group(1) if m else None


def probe_build_report(build, HU, TI, IC, cfg) -> dict:
    """Phase 1's report on the probe kernels: ptxas registers, stack frame,
    spills and static shared memory, and the dynamic shared memory each
    launch asks for (tensor_stats and ringbuf: none; hash: the shared route
    at the path's map and batches; the interpreter: its plan for the mixed
    check table at 49 and 4096 events). Fails if the interpreter has a
    stack frame."""
    out = {}
    for src in ("tensor_stats", "hash_update", "ringbuf_emit",
                "table_interp"):
        out.update(ptxas_report(build.BUILD_LOG.get(src, ""), _probe_label))
    rows = 2 * cfg.num_layers + 1
    key = IC.mixed_runtime()[0].live.spec_key
    plans = {e: TI.plan(key, 8, 64, e, 16) for e in (49, 4096)}
    dyn = {"stats_kernel": "0",
           "hash_shared": "; ".join(
               f"{24 * 256 + HU.batch_bytes(b)} B at n 256, B {b}"
               for b in (rows, 4096)),
           "hash_global": f"the batch table, {HU.batch_bytes(rows)} B at B "
                          f"{rows}, when it fits, else 0 (scratch)",
           "ringbuf_emit": "0",
           "table_interp": "; ".join(
               f"{pl['smem_bytes']} B at 8 x 64 rows, {e} events (maps "
               f"{pl['maps']}, tape {pl['tape']})"
               for e, pl in plans.items())}
    if len(out) != 8:
        fail(f"phase 1: expected 4 tensor_stats, 2 hash, 1 ringbuf and 1 "
             f"interpreter kernels, found {sorted(out)}")
    for name, r in sorted(out.items()):
        r["dynamic_smem"] = next(v for k, v in dyn.items() if k in name)
        print(f"  {name}: {r.get('registers')} registers, stack frame "
              f"{r.get('stack_frame')} B, spill stores "
              f"{r.get('spill_stores')} B, loads {r.get('spill_loads')} B, "
              f"static shared memory {r.get('static_smem')} B, dynamic "
              f"{r['dynamic_smem']}", flush=True)
    if out["table_interp"].get("stack_frame") != 0:
        fail(f"phase 1: the interpreter has a stack frame of "
             f"{out['table_interp'].get('stack_frame')} B")
    return out


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------

def device_ms(torch, fn, reps: int, keys):
    """(mean device ms per launch, launches) of the kernels whose name holds
    one of `keys`, over `reps` calls of fn() under torch.profiler; (None,
    0) when the profiler reports no such kernel twice."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(2):
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(reps):
                fn()
            torch.cuda.synchronize()
        us, n, seen = 0.0, 0, []
        for e in prof.key_averages():
            if _is_device(e):
                seen.append(e.key[:50])
                if any(k in e.key for k in keys):
                    us += _dev_us(e)
                    n += e.count
        if n:
            return us / n / 1e3, n
        print(f"  (the profiler reported no kernel named like {keys}; "
              f"device events: {seen[:6]})", flush=True)
    return None, 0


def queued_ms(torch, fn, reps: int) -> float:
    """Device ms per call of fn() run back to back: the stream is held by
    torch.cuda._sleep while the host enqueues `reps` calls, so the events
    around them time the device alone, the gaps between launches included.
    The sleep is lengthened until the host finishes enqueuing first."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    cycles = int((time.perf_counter() - t0) * 4e9) + 4_000_000
    for _ in range(6):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(reps):
            fn()
        b.record()
        held = not a.query()      # the device still sleeps: a queue formed
        b.synchronize()
        if held:
            return a.elapsed_time(b) / reps
        cycles *= 4
    fail("queued_ms: the host did not finish enqueuing within the sleep")


def host_us(torch, fn, reps: int) -> float:
    """The host's microseconds per call of fn(): the enqueue, no wait for
    the device (after a warm-up)."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    t = time.perf_counter() - t0
    torch.cuda.synchronize()
    return t / reps * 1e6


def timed(torch, row, fn, reps, keys, plain=None, plain_reps=1):
    """Adds to `row`: profiler_ms (the kernels' device ms per launch, None
    when the profiler reports none), launches_per_call (from the profiler),
    queued_ms (device ms per call back to back, launch gaps included), ms
    (profiler_ms, else queued_ms), host_us (per wrapper call), call_ms (CUDA
    events around back-to-back calls, which the host's rate bounds for a
    small kernel) and plain_ms."""
    pms, n = device_ms(torch, fn, reps, keys)
    qms = queued_ms(torch, fn, min(reps, 100))
    row.update(profiler_ms=pms, launches_per_call=n / reps, queued_ms=qms,
               ms=pms if pms is not None else qms,
               host_us=host_us(torch, fn, min(reps, 200)),
               call_ms=cuda_ms(torch, fn, reps))
    if plain is not None:
        row["plain_ms"] = cuda_ms(torch, plain, plain_reps,
                                  warmup=min(plain_reps, 2))
    return row


STATS_KEYS = ("stats_kernel",)


def _stats_input(torch, gen, shape, dtype, seed_bad):
    x = torch.randn(shape, generator=gen, device="cuda") * 3.0
    if seed_bad:
        flat = x.view(-1)
        idx = torch.randint(0, flat.numel(), (64,), generator=gen,
                            device="cuda")
        flat[idx[:16]] = float("nan")
        flat[idx[16:24]] = float("inf")
        flat[idx[24:32]] = float("-inf")
    return x.to(dtype)


def check_tensor_stats(torch, TS, ref, to_fx, shapes):
    """Both entries against the plain versions at each shape: stats within
    STATS_TOL, counts exact, the row's header and counts exact, its Q47.16
    lanes within the tolerance of the plain row and bit for bit `to_fx` of
    the kernel's own stats, three runs bit-identical. Timings of the row
    entry (the collector's). Returns (max abs err, rows)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    worst, rows = 0.0, []
    keys = ("mean", "rms", "min", "max", "absmax")
    exact = [0, 1, 2, 3, 4, 10, 11, 12, 13, 14, 15]
    for shape, dtype, seed_bad in shapes:
        x = _stats_input(torch, gen, shape, dtype, seed_bad)
        what = f"tensor_stats {tuple(shape)} {dtype}"
        got = TS.tensor_stats_cuda(x)
        again = TS.tensor_stats_cuda(x)
        row = TS.tensor_stats_row_cuda(x, 3, 1, 17)
        rows3 = [TS.tensor_stats_row_cuda(x, 3, 1, 17) for _ in range(2)]
        want = ref.tensor_stats(x)
        want_row = ref.tensor_stats_row(x, 3, 1, 17)
        torch.cuda.synchronize()
        for k in got:
            if not torch.equal(got[k], again[k]):
                fail(f"{what}: {k} differs between two runs")
        if not all(torch.equal(row, r) for r in rows3):
            fail(f"{what}: the row differs between three runs")
        for k in ("nan_cnt", "inf_cnt"):
            if int(got[k]) != int(want[k]):
                fail(f"{what}: {k} {int(got[k])} != {int(want[k])}")
        for k in keys:
            g, w = float(got[k]), float(want[k])
            if abs(g - w) > STATS_TOL + STATS_TOL * abs(w):
                fail(f"{what}: {k} {g} vs plain {w}")
            worst = max(worst, abs(g - w))
        if not torch.equal(row[exact], want_row[exact]):
            fail(f"{what}: row header or counts {row.tolist()} vs plain "
                 f"{want_row.tolist()}")
        if not torch.equal(row[5:10], to_fx(torch.stack([got[k]
                                                         for k in keys]))):
            fail(f"{what}: the row's Q47.16 lanes are not to_fx of the "
                 "kernel's stats")
        g, w = row[5:10].double(), want_row[5:10].double()
        if bool(((g - w).abs() > (STATS_TOL + STATS_TOL * w.abs())
                 * 65536).any()):
            fail(f"{what}: row Q47.16 lanes {row[5:10].tolist()} vs plain "
                 f"{want_row[5:10].tolist()}")
        n, nbytes = x.numel(), x.numel() * x.element_size()
        reps = 20 if n > 1 << 24 else 200
        r = timed(torch, {"shape": list(shape),
                          "dtype": str(dtype).split(".")[-1],
                          "grid": TS.grid_for(n)},
                  lambda: TS.tensor_stats_row_cuda(x, 3, 1, 17), reps,
                  STATS_KEYS,
                  plain=lambda: ref.tensor_stats_row(x, 3, 1, 17),
                  plain_reps=max(reps // 10, 5))
        r["bound_ms"], r["bound_by"] = bound_ms(nbytes + 16 * 8, 8.0 * n)
        r["gb_per_s"] = nbytes / r["ms"] / 1e6
        r["share_of_bound"] = r["bound_ms"] / r["ms"]
        rows.append(r)
        print(f"  tensor_stats row {tuple(shape)} {r['dtype']} (grid "
              f"{r['grid']}): device {r['ms'] * 1e3:.2f} us a launch "
              f"({r['launches_per_call']:.0f} a call; back to back "
              f"{r['queued_ms'] * 1e3:.2f} us a call; {r['gb_per_s']:.1f} "
              f"GB/s, {100 * r['share_of_bound']:.1f} % of the bound), host "
              f"{r['host_us']:.1f} us a call, calls back-to-back on the host "
              f"{r['call_ms'] * 1e3:.2f} us, plain {r['plain_ms']:.4f} ms, "
              f"bound {r['bound_ms'] * 1e3:.4f} us ({r['bound_by']})",
              flush=True)
    return worst, rows


def _hash_case(torch, M, n, batch, rng, *, tombstones, full):
    """A table (with tombstones, or full) and a batch of fetch-adds with
    resident and new keys, as numpy arrays."""
    import numpy as np
    st = M.init_state_np(M.MapSpec("t", M.MapKind.HASH, n))
    n_res = n if full else n // 2
    resident = rng.choice(1 << 40, size=n_res, replace=False) - (1 << 39)
    for k in resident:
        M.n_hash_update(st, int(k), int(rng.integers(-100, 100)))
    if tombstones:
        for k in resident[: n_res // 4]:
            M.n_hash_delete(st, int(k))
    new = rng.integers(-(1 << 62), 1 << 62, size=batch // 8)
    pool = np.concatenate([resident, new])
    keys = pool[rng.integers(0, pool.size, size=batch)]
    deltas = rng.integers(-(1 << 20), 1 << 20, size=batch)
    valid = rng.random(batch) < 0.9
    return st, keys, deltas, valid


HASH_KEYS = ("hash_shared", "hash_global")


def check_hash(torch, HU, ref, M, cases):
    import numpy as np
    rng = np.random.default_rng(SEED)
    rows = []
    for label, n, batch, kw in cases:
        st, keys, deltas, valid = _hash_case(torch, M, n, batch, rng, **kw)
        dev = [torch.as_tensor(a, device="cuda") for a in
               (st["keys"], st["used"], st["values"], keys, deltas, valid)]
        route = HU.plan(n, batch)[0]
        got = HU.hash_fetch_add_batch_cuda(*dev)
        want = ref.hash_fetch_add_batch(*dev)
        oracle = {f: a.copy() for f, a in st.items()}
        M.n_hash_fetch_add_batch(oracle, keys, deltas, valid)
        for f, g, w in zip(("keys", "used", "values"), got, want):
            if not torch.equal(g, w):
                fail(f"hash {label}: {f} differs from the plain version")
            if not np.array_equal(g.cpu().numpy(), oracle[f]):
                fail(f"hash {label}: {f} differs from the numpy twin")
        r = timed(torch, {"case": label, "n": n, "batch": batch,
                          "route": route},
                  lambda: HU.hash_fetch_add_batch_cuda(*dev), 50, HASH_KEYS,
                  plain=lambda: ref.hash_fetch_add_batch(*dev))
        r["bound_ms"], r["bound_by"] = bound_ms(batch * 17 + 6 * n * 8,
                                                4.0 * batch)
        rows.append(r)
        print(f"  hash {label} n={n} B={batch} ({route} route): device "
              f"{r['ms'] * 1e3:.2f} us a launch ({r['launches_per_call']:.0f}"
              f" a call; back to back {r['queued_ms'] * 1e3:.2f} us a call), "
              f"host {r['host_us']:.1f} us a call, calls back-to-back on the "
              f"host {r['call_ms'] * 1e3:.2f} us, plain {r['plain_ms']:.3f} "
              "ms, "
              f"bound {r['bound_ms'] * 1e3:.4f} us ({r['bound_by']}), "
              "bit-identical", flush=True)
    return rows


def check_ringbuf(torch, RB, ref, cases):
    import numpy as np
    rng = np.random.default_rng(SEED + 1)
    rows = []
    for label, cap, batch, width in cases:
        data = rng.integers(-9, 9, size=(cap, width))
        head = np.array([int(rng.integers(0, 3 * cap))])
        dropped = np.array([int(rng.integers(0, 100))])
        recs = rng.integers(-(1 << 40), 1 << 40, size=(batch, width))
        valid = rng.random(batch) < 0.7
        dev = [torch.as_tensor(a, device="cuda")
               for a in (data, head, dropped, recs, valid)]
        got = RB.ringbuf_emit_batch_cuda(*dev)
        want = ref.ringbuf_emit_batch(*dev)
        for f, g, w in zip(("data", "head", "dropped"), got, want):
            if not torch.equal(g, w):
                fail(f"ringbuf {label}: {f} differs from the plain version")
        r = timed(torch, {"case": label, "cap": cap, "batch": batch},
                  lambda: RB.ringbuf_emit_batch_cuda(*dev), 50,
                  ("ringbuf_emit",),
                  plain=lambda: ref.ringbuf_emit_batch(*dev))
        r["bound_ms"], r["bound_by"] = bound_ms(
            batch + batch * width * 8 + 2 * cap * width * 8 + 32,
            2.0 * batch)
        r["laps"] = int(got[2][0] - dropped[0])
        rows.append(r)
        print(f"  ringbuf {label} cap={cap} B={batch} W={width}: device "
              f"{r['ms'] * 1e3:.2f} us a launch (back to back "
              f"{r['queued_ms'] * 1e3:.2f} us a call), host "
              f"{r['host_us']:.1f} us a call, calls back-to-back on the host "
              f"{r['call_ms'] * 1e3:.2f} us, plain "
              f"{r['plain_ms']:.3f} ms, bound {r['bound_ms'] * 1e3:.4f} us "
              f"({r['bound_by']}), {r['laps']} laps, bit-identical",
              flush=True)
    return rows


def ringbuf_apply_ops(torch, RB, L2):
    """PyTorch operators and kernel launches of one RINGBUF apply of the
    fused lane (`vectorized._apply_site`) at the path's shape: the
    redesigned apply is one launch of its kernel, and every operator it
    dispatches only allocates (no device work). Counted deterministically
    (a dispatch mode and the wrapper's counter): a profiler window loses
    its first records now and then, and this one holds one kernel."""
    from types import SimpleNamespace
    from torch.utils._python_dispatch import TorchDispatchMode
    from repro_torch.core import jit as J, maps as M, vectorized as V

    class Ops(TorchDispatchMode):
        def __init__(self):
            super().__init__()
            self.names = []

        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            self.names.append(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))
    spec = M.MapSpec("rb", M.MapKind.RINGBUF, 64, rec_width=4)
    st = {"rb": M.init_state(spec, "cuda")}
    rec = (torch.ones(L2, dtype=torch.bool, device="cuda"),
           torch.arange(L2 * 4, device="cuda").reshape(L2, 4))
    vp = SimpleNamespace(map_specs=[spec])
    aux = J.make_aux(device="cuda")
    torch.cuda.synchronize()
    before = RB.LAUNCHES
    with Ops() as mode:
        V._apply_site(vp, "ringbuf_output", (0,), rec, st, aux)
    torch.cuda.synchronize()
    launches = RB.LAUNCHES - before
    work = [n for n in mode.names if not n.startswith("empty")]
    print(f"  ringbuf apply at B {L2}: {launches} kernel launch, operators "
          f"{mode.names} (device work: {work or 'none'})", flush=True)
    if launches != 1 or work:
        fail(f"the ringbuf apply must be one kernel launch and nothing "
             f"else: {launches} launches, operators {mode.names}")
    return launches + len(work)


def _interp_bytes(case) -> int:
    """Bytes the interpreter must move for one case: the table and the
    tape read once, every map state and the aux block read and written."""
    _, table, rows, maps, aux = case
    st = sum(t.numel() for m in maps.values() for t in m.values())
    ax = sum(t.numel() for t in aux.values())
    return 8 * (table["packed"].numel() + rows.numel() + 2 * (st + ax))


def check_interp(torch, ops, IC, corpus):
    """The interpreter kernel against its plain version (on CPU copies of
    the same inputs) on the mixed table at 49, 600 and 4096 events, the
    branching-HASH table on the shared and the global route at 49 and 1029,
    the ISA-traps program at 49 and 4096 and every corpus program on each
    sub-lane that may take it: maps, aux and r0 bit for bit. Times the
    mixed table at 49 and 4096: device us per launch (CUDA events), host
    us per call, the per-phase split of one launch from its clock64()
    stamps, and the instructions the plain version executed; the plain
    version's ms is host time on the CPU (it steps its loops from the
    host)."""
    from repro_torch.core import table_interp as CT
    from repro_torch.kernels import table_interp as TI
    cases = [(f"mixed {n}", IC.mixed_case(n, SEED + n, "cuda"), False)
             for n in (49, 600, 4096)]
    cases += [(f"branch {'global' if big else 'shared'} {n}",
               IC.branch_case(n, SEED + n, "cuda", big), False)
              for big in (False, True) for n in (49, 1029)]
    cases += [(f"isa traps {n}", IC.traps_case(n, SEED + n, "cuda"), True)
              for n in (49, 4096)]
    for name, d in corpus:
        for n in (49, 4096):
            for vec in (False, True):
                c = IC.corpus_case(d["text"], d["tape"], n, SEED, vec,
                                   "cuda")
                if c is not None:
                    cases.append((f"{name} {'vec' if vec else 'seq'} {n}",
                                  c, True))
    khz = TI.clock_khz()
    rows, routes = [], {}
    for label, case, match_all in cases:
        P, N = case[1]["hcls"].shape
        E, cw = case[2].shape
        pl = TI.plan(case[0], P, N, E, cw)
        routes[label] = f"maps {pl['maps']}, tape {pl['tape']}"
        got = ops.table_interp_run(*case, match_all=match_all, want_r0=True)
        torch.cuda.synchronize()
        cpu = IC.to_cpu(case)
        counts = dict(CT.COUNTS)
        t0 = time.perf_counter()
        want = ops.table_interp_run(*cpu, match_all=match_all, want_r0=True)
        plain_ms = (time.perf_counter() - t0) * 1e3
        executed = {k: CT.COUNTS[k] - v for k, v in counts.items()}
        bad = IC.compare(IC.to_cpu(got), want)
        if bad:
            fail(f"interpreter {label}: {bad} differ from the plain version")
        if label not in ("mixed 49", "mixed 4096"):
            continue
        if pl["maps"] != "shared":
            fail(f"interpreter {label}: the mixed table took the "
                 f"{pl['maps']} route")
        # CUDA events around back-to-back calls: the launches are long
        # (tens of us and more), so the gaps between them do not count
        reps = 20 if E < 1000 else 5

        def fn():
            return ops.table_interp_run(*case)
        base = ops.launch_counts()["table_interp"]
        r = {"case": label, "events": E, "ms": cuda_ms(torch, fn, reps),
             "host_us": host_us(torch, fn, reps)}
        r["launches_per_call"] = (ops.launch_counts()["table_interp"]
                                  - base) / (2 + reps + 1 + reps)
        r["plain_ms"] = plain_ms
        r["plain_on"] = "host CPU"
        r["bound_ms"], r["bound_by"] = bound_ms(_interp_bytes(case), 0.0)
        fn()
        torch.cuda.synchronize()
        vec = [p for p in range(P) if case[1]["active"][p]
               and case[1]["vec"][p]]
        r["phases_us"] = TI.phase_split(TI.LAST_STAMPS.cpu(), khz, vec)
        r["clock_khz"] = khz
        r["plan"] = routes[label]
        r["executed"] = executed
        r["seq_ns_per_insn"] = r["phases_us"]["seq"] * 1e3 / max(
            executed["seq_insns"], 1)
        rows.append(r)
        ph = r["phases_us"]
        print(f"  interpreter {label} events ({r['plan']}): device "
              f"{r['ms'] * 1e3:.2f} us a call back to back (CUDA events; "
              f"{r['launches_per_call']:.0f} launch a call), host "
              f"{r['host_us']:.1f} us a call, plain {plain_ms:.1f} ms on "
              f"the host CPU, bound {r['bound_ms'] * 1e3:.4f} us "
              f"({r['bound_by']}), bit-identical", flush=True)
        print(f"    one launch by its stamps at {khz} kHz: copy-in "
              f"{ph['copy_in']:.2f} us, sequential {ph['seq']:.2f} us "
              f"({executed['seq_insns']} instructions, "
              f"{r['seq_ns_per_insn']:.1f} ns each), vec {ph['vec']:.2f} "
              f"us ({executed['vec_lane_insns']} lane instructions in "
              f"{executed['vec_machine_steps']} machine steps; per slot "
              + ", ".join(f"{p}: {v:.2f}"
                          for p, v in ph["per_vec_slot"].items())
              + f"), of which HASH apply {ph['hash_apply']:.2f} us in "
              f"{ph['hash_rounds']} rounds, copy-out {ph['copy_out']:.2f} "
              f"us; total {ph['total']:.2f} us", flush=True)
    print(f"  interpreter: {len(cases)} cases bit-identical to the plain "
          f"version ({'; '.join(f'{k}: {v}' for k, v in routes.items())})",
          flush=True)
    if not any("global" in v for v in routes.values()):
        fail("interpreter: no case took the global route")
    return rows


def _flash_inputs(torch, BH, BKH, S, hd, dtype, seed):
    gen = torch.Generator(device="cuda")
    gen.manual_seed(seed)
    return [torch.randn(n, S, hd, generator=gen, device="cuda").to(dtype)
            for n in (BH, BKH, BKH, BH)]


def _close(torch, got, want, rtol, atol, what, norm_tol=None):
    """Max abs difference; fails beyond atol + rtol * |want| anywhere, or,
    given norm_tol, beyond it in |got - want| / |want| (2-norms)."""
    g, w = got.float(), want.float()
    err = float((g - w).abs().max())
    if not bool(((g - w).abs() <= atol + rtol * w.abs()).all()):
        fail(f"{what}: max abs difference {err:.3e} beyond tolerance")
    if norm_tol is not None:
        rel = float((g - w).norm() / w.norm().clamp_min(1e-30))
        if not rel <= norm_tol:
            fail(f"{what}: relative norm difference {rel:.3e} beyond "
                 f"{norm_tol}")
    return err


def check_flash(torch, FA, ref):
    """Flash attention forward and backward against the plain versions:
    f32 at test_flash_kernel.py's shapes, and bf16 at the training path's
    shape (B 2, S 4096, 14 q heads over 2 kv heads, hd 64, causal), where
    both are timed beside scaled_dot_product_attention. Returns
    (max abs err at the path's shape, fwd row, bwd row)."""
    import torch.nn.functional as F
    tf, tb = FA.TOL_F32
    for B, S, H, KH, hd in ((1, 128, 2, 2, 32), (2, 256, 4, 2, 16),
                            (1, 128, 8, 2, 64)):
        for causal in (True, False):
            q, k, v, do = _flash_inputs(torch, B * H, B * KH, S, hd,
                                        torch.float32, S + H + causal)
            o, lse = FA.flash_fwd_cuda(q, k, v, causal)
            wo, wl = ref.flash_fwd(q, k, v, causal, H // KH)
            _close(torch, o, wo, tf, tf, f"flash_fwd f32 {B, S, H, KH, hd}")
            _close(torch, lse, wl, tf, tf, f"flash lse f32 {B, S, H, KH}")
            got = FA.flash_bwd_cuda(q, k, v, o, lse, do, causal)
            want = ref.flash_bwd(q, k, v, o, lse, do, causal, H // KH)
            for name, g, w in zip(("dq", "dk", "dv"), got, want):
                _close(torch, g, w, tb, tb,
                       f"flash_bwd {name} f32 {B, S, H, KH, hd} {causal}")
    print("  flash f32 (test_flash_kernel shapes, causal and not): forward "
          f"within {tf}, gradients within {tb}", flush=True)

    B, S, H, KH, hd = 2, 4096, 14, 2, 64
    BH, BKH = B * H, B * KH
    q, k, v, do = _flash_inputs(torch, BH, BKH, S, hd, torch.bfloat16, 7)
    o, lse = FA.flash_fwd_cuda(q, k, v, True)
    wo, wl = ref.flash_fwd(q, k, v, True, H // KH)
    err = _close(torch, o, wo, *FA.TOL_BF16_O, "flash_fwd bf16 path shape")
    lse_err = _close(torch, lse, wl, *FA.TOL_LSE,
                     "flash lse bf16 path shape")
    got = FA.flash_bwd_cuda(q, k, v, o, lse, do, True)
    again = FA.flash_bwd_cuda(q, k, v, o, lse, do, True)
    want = ref.flash_bwd(q, k, v, o, lse, do, True, H // KH)
    torch.cuda.synchronize()
    gerr, rtol, atol = 0.0, *FA.TOL_BF16_GRAD
    for name, g, a, w in zip(("dq", "dk", "dv"), got, again, want):
        if not torch.equal(g, a):
            fail(f"flash_bwd {name}: two runs are not bit-identical")
        scale = max(1.0, float(w.float().abs().max()))
        gerr = max(gerr, _close(torch, g, w, rtol, atol * scale,
                                f"flash_bwd {name} bf16 path shape",
                                FA.TOL_BF16_NORM))
    # the yardstick: one library call on the same inputs ([B, H, S, hd])
    q4, k4, v4, do4 = (t.view(B, -1, S, hd) for t in (q, k, v, do))
    sd = F.scaled_dot_product_attention(q4, k4, v4, is_causal=True,
                                        enable_gqa=True)
    sdpa_err = float((sd.float().reshape(BH, S, hd) - o.float()).abs().max())
    qg, kg, vg = (t.detach().clone().requires_grad_(True)
                  for t in (q4, k4, v4))

    def sdpa_fwd_bwd():
        out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                             enable_gqa=True)
        torch.autograd.grad(out, (qg, kg, vg), do4)

    # SDPA's backward alone, on the graph of one forward: the same work as
    # flash_bwd
    sd_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=True,
                                            enable_gqa=True)

    fwd_ms = cuda_ms(torch, lambda: FA.flash_fwd_cuda(q, k, v, True), 10)
    fwd_plain = cuda_ms(torch, lambda: ref.flash_fwd(q, k, v, True, H // KH),
                        3, warmup=1)
    fwd_lib = cuda_ms(torch, lambda: F.scaled_dot_product_attention(
        q4, k4, v4, is_causal=True, enable_gqa=True), 20)
    bwd_ms = cuda_ms(torch, lambda: FA.flash_bwd_cuda(q, k, v, o, lse, do,
                                                      True), 5)
    bwd_plain = cuda_ms(torch, lambda: ref.flash_bwd(q, k, v, o, lse, do,
                                                     True, H // KH),
                        3, warmup=1)
    fb_lib = cuda_ms(torch, sdpa_fwd_bwd, 10)
    bwd_lib = cuda_ms(torch, lambda: torch.autograd.grad(
        sd_out, (qg, kg, vg), do4, retain_graph=True), 10)
    del sd_out
    pairs = S * (S + 1) // 2                       # causal (q, k) pairs
    io = 2 * (2 * BH + 2 * BKH) * S * hd           # q, o and k, v in bf16
    fb, fby = bound_ms(io + 4 * BH * S, 4.0 * hd * pairs * BH,
                       BF16_OPS_PER_S)
    # backward: reads q, k, v, o, do and lse, writes dq, dk, dv; the least
    # work is five products (q k^T recomputed, do v^T, p^T do, ds^T q, ds k)
    bb, bby = bound_ms(io + 2 * BH * S * hd + 4 * BH * S
                       + 2 * (BH + 2 * BKH) * S * hd,
                       10.0 * hd * pairs * BH, BF16_OPS_PER_S)
    fwd_row = {"shape": [B, S, H, KH, hd], "dtype": "bfloat16",
               "ms": fwd_ms, "plain_ms": fwd_plain, "bound_ms": fb,
               "bound_by": fby, "library_ms": fwd_lib,
               "library_is": "sdpa forward",
               "tflops": 4.0 * hd * pairs * BH / fwd_ms / 1e9,
               "share_of_bound": fb / fwd_ms,
               "max_abs_err": err, "lse_max_abs_err": lse_err,
               "max_abs_diff_vs_sdpa": sdpa_err}
    bwd_row = {"shape": [B, S, H, KH, hd], "dtype": "bfloat16",
               "ms": bwd_ms, "plain_ms": bwd_plain, "bound_ms": bb,
               "bound_by": bby, "library_ms": bwd_lib,
               "library_is": "sdpa backward",
               "sdpa_fwd_bwd_ms": fb_lib,
               "tflops": 14.0 * hd * pairs * BH / bwd_ms / 1e9,
               "share_of_bound": bb / bwd_ms,
               "max_abs_err": gerr}
    print(f"  flash_fwd {B, S, H, KH, hd} bf16: kernel {fwd_ms:.3f} ms "
          f"({fwd_row['tflops']:.1f} TFLOP/s, {100 * fb / fwd_ms:.1f} % of "
          f"the bound), plain {fwd_plain:.3f} ms, sdpa {fwd_lib:.3f} ms, "
          f"bound {fb:.4f} ms ({fby}); max abs err {err:.2e} (lse "
          f"{lse_err:.2e}), vs sdpa {sdpa_err:.2e}", flush=True)
    print(f"  flash_bwd {B, S, H, KH, hd} bf16: kernel {bwd_ms:.3f} ms "
          f"({bwd_row['tflops']:.1f} TFLOP/s of the 7 products, "
          f"{100 * bb / bwd_ms:.1f} % of the bound), plain {bwd_plain:.3f} "
          f"ms, sdpa backward {bwd_lib:.3f} ms (fwd+bwd {fb_lib:.3f} ms), "
          f"bound {bb:.4f} ms ({bby}); max abs err {gerr:.2e}; two runs "
          "bit-identical", flush=True)
    return max(err, gerr), fwd_row, bwd_row


# --------------------------------------------------------------------------
# phase 3: serving
# --------------------------------------------------------------------------

def serve(torch, cfg, device, params=None, *, requests=8, slots=4,
          max_seq=128, max_new=8, admit_limit=12, probes=True,
          shm_dir=None, worker_id=None):
    """An engine and its requests. probes=False attaches no device probe;
    the admission filter (a host-side syscall program) stays, so the same
    requests are served. shm_dir joins the shm plane as `worker_id`."""
    from repro_torch.core.runtime import BpftimeRuntime
    from repro_torch.launch import serve as L
    from repro_torch.models import registry as MR
    from repro_torch.serve.engine import ServeEngine

    rt = BpftimeRuntime()
    pid = rt.load_asm("admit", L.admit_filter_text(admit_limit), [],
                      "filter")
    rt.attach(pid, "filter:sys_serve_admit")
    if probes:
        L.attach_serve_probes(rt)
    if params is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(SEED)
        params = MR.init_params(cfg, gen, device)
    engine = ServeEngine(params, cfg, slots=slots, max_seq=max_seq,
                         runtime=rt, shm_dir=shm_dir, worker_id=worker_id,
                         device=device)
    reqs = L.make_requests(requests, max_new, cfg.vocab_size, SEED)
    return engine, reqs


def to_cpu(tree):
    if isinstance(tree, dict):
        return {k: to_cpu(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [to_cpu(v) for v in tree]
    return tree.cpu()


def maps_summary(maps, num_layers):
    from repro_torch.core.maps import n_hash_items
    st = {n: {f: a.cpu().numpy() for f, a in m.items()}
          for n, m in maps.items()}
    counts = st["sv_layer_counts"]["values"]
    hist = st["sv_rms_hist"]["bins"]
    rb = st["sv_logits_rb"]
    return {
        "layer_counts": counts[:num_layers].tolist(),
        "hash_items": len(n_hash_items(st["sv_key_hash"])),
        "hash_total": int(sum(n_hash_items(st["sv_key_hash"]).values())),
        "rms_hist_nonzero_bins": {int(i): int(hist[i])
                                  for i in hist.nonzero()[0]},
        "ringbuf_head": int(rb["head"][0]),
        "ringbuf_dropped": int(rb["dropped"][0]),
    }


def _dev_us(e) -> float:
    for attr in ("self_device_time_total", "self_cuda_time_total"):
        if hasattr(e, attr):
            return float(getattr(e, attr))
    return 0.0


def _is_device(e) -> bool:
    return _dev_us(e) > 0 and e.device_type is not None and \
        "cuda" in str(e.device_type).lower()


PROBE_GROUPS = {"probe kernels": ("stats_", "hash_", "ringbuf_emit"),
                "matmul": ("gemm", "cutlass", "sm90", "cublas", "nvjet")}
EMIT_RANGE = "chip_smoke.emit_tensor_event"


@contextlib.contextmanager
def emit_ranges(torch):
    """Every Collector.emit_tensor_event inside a profiler range, so the
    device operations it launches can be counted."""
    from repro_torch.core import events as E
    orig = E.Collector.emit_tensor_event

    def ranged(self, *args, **kwargs):
        with torch.profiler.record_function(EMIT_RANGE):
            return orig(self, *args, **kwargs)
    E.Collector.emit_tensor_event = ranged
    try:
        yield
    finally:
        E.Collector.emit_tensor_event = orig


def collector_ops(prof) -> dict:
    """Device operations (kernels, copies, fills) the collector launched in
    a profiled window, per event: the tensor_stats kernels (named
    stats_...; only the collector launches them on these paths) counted by
    name, plus every other device operation that the profiler links to a
    PyTorch operator inside an emit range."""
    events = prof.events()
    # each range also appears as a GPU-side annotation of the same name
    emits = [e for e in events if e.name == EMIT_RANGE
             and str(e.device_type).endswith("CPU")]
    other = []

    def walk(e):
        other.extend(k.name for k in e.kernels if "stats_" not in k.name)
        for c in e.cpu_children:
            walk(c)
    for e in emits:
        walk(e)
    stats = sum(e.count for e in prof.key_averages()
                if _is_device(e) and "stats_" in e.key)
    n = max(len(emits), 1)
    names = {}
    for k in other:
        names[k[:60]] = names.get(k[:60], 0) + 1
    return {"events": len(emits), "stats_kernels": stats,
            "other_device_ops": len(other),
            "device_ops_per_event": (stats + len(other)) / n,
            "other_by_name": names}


def _profile_once(torch, fn):
    """(profile, wall s, tensor_stats launches by the wrappers' counter) of
    one fn() under torch.profiler, every collector event in a range."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.kernels import ops
    before = ops.launch_counts()["tensor_stats"]
    with emit_ranges(torch), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        # throwaway kernels first: the first records of a window can be
        # lost while the profiler starts, and a training step's first
        # tensor_stats kernel is its sixth device operation
        warm = torch.empty(1, device="cuda")
        for _ in range(64):
            warm.fill_(0)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    return prof, pwall, ops.launch_counts()["tensor_stats"] - before


def profiled(torch, fn, groups, detail):
    """fn() under torch.profiler, every collector event in a range: (wall
    s, device us by group, per-kernel device ms and count of the group
    `detail`, the collector's device operations). Prints the ten kernels
    with the most device time. fn must be repeatable: a window whose
    profile lacks some of the tensor_stats kernels the counter saw
    launched, and holds nothing else that is off, lost activity records,
    and is profiled once more; the check below holds that second window
    as it holds the first."""
    prof, pwall, launched = _profile_once(torch, fn)
    col = collector_ops(prof)
    if col["events"] == launched and col["stats_kernels"] < launched and \
            not col["other_device_ops"]:
        print(f"  the profile holds {col['stats_kernels']} tensor_stats "
              f"kernels of {launched} launched (records lost); profiling "
              "once more", flush=True)
        prof, pwall, launched = _profile_once(torch, fn)
        col = collector_ops(prof)
    by_group = {g: 0.0 for g in list(groups) + ["other"]}
    top, per = [], {}
    for e in prof.key_averages():
        # an emit range's GPU-side annotation spans kernels counted already
        if not _is_device(e) or e.key == EMIT_RANGE:
            continue
        us = _dev_us(e)
        g = next((g for g, keys in groups.items()
                  if any(k in e.key.lower() for k in keys)), "other")
        by_group[g] += us
        top.append((us, e.count, e.key[:70]))
        if g == detail:
            m = re.search(r"::(\w+(?:<[^>]*>)?)\(", e.key) or \
                re.search(r"(\w+(?:<[^>]*>)?)\(", e.key)
            p = per.setdefault(m.group(1) if m else e.key[:40],
                               {"device_ms": 0.0, "count": 0})
            p["device_ms"] += us / 1e3
            p["count"] += e.count
    busy = sum(by_group.values())
    print(f"  profiled: wall {pwall * 1e3:.1f} ms, device busy "
          f"{busy / 1e3:.1f} ms = {busy / 1e4 / pwall:.1f} % of wall; by "
          "group (ms): " + json.dumps({g: round(v / 1e3, 3)
                                       for g, v in by_group.items()}),
          flush=True)
    for us, n, key in sorted(top, reverse=True)[:10]:
        print(f"    {us / 1e3:8.3f} ms {n:6d}x  {key}")
    for p in per.values():
        p["us_per_launch"] = p["device_ms"] * 1e3 / max(p["count"], 1)
    print(f"  {detail} on the device: {json.dumps(per)}", flush=True)
    ops = col
    print(f"  collector: {ops['events']} events, {ops['stats_kernels']} "
          f"tensor_stats kernels ({launched} launches by the counter) and "
          f"{ops['other_device_ops']} other device operations = "
          f"{ops['device_ops_per_event']:.2f} device operations per event; "
          f"others by name {json.dumps(ops['other_by_name'])}", flush=True)
    if not ops["events"] or ops["other_device_ops"] or \
            ops["stats_kernels"] != ops["events"] or launched != ops["events"]:
        fail("the collector must make exactly one tensor_stats launch and "
             f"no other device operation per event: {ops}, {launched} "
             "launches by the counter")
    return pwall, by_group, per, ops


def warm_serve(torch, cfg, params, probes):
    """One warm serving pass on the host clock: (tokens, steps, wall s)."""
    engine, reqs = serve(torch, cfg, "cuda", params, probes=probes)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.submit_all(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return sum(len(r.out) for r in reqs if not r.rejected), \
        engine.step_count, wall


def timing(torch, cfg, params):
    """After one untimed pass, warm serving passes with the probes and with
    no device probe, in turns (host clock), then a profiled one: device
    busy share, device time by kernel group, device operations per
    collected event. Kernel launches here are not counted toward phase
    3."""
    warm_serve(torch, cfg, params, True)
    runs = {"probed": [], "unprobed": []}
    for probes in (True, False, False, True):
        runs["probed" if probes else "unprobed"].append(
            warm_serve(torch, cfg, params, probes))
    out = {}
    for label, rs in runs.items():
        tokens, steps = rs[0][0], rs[0][1]
        ms = [w / st * 1e3 for _, st, w in rs]
        out[label] = {"tokens": tokens, "steps": steps,
                      "ms_per_step": ms,
                      "tokens_per_s": [t / w for t, _, w in rs]}
        print(f"  warm {label}: {tokens} tokens, {steps} decode steps; "
              f"{', '.join(f'{m:.2f}' for m in ms)} ms per step (prefill "
              "included)", flush=True)
    from repro_torch.launch import serve as L
    engine, _ = serve(torch, cfg, "cuda", params)
    torch.cuda.synchronize()
    pwall, by_group, probe, ops = profiled(
        torch, lambda: engine.submit_all(L.make_requests(
            8, 8, cfg.vocab_size, SEED)), PROBE_GROUPS, "probe kernels")
    busy = sum(by_group.values())
    return {"warm_tokens_per_s": out["probed"]["tokens_per_s"][0],
            "warm_ms_per_step": out["probed"]["ms_per_step"][0],
            "warm": out,
            "profiled_wall_ms": pwall * 1e3, "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / 1e6 / pwall,
            "device_ms_by_group": {g: v / 1e3 for g, v in by_group.items()},
            "probe_kernels_device": probe, "collector_ops": ops}



# --------------------------------------------------------------------------
# phase 6: the live lane while serving
# --------------------------------------------------------------------------

def _live_runtime(lane):
    """The serving runtime of phase 3 (admission filter, the four serving
    probes on the fused lane) with LIVE_PROBES loaded: lane "table" also
    enables the live lane, armed on LIVE_ARM (before any engine is built);
    "fused" attaches the first three LIVE_PROBES on the fused lane; None
    attaches none of them."""
    from repro_torch.core.runtime import BpftimeRuntime
    from repro_torch.launch import serve as L
    rt = BpftimeRuntime()
    pid = rt.load_asm("admit", L.admit_filter_text(12), [], "filter")
    rt.attach(pid, "filter:sys_serve_admit")
    L.attach_serve_probes(rt)
    pids = L.load_live_probes(rt)
    if lane == "table":
        rt.enable_live_attach(arm=L.LIVE_ARM)
    elif lane == "fused":
        for name, _, _, target in L.LIVE_PROBES[:3]:
            rt.attach(pids[name], target, mode="fused")
    return rt, pids


def _attach_live_three(rt, pids, maps):
    """The first three LIVE_PROBES on the table lane, pushed to `maps`."""
    from repro_torch.launch import serve as L
    links = [rt.attach(pids[name], target, mode="table", promote=False)
             for name, _, _, target in L.LIVE_PROBES[:3]]
    return links, rt.sync_live_table(maps)


def _same_maps(a, b) -> list:
    from repro_torch.core.runtime import to_numpy
    a, b = to_numpy(a), to_numpy(b)
    return [f"{m}.{f}" for m in b for f in b[m]
            if not (a[m][f] == b[m][f]).all()]


def live_serve(torch, ops, cfg, params):
    """qwen2-0.5b served at full width while programs are hot-attached to
    the running decode step through the live table, detached, and one
    promoted to the fused lane; every probed step replayed through a
    runtime that has the same programs on the fused lane."""
    from repro_torch.launch import serve as L
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.steps import make_decode_step
    rt, pids = _live_runtime("table")
    engine = ServeEngine(params, cfg, slots=4, max_seq=128, runtime=rt,
                         device="cuda")
    decode = engine._decode
    steps, part, mark = [], [1], {}
    stage = rt.probe_stage

    def recording(rows, maps, aux, mode=None):
        out = stage(rows, maps, aux, mode=mode)
        steps.append((part[0], rows, {k: v for k, v in maps.items()
                                      if k != "__live_table__"}, aux,
                      out[0], rt.table_generation))
        if "attach" in mark and "first_run" not in mark:
            torch.cuda.synchronize()
            mark["first_run"] = time.perf_counter()
        return out
    rt.probe_stage = recording
    prefill = engine._prefill_slot
    mark["prefill_s"] = 0.0

    def timed_prefill(slot, req):
        # the prefills between the attach and the first probe stage that
        # runs the programs are not part of the attach latency
        t0 = time.perf_counter()
        prefill(slot, req)
        if "attach" in mark and "first_run" not in mark:
            torch.cuda.synchronize()
            mark["prefill_s"] += time.perf_counter() - t0
    engine._prefill_slot = timed_prefill
    reqs_a = L.make_requests(8, 8, cfg.vocab_size, SEED)
    reqs_b = L.make_requests(8, 8, cfg.vocab_size, SEED + 1)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    engine.submit_all(reqs_a[:4])                 # part 1: nothing live
    part[0] = 2
    mark["attach"] = time.perf_counter()
    links, engine.maps = _attach_live_three(rt, pids, engine.maps)
    attach_ms = (time.perf_counter() - mark["attach"]) * 1e3
    lanes = [lk.lane for lk in links]
    vec = rt.live.host["vec"][:3].tolist()
    engine.submit_all(reqs_a[4:])                 # part 2: three on the table
    part[0] = 3
    rt.detach(links[2])
    lk_hash = rt.attach(pids["lv_hash"], "uprobe:block", mode="table",
                        promote=True)
    engine.maps = rt.sync_live_table(engine.maps)
    engine.submit_all(reqs_b[:4])                 # part 3: hash on the table
    rt.enable_promotion(lambda: make_decode_step(cfg, rt), (),
                        background=False)
    state_ready = lk_hash.promotion_state
    engine.maps = rt.sync_live_table(engine.maps)
    part[0] = 4
    engine.submit_all(reqs_b[4:])                 # part 4: hash fused
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    # the wrappers are instance attributes that close over their owners:
    # drop them, so the engine (and the weights it shares) can be freed
    del rt.probe_stage, engine._prefill_slot
    probed = {k: sum(1 for s in steps if s[0] == k) for k in (1, 2, 3, 4)}
    to_run_ms = (mark["first_run"] - mark["attach"]) * 1e3
    prefill_ms = mark["prefill_s"] * 1e3
    print(f"  served {engine.step_count} decode steps ({probed} probed "
          f"per part); attach + sync of three programs {attach_ms:.3f} ms "
          f"of host, attach to the end of the first probe stage that ran "
          f"them {to_run_ms:.2f} ms, of which the new requests' prefills "
          f"{prefill_ms:.2f} ms: {to_run_ms - prefill_ms:.2f} ms without "
          f"them; kernels {json.dumps(launches)}", flush=True)
    if engine._decode is not decode:
        fail("live lane: the engine's decode step was rebuilt")
    if lanes != ["table"] * 3:
        fail(f"live lane: the three programs took lanes {lanes}")
    if vec != [1, 0, 1]:
        fail(f"live lane: vec flags {vec}, expected a vec, a sequential "
             "and a vec slot")
    if state_ready != "ready" or lk_hash.lane != "fused" or \
            lk_hash.promotion_state != "fused":
        fail(f"live lane: promotion ended {state_ready} -> "
             f"{lk_hash.lane}/{lk_hash.promotion_state}")
    if launches["table_interp"] != len(steps) or not all(probed.values()):
        fail(f"live lane: {launches['table_interp']} interpreter launches "
             f"for {len(steps)} probed steps ({probed})")
    if any(launches[k] == 0 for k in ("tensor_stats", "hash_fetch_add_batch",
                                      "ringbuf_emit_batch")):
        fail(f"live lane: a serving kernel was not launched: {launches}")
    # every probed step again, through a runtime with the same programs on
    # the fused lane from the same boundaries
    rf, fp = _live_runtime(None)
    changes = {2: [("attach", "lv_count"), ("attach", "lv_rb"),
                   ("attach", "lv_hist")],
               3: [("detach", "lv_hist"), ("attach", "lv_hash")]}
    flinks, cur = {}, 1
    for k, rows, maps_in, aux, out, _ in steps:
        while cur < k:
            cur += 1
            for op, name in changes.get(cur, []):
                if op == "attach":
                    tgt = next(t for n, _, _, t in L.LIVE_PROBES if n == name)
                    flinks[name] = rf.attach(fp[name], tgt, mode="fused")
                else:
                    rf.detach(flinks.pop(name))
        want, _ = rf.probe_stage(rows, maps_in, aux)
        bad = _same_maps(out, want)
        if bad:
            fail(f"live lane: part {k}: {bad} differ from the fused-lane "
                 "replay")
    # and through the table lane, each with the table of the generation it
    # ran: a sync writes the running step's table buffer in place, so the
    # state a step started from holds the newest table by now
    rr, rp = _live_runtime("table")
    if rr.live.spec_key != rt.live.spec_key:
        fail("live lane: the replay runtime's map universe differs")
    hash_target = next(t for n, _, _, t in L.LIVE_PROBES if n == "lv_hash")
    promoted = False
    for k, rows, maps_in, aux, out, gen in steps:
        if k == 4 and not promoted:
            rr.attach(rp["lv_hash"], hash_target, mode="fused")
            promoted = True
        want, _ = rr.probe_stage(rows, {**maps_in, "__live_table__":
                                        rt.live_table_at(gen, "cuda")}, aux)
        bad = _same_maps(out, want)
        if bad:
            fail(f"live lane: part {k}: {bad} differ from the table-lane "
                 f"replay of generation {gen}")
    gens = sorted({s[5] for s in steps})
    print(f"  {len(steps)} probed steps bit-identical to a table-lane replay "
          f"from the generation each ran (generations {gens})", flush=True)
    side = side_stream_step(torch, ops, engine, decode)
    final = {m: {f: int(t.sum()) for f, t in st.items()}
             for m, st in engine.maps.items()
             if m.startswith("lv_") and m != "lv_logits_rb"}
    head = int(engine.maps["lv_logits_rb"]["head"][0])
    if head != probed[2] + probed[3] + probed[4]:
        fail(f"live lane: {head} logits records for "
             f"{probed[2] + probed[3] + probed[4]} steps")
    if final["lv_key_hash"]["values"] != \
            (probed[3] + probed[4]) * cfg.num_layers:
        fail(f"live lane: the promoted HASH counter holds "
             f"{final['lv_key_hash']['values']}")
    print(f"  {len(steps)} probed steps bit-identical to the fused-lane "
          f"replay; engine unchanged; promotion ready -> fused at one "
          f"sync; map sums {json.dumps(final)}, {head} logits records",
          flush=True)
    return {"decode_steps": engine.step_count, "probed_steps": probed,
            "attach_sync_ms": attach_ms,
            "attach_to_first_run_ms": to_run_ms,
            "prefills_in_between_ms": prefill_ms,
            "launches": launches, "table_generations": gens,
            "side_stream": side, "steps": steps}


def side_stream_step(torch, ops, engine, decode):
    """One probed decode step of `engine` on the default stream and the
    same step on a side stream: the probe kernels keep their scratch per
    stream, so both run, and the tokens, the event tape and the maps must
    be bit-identical."""
    toks = torch.ones((engine.slots, 1), dtype=torch.int64, device="cuda")

    def one():
        nxt, logits, _, maps = decode(engine.params, toks, engine.cache,
                                      engine.maps, engine.step_count)
        return nxt, logits, decode.last[0].clone(), maps

    torch.cuda.synchronize()
    a = one()
    torch.cuda.synchronize()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    before = ops.launch_counts()
    with torch.cuda.stream(side):
        b = one()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    ran = {k: v - before[k] for k, v in ops.launch_counts().items()}
    if any(ran[k] == 0 for k in ("tensor_stats", "hash_fetch_add_batch",
                                 "table_interp")):
        fail(f"side stream: a probe kernel did not run: {ran}")
    if not torch.equal(a[0], b[0]) or not torch.equal(a[2], b[2]):
        fail("side stream: the decode step's tokens or tape differ from "
             "the default stream's")
    bad = _same_maps(b[3], a[3])
    if bad:
        fail(f"side stream: {bad} differ from the default stream's")
    out = {"launches": ran, "logits_bit_identical": torch.equal(a[1], b[1]),
           "events": int(a[2].shape[0])}
    print(f"  one probed decode step on a side stream: tokens, the "
          f"{out['events']}-event tape and the maps bit-identical to the "
          f"default stream's (logits bit-identical: "
          f"{out['logits_bit_identical']}); kernels {json.dumps(ran)}",
          flush=True)
    return out


def live_timing(torch, cfg, params, tape):
    """Warm ms per decode step with the three programs on the table lane,
    on the fused lane, and not attached (serving probes in all three), in
    turns; then us per event on one decode tape for the three programs on
    the fused lane, on the table lane and through callback_probe's host
    round trip (the paper's Table 1 comparison)."""
    from repro_torch.core import callback_probe as CB
    from repro_torch.core.runtime import BpftimeRuntime
    from repro_torch.launch import serve as L
    from repro_torch.serve.engine import ServeEngine

    def warm(lane):
        rt, pids = _live_runtime(lane)
        engine = ServeEngine(params, cfg, slots=4, max_seq=128, runtime=rt,
                             device="cuda")
        if lane == "table":
            _, engine.maps = _attach_live_three(rt, pids, engine.maps)
        reqs = L.make_requests(8, 8, cfg.vocab_size, SEED)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.submit_all(reqs)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / engine.step_count * 1e3

    warm("table")
    runs = {"table": [], "fused": [], "none": []}
    for lane in ("table", "fused", None, None, "fused", "table"):
        runs[lane or "none"].append(warm(lane))
    print("  warm ms per decode step (prefill included), three programs "
          + "; ".join(f"{k}: {', '.join(f'{v:.2f}' for v in vs)}"
                      for k, vs in runs.items()), flush=True)
    rows, aux = tape
    n = rows.shape[0]
    per_event = {}
    rt_t = BpftimeRuntime()
    pids_t = L.load_live_probes(rt_t)
    rt_t.enable_live_attach(arm=L.LIVE_ARM)
    _, maps_t = _attach_live_three(rt_t, pids_t,
                                   rt_t.init_device_maps("cuda"))
    rt_f = BpftimeRuntime()
    pids_f = L.load_live_probes(rt_f)
    for name, _, _, target in L.LIVE_PROBES[:3]:
        rt_f.attach(pids_f[name], target, mode="fused")
    maps_f = rt_f.init_device_maps("cuda")
    step = int(rows[0, 3])
    interp = serving_interp(torch, rt_t, maps_t, rows, aux)
    for label, fn, reps in (
            ("fused", lambda: rt_f.probe_stage(rows, maps_f, aux), 50),
            ("table", lambda: rt_t.probe_stage(rows, maps_t, aux), 50),
            ("callback_probe", lambda: CB.host_probe_stage(rt_f, rows, step),
             10)):
        fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
        per_event[label] = (time.perf_counter() - t0) / reps / n * 1e6
    print(f"  us per event on one decode tape of {n} events (host clock, "
          f"synchronised): " + ", ".join(f"{k} {v:.2f}"
                                         for k, v in per_event.items()),
          flush=True)
    return {"warm_ms_per_step": runs, "us_per_event": per_event,
            "tape_events": n, "serving_table_interp": interp}


def serving_interp(torch, rt, maps, rows, aux):
    """The interpreter kernel alone with the serving table (three
    LIVE_PROBES on the live table) on a real decode tape: device us per
    launch (CUDA events around calls queued behind a sleep: the launch is
    shorter than the host's enqueue), host us per call and one launch's
    phases."""
    from repro_torch.kernels import ops, table_interp as TI
    key, table = rt.live.spec_key, maps["__live_table__"]
    known = {k: maps[k] for k, *_ in key}

    def fn():
        return ops.table_interp_run(key, table, rows, known, aux)
    r = {"events": int(rows.shape[0]), "ms": queued_ms(torch, fn, 100),
         "host_us": host_us(torch, fn, 200)}
    fn()
    torch.cuda.synchronize()
    P, N = table["hcls"].shape
    vec = [p for p in range(P) if table["active"][p] and table["vec"][p]]
    r["phases_us"] = ph = TI.phase_split(TI.LAST_STAMPS.cpu(),
                                         TI.clock_khz(), vec)
    pl = TI.plan(key, P, N, *rows.shape)
    r["plan"] = f"maps {pl['maps']}, tape {pl['tape']}"
    r["bound_ms"], r["bound_by"] = bound_ms(
        _interp_bytes((key, table, rows, known, aux)), 0.0)
    print(f"  interpreter with the serving table on the {r['events']}-event "
          f"decode tape ({r['plan']}): device {r['ms'] * 1e3:.2f} us a call "
          f"(CUDA events, queued), host {r['host_us']:.1f} us a call; "
          f"one launch: copy-in {ph['copy_in']:.2f}, sequential "
          f"{ph['seq']:.2f}, vec {ph['vec']:.2f} (HASH apply "
          f"{ph['hash_apply']:.2f}), copy-out {ph['copy_out']:.2f}, total "
          f"{ph['total']:.2f} us", flush=True)
    return r


# --------------------------------------------------------------------------
# phases 7-8: training
# --------------------------------------------------------------------------

def _train_runtime(probes=True):
    from repro_torch.core.runtime import BpftimeRuntime
    from repro_torch.launch import train as T
    rt = BpftimeRuntime()
    if probes:
        T.attach_train_probes(rt)
    events = []
    stage = rt.probe_stage

    def counting_stage(rows, maps, aux, mode=None):
        events.append(int(rows.shape[0]))
        return stage(rows, maps, aux, mode=mode)
    rt.probe_stage = counting_stage
    begins = []
    poll = rt.poll_control

    def timed_poll():
        begins.append(time.perf_counter())     # the top of every step
        return poll()
    rt.poll_control = timed_poll
    return rt, events, begins


def train_full(torch, ops, cfg, steps=3, seq=4096, batch=4, microbatch=2):
    """Phase 6: full-width training through run_training on the card."""
    from repro_torch.launch import train as T
    rt, events, begins = _train_runtime()
    ends = []
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    state, hist = T.run_training(
        cfg.name, steps=steps, smoke=False, runtime=rt, probe_mode="fused",
        seq_len=seq, batch=batch, microbatch=microbatch, log_every=0,
        on_step=lambda s, st, m: ends.append(time.perf_counter()),
        device="cuda")
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    peak = torch.cuda.max_memory_allocated()
    step_s = [e - b for b, e in zip(begins, ends)]
    tokens = batch * seq
    for i, h in enumerate(hist):
        print(f"  step {i + 1}: loss {h['loss']:.5f}, grad norm "
              f"{h['grad_norm']:.5f}, lr {h['lr']:.3e}, vetoed "
              f"{int(h['vetoed'])}, {step_s[i]:.3f} s = "
              f"{tokens / step_s[i]:.0f} tokens/s", flush=True)
    warm = sum(step_s[1:]) / max(len(step_s) - 1, 1)
    print(f"  tokens/s cold (step 1) {tokens / step_s[0]:.0f}, warm "
          f"{tokens / warm:.0f}; peak memory allocated {peak / 2**30:.2f} "
          f"GiB; events collected {sum(events)} ({events} per step)",
          flush=True)
    print(f"  kernels {json.dumps(launches)}", flush=True)

    n_mb = batch // microbatch
    want_fwd = cfg.num_layers * n_mb * 2 * steps   # forward + recompute
    want_bwd = cfg.num_layers * n_mb * steps
    if len(hist) != steps or any(h["vetoed"] != 0 for h in hist):
        fail(f"training: {len(hist)} steps, vetoed {[h['vetoed'] for h in hist]}")
    if not all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
               for h in hist):
        fail("training: a loss or gradient norm is not finite")
    # the training path runs every kernel but the live lane's interpreter
    if any(v == 0 for k, v in launches.items() if k != "table_interp"):
        fail(f"a kernel was not launched on the training path: {launches}")
    if launches["tensor_stats"] != sum(events):
        fail(f"tensor_stats launches {launches['tensor_stats']} != events "
             f"collected {sum(events)}")
    if events != [cfg.num_layers * n_mb + n_mb + 1] * steps:
        fail(f"events per step {events}: expected block entries, losses "
             "and the gradient norm once each")
    if launches["flash_fwd"] != want_fwd or launches["flash_bwd"] != want_bwd:
        fail(f"flash launches {launches['flash_fwd']}/"
             f"{launches['flash_bwd']} != {want_fwd}/{want_bwd}")
    from repro_torch.core.runtime import to_numpy
    maps = to_numpy(state["maps"])
    if maps["tr_layer_counts"]["values"][:cfg.num_layers].tolist() != \
            [n_mb * steps] * cfg.num_layers:
        fail("training: the ARRAY layer counters do not count one per "
             "layer per microbatch")
    if int(maps["tr_loss_rb"]["head"][0]) != n_mb * steps or \
            int(maps["tr_gnorm_hist"]["bins"].sum()) != steps:
        fail("training: the loss record or the gradient-norm histogram "
             "missed an event")
    summary = {"steps": [{k: h[k] for k in ("loss", "grad_norm", "lr",
                                             "vetoed")} | {"s": s}
                         for h, s in zip(hist, step_s)],
               "tokens_per_step": tokens,
               "tokens_per_s_cold": tokens / step_s[0],
               "tokens_per_s_warm": tokens / warm,
               "max_memory_allocated": peak, "events_per_step": events[0],
               "launches": launches}
    return summary, state, rt


def train_profile(torch, cfg, state, rt, seq=4096, batch=4, microbatch=2):
    """One more warm step, after phase 7's launches were read, under
    torch.profiler: device busy share, device time by kernel group and the
    collector's device operations per event."""
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.train.train_step import make_train_step
    tcfg = TrainConfig(microbatch=microbatch, remat=True, warmup=10,
                       total_steps=3)
    step = make_train_step(cfg, tcfg, rt, probe_mode="fused")
    b = SyntheticDataset(cfg, ShapeConfig("prof", seq, batch, "train"),
                         tcfg, seed=SEED).next()
    torch.cuda.synchronize()
    # before "matmul", whose keys include "sm90"
    groups = {"flash kernels": ("flash_",) + tuple(f"sm90::{k}"
                                                   for k in FLASH_SM90),
              **PROBE_GROUPS}
    pwall, by_group, flash, col = profiled(
        torch, lambda: step(state, b), groups, "flash kernels")
    busy = sum(by_group.values())
    return {"profiled_wall_ms": pwall * 1e3, "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / 1e6 / pwall,
            "device_ms_by_group": {g: v / 1e3 for g, v in by_group.items()},
            "flash_kernels_device": flash, "collector_ops": col}


def train_unprobed(torch, cfg, steps=2, seq=4096, batch=4, microbatch=2):
    """Steps of the same training run with no program attached (the
    collector sees no wanted site, no probe stage runs): seconds per step
    from the top of the step to its end, as phase 7 times the probed
    run."""
    from repro_torch.launch import train as T
    rt, _, begins = _train_runtime(probes=False)
    ends = []
    torch.cuda.synchronize()
    T.run_training(cfg.name, steps=steps, smoke=False, runtime=rt,
                   probe_mode="fused", seq_len=seq, batch=batch,
                   microbatch=microbatch, log_every=0,
                   on_step=lambda s, st, m: ends.append(time.perf_counter()),
                   device="cuda")
    torch.cuda.synchronize()
    step_s = [e - b for b, e in zip(begins, ends)]
    steps = ", ".join(f"{t:.3f}" for t in step_s)
    print(f"  no program attached: steps {steps}"
          f" s = {', '.join(f'{batch * seq / t:.0f}' for t in step_s)} "
          "tokens/s", flush=True)
    return {"steps_s": step_s, "tokens_per_s": [batch * seq / t
                                                for t in step_s]}


def train_compare(torch, small, seq=4096, batch=2):
    """Phase 7: one training step of the smoke-width model on the card and
    on the CPU, from the same weights, batch and probes."""
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.core.runtime import to_numpy
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.models import registry as MR
    from repro_torch.optim import tree_leaves, tree_map
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)
    tcfg = TrainConfig(warmup=0, total_steps=10)
    gen = torch.Generator()
    gen.manual_seed(SEED)
    params = MR.init_params(small, gen, "cpu")
    batch_np = SyntheticDataset(small, ShapeConfig("cmp", seq, batch,
                                                   "train"), tcfg,
                                seed=SEED).next()
    out = {}
    for dev in ("cuda", "cpu"):
        # the gradients the step takes, before clipping and the update
        pg = tree_map(lambda t: t.detach().to(dev).requires_grad_(True),
                      params)
        b = {k: torch.as_tensor(v).to(torch.int64).to(dev)
             for k, v in batch_np.items()}
        loss, _ = MR.loss_fn(pg, b, small, remat=tcfg.remat)
        grads = [g.cpu() for g in torch.autograd.grad(loss,
                                                      tree_leaves(pg))]
        del pg, loss
        rt, _, _ = _train_runtime()
        p = tree_map(lambda t: t.to(dev), params)
        state = init_train_state(small, tcfg, rt, device=dev, params=p)
        state, m = make_train_step(small, tcfg, rt, probe_mode="fused")(
            state, batch_np)
        out[dev] = (state, m, to_numpy(state["maps"]), grads)
    (sg, mg, mapg, gg), (sc, mc, mapc, gc) = out["cuda"], out["cpu"]
    # each leaf relative to its own norm, floored at 1e-3 of the whole
    # gradient's: a leaf whose gradient is zero in exact arithmetic (the
    # k bias, by the softmax's shift invariance) holds only rounding noise
    floor = 1e-3 * float(torch.sqrt(sum(w.square().sum() for w in gc)))
    d_g = max(float((g - w).norm()) / max(float(w.norm()), floor)
              for g, w in zip(gg, gc))
    d_loss = abs(float(mg["loss"]) - float(mc["loss"]))
    d_gn = abs(float(mg["grad_norm"]) - float(mc["grad_norm"]))
    d_p = max(float((a.cpu() - b).abs().max()) for a, b in
              zip(tree_leaves(sg["params"]), tree_leaves(sc["params"])))
    if not (d_loss <= TRAIN_CMP_TOL * abs(float(mc["loss"]))
            and d_gn <= TRAIN_CMP_TOL * float(mc["grad_norm"])
            and d_g <= TRAIN_CMP_TOL and d_p <= TRAIN_PARAM_TOL):
        fail(f"smoke training step card vs CPU: loss {d_loss:.2e}, grad "
             f"norm {d_gn:.2e}, worst gradient leaf {d_g:.2e} (relative, "
             f"limit {TRAIN_CMP_TOL}), params {d_p:.2e} (limit "
             f"{TRAIN_PARAM_TOL})")
    for name in ("tr_layer_counts", "tr_key_hash", "tr_gnorm_hist"):
        for f in mapc[name]:
            if not (mapg[name][f] == mapc[name][f]).all():
                fail(f"smoke training step: map {name}.{f} differs between "
                     "card and CPU")
    print(f"  smoke qwen2-0.5b (f32) seq {seq} batch {batch}, one step: "
          f"loss {float(mc['loss']):.6f}; card vs CPU abs diff loss "
          f"{d_loss:.2e}, grad norm {d_gn:.2e} (relative limit "
          f"{TRAIN_CMP_TOL}), worst gradient leaf {d_g:.2e} relative "
          f"(limit {TRAIN_CMP_TOL}), params max {d_p:.2e} (limit "
          f"{TRAIN_PARAM_TOL}); counter, hash and histogram maps equal",
          flush=True)
    return {"loss_diff": d_loss, "grad_norm_diff": d_gn,
            "grad_leaf_rel_diff": d_g, "param_diff": d_p}


# --------------------------------------------------------------------------
# phase 9: the fleet worker and durable training
# --------------------------------------------------------------------------

def scratch_dir(need_bytes: int, what: str = "phase 9") -> str:
    """A new directory for phase 9's (or 10's) shm regions and
    checkpoints, on the first of build/ and the temporary directory with
    `need_bytes` free."""
    import shutil
    import tempfile
    frees = []
    for cand in (ROOT / "build", Path(tempfile.gettempdir())):
        cand.mkdir(parents=True, exist_ok=True)
        free = shutil.disk_usage(cand).free
        frees.append(f"{cand}: {free / 1e9:.1f} GB")
        if free >= need_bytes:
            return tempfile.mkdtemp(prefix="chip_smoke_fleet_", dir=cand)
    fail(f"{what} needs {need_bytes / 1e9:.1f} GB free for its shm regions "
         f"and files; free: {', '.join(frees)}")


def fleet_reader(src: str, root: str, worker_id: str, queue) -> None:
    """The reader process of phase 9 (started with spawn): attach worker
    `worker_id`'s region read-only with the port alone (no JAX) and send
    back every device map's snapshot -- seqlocked and CRC-checked by
    snapshot_device_meta -- as (seq, {field: (dtype, shape, bytes)})."""
    sys.path.insert(0, src)
    sys.modules["jax"] = None
    sys.modules["repro"] = None
    from repro_torch.core.shm import ShmRegion
    region = ShmRegion.attach(root, mode="r", worker_id=worker_id)
    out = {}
    for spec in region.specs:
        st, seq, _ = region.snapshot_device_meta(spec.name)
        out[spec.name] = (seq, {f: (a.dtype.str, a.shape, a.tobytes())
                                for f, a in st.items()})
    queue.put(out)


def read_in_subprocess(root: str, worker_id: str) -> dict:
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    p = ctx.Process(target=fleet_reader, args=(str(SRC), root, worker_id, q))
    p.start()
    import queue
    deadline = time.monotonic() + 300
    try:
        while True:
            try:
                out = q.get(timeout=1)
                break
            except queue.Empty:
                if not p.is_alive() or time.monotonic() > deadline:
                    fail(f"phase 9: the reader process gave no snapshot "
                         f"(exit code {p.exitcode})")
    finally:
        p.join(timeout=60)
        if p.is_alive():
            p.kill()
            p.join()
    if p.exitcode != 0:
        fail(f"phase 9: the reader process exited {p.exitcode}")
    return out


def fleet_serve(torch, ops, cfg, params, tmp, device="cuda"):
    """(a): phase 3's model, probes and admission filter with the live lane
    on, served by an engine that is shm worker w0. A load_attach of one
    LIVE_PROBES program is queued through a second handle on the region
    after the first requests, and a detach of the link status.json reports
    after the next; every probed step is replayed through a runtime with
    the program on the fused lane, and a reader process reads the region."""
    import os
    from repro_torch.core import loader, shm as SH
    from repro_torch.core.maps import MapKind, MapSpec
    from repro_torch.core.runtime import to_numpy
    from repro_torch.launch import serve as L
    from repro_torch.serve.engine import ServeEngine
    root = os.path.join(tmp, "shm")
    rt, _ = _live_runtime("table")
    engine = ServeEngine(params, cfg, slots=4, max_seq=128, runtime=rt,
                         shm_dir=root, worker_id="w0", device=device)
    decode = engine._decode
    steps, part, mark, applied, pub_us = [], [1], {}, [], []
    stage, publish, poll = rt.probe_stage, rt.publish, rt.poll_control

    def recording(rows, maps, aux, mode=None):
        out = stage(rows, maps, aux, mode=mode)
        steps.append((part[0], rows, {k: v for k, v in maps.items()
                                      if k != "__live_table__"}, aux,
                      out[0]))
        if "applied" in mark and "first_run" not in mark:
            torch.cuda.synchronize()
            mark["first_run"] = time.perf_counter()
        return out

    def timed_publish(maps):
        torch.cuda.synchronize()          # the step's own work is not timed
        t0 = time.perf_counter()
        publish(maps)
        pub_us.append((time.perf_counter() - t0) * 1e6)

    def recording_poll():
        got = poll()
        if got:
            applied.extend(got)
            if "queued" in mark:
                mark.setdefault("applied", time.perf_counter())
        return got
    rt.probe_stage, rt.publish, rt.poll_control = (recording, timed_publish,
                                                   recording_poll)
    name, text, (mname, kind, n, w), target = L.LIVE_PROBES[0]
    obj = loader.build_object(name, text, [MapSpec(mname, MapKind(kind), n,
                                                   rec_width=w)],
                              "uprobe", attach_to=target)
    daemon = SH.ShmRegion.attach(root, worker_id="w0")
    reqs = L.make_requests(10, 8, cfg.vocab_size, SEED + 2)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    interp = [0]                # interpreter launches at the end of each part

    def end_part():
        interp.append(ops.launch_counts()["table_interp"])
    engine.submit_all(reqs[:4])                 # part 1: nothing live
    end_part()
    part[0] = 2
    mark["queued"] = time.perf_counter()
    daemon.request({"op": "load_attach", "object": obj.to_json(),
                    "mode": "table", "promote": False})
    engine.submit_all(reqs[4:8])                # part 2: the program live
    end_part()
    status_on = daemon.read_status()
    links = [k for k, v in status_on["promotions"].items()
             if v["lane"] == "table"]
    if len(links) != 1:
        fail(f"phase 9: status.json has table links {links}")
    part[0] = 3
    daemon.request({"op": "detach", "link_id": int(links[0])})
    engine.submit_all(reqs[8:])                 # part 3: detached
    end_part()
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    status_off = daemon.read_status()
    table_empty = not rt.live.host["active"].any()
    del rt.probe_stage, rt.publish, rt.poll_control
    probed = {k: sum(1 for s in steps if s[0] == k) for k in (1, 2, 3)}
    if engine._decode is not decode:
        fail("phase 9: the engine's decode step was rebuilt")
    if [a.get("error") for a in applied] != [None, None] or \
            [a["op"] for a in applied] != ["load_attach", "detach"]:
        fail(f"phase 9: control requests applied as {applied}")
    if status_on["live_slots"].get("0") != name or \
            status_off["live_slots"].get("0") is not None or \
            links[0] in status_off["links"]:
        fail(f"phase 9: status.json live slots {status_on['live_slots']} "
             f"then {status_off['live_slots']}")
    # the table lane launches once per probed step while the live lane is
    # on, whatever the table holds (as JAX's in-step table runs): an empty
    # table costs a launch that changes nothing. So each part is held to
    # one launch per probed step; that the program stopped running after
    # the detach is shown by the empty host table here and by its map,
    # which stops counting (below)
    per_part = {k: interp[k] - interp[k - 1] for k in (1, 2, 3)}
    if not all(probed.values()) or per_part != probed:
        fail(f"phase 9: interpreter launches per part {per_part} for "
             f"probed steps per part {probed}")
    if not table_empty:
        fail("phase 9: the live table still has an active slot after the "
             "detach")
    if any(launches[k] == 0 for k in ("tensor_stats", "hash_fetch_add_batch",
                                      "ringbuf_emit_batch")):
        fail(f"phase 9: a serving kernel was not launched: {launches}")
    # the program ran on exactly the steps of part 2: one count per layer
    for k, rows, maps_in, aux, out in steps:
        moved = int(out[mname]["values"].sum() - maps_in[mname]["values"]
                    .sum())
        if moved != (cfg.num_layers if k == 2 else 0):
            fail(f"phase 9: part {k}: the attached program counted {moved}")
    rf, fp = _live_runtime(None)
    link, detached = None, False
    for k, rows, maps_in, aux, out in steps:
        if k == 2 and link is None and not detached:
            link = rf.attach(fp[name], target, mode="fused")
        if k == 3 and link is not None:
            rf.detach(link)
            link, detached = None, True
        want, _ = rf.probe_stage(rows, maps_in, aux)
        bad = _same_maps(out, want)
        if bad:
            fail(f"phase 9: part {k}: {bad} differ from the fused-lane "
                 "replay")
    final = to_numpy(engine.maps)
    nbytes = sum(a.nbytes for st in final.values() for a in st.values())
    got = read_in_subprocess(root, "w0")
    if sorted(got) != sorted(final):
        fail(f"phase 9: the reader saw maps {sorted(got)}")
    for m, (seq, fields) in got.items():
        if seq % 2 or seq == 0:
            fail(f"phase 9: the reader's {m} snapshot has seq {seq}")
        for f, a in final[m].items():
            if fields[f] != (a.dtype.str, a.shape, a.tobytes()):
                fail(f"phase 9: the reader's {m}.{f} differs from the "
                     "engine's maps")
    pub = sorted(pub_us)
    to_run_ms = (mark["first_run"] - mark["queued"]) * 1e3
    print(f"  served {engine.step_count} decode steps ({probed} probed per "
          f"part); publish {pub[len(pub) // 2]:.1f} us median, "
          f"{pub[int(len(pub) * 0.9)]:.1f} us p90 of host ({len(pub)} "
          f"publishes of {nbytes} bytes); request queued to the end of the "
          f"first probe stage that ran it {to_run_ms:.2f} ms; kernels "
          f"{json.dumps(launches)}", flush=True)
    print(f"  decode step unchanged; {len(steps)} probed steps bit-identical "
          "to the fused-lane replay; status.json live slot 0 "
          f"{name} then empty; a reader process read all {len(got)} maps "
          "with even seq and valid CRC, bit for bit the engine's",
          flush=True)
    return {"decode_steps": engine.step_count, "probed_steps": probed,
            "publish_host_us_median": pub[len(pub) // 2],
            "publish_host_us_p90": pub[int(len(pub) * 0.9)],
            "publishes": len(pub), "bytes_per_publish": nbytes,
            "request_to_run_ms": to_run_ms, "launches": launches}


def shm_timing(torch, cfg, params, tmp, device="cuda"):
    """Warm serving passes (host clock, prefill included) with the shm
    plane (engine as a worker: poll, sync and publish every step) and
    without it, in turns."""
    import os
    runs = {"shm": [], "none": []}
    for i, with_shm in enumerate((True, False, False, True, True, False)):
        engine, reqs = serve(torch, cfg, device, params,
                             shm_dir=os.path.join(tmp, "timing") if with_shm
                             else None, worker_id=f"p{i}")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        engine.submit_all(reqs)
        torch.cuda.synchronize()
        runs["shm" if with_shm else "none"].append(
            (time.perf_counter() - t0) / engine.step_count * 1e3)
    print(f"  warm ms per decode step (prefill included), in turns: with the "
          f"shm plane {', '.join(f'{m:.2f}' for m in runs['shm'])}; without "
          f"{', '.join(f'{m:.2f}' for m in runs['none'])}", flush=True)
    return {"warm_ms_per_step_shm": runs["shm"],
            "warm_ms_per_step_none": runs["none"]}


def int8_step(torch, cfg, seq=4096, batch=4, microbatch=2, device="cuda"):
    """(b): one training step with grad_compression="int8" at phase 7's
    shape and probes. The step's own call of int8_roundtrip is recorded
    (its input, the clipped gradients, and the output the update took) and
    that output is held bit for bit against the same function on CPU
    copies of the input."""
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.dist.compression import compression_error
    from repro_torch.optim import tree_leaves
    from repro_torch.train import train_step as TS
    rt, _, _ = _train_runtime()
    tcfg = TrainConfig(microbatch=microbatch, remat=True, warmup=10,
                       total_steps=3, grad_compression="int8")
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    state = TS.init_train_state(cfg, tcfg, rt, gen, device)
    step = TS.make_train_step(cfg, tcfg, rt, probe_mode="fused")
    b = SyntheticDataset(cfg, ShapeConfig("int8", seq, batch, "train"),
                         tcfg, seed=SEED).next()
    roundtrip, calls = TS.int8_roundtrip, []

    def recording(tree):
        out = roundtrip(tree)
        calls.append((tree, out))
        return out
    TS.int8_roundtrip = recording
    try:
        state, m = step(state, b)
    finally:
        TS.int8_roundtrip = roundtrip
    del state
    if len(calls) != 1:
        fail(f"phase 9: the int8 step called int8_roundtrip {len(calls)} "
             "times")
    grads, card = calls.pop()
    loss, gnorm, vetoed = float(m["loss"]), float(m["grad_norm"]), \
        int(m["vetoed"])
    if not (math.isfinite(loss) and math.isfinite(gnorm)) or vetoed:
        fail(f"phase 9: the int8 step gave loss {loss}, grad norm {gnorm}, "
             f"vetoed {vetoed}")
    rt_ms = cuda_ms(torch, lambda: roundtrip(grads), reps=5, warmup=1)
    err = float(compression_error(grads))
    n = 0
    for g, c in zip(tree_leaves(grads), tree_leaves(card)):
        if c.device.type != torch.device(device).type:
            fail(f"phase 9: a {tuple(g.shape)} gradient's round trip ran "
                 f"on {c.device}")
        if not _leaf_bits_equal(torch, c, roundtrip(g.cpu())):
            fail(f"phase 9: the int8 round trip of a {tuple(g.shape)} "
                 f"{g.dtype} gradient differs between card and CPU")
        n += g.numel()
    print(f"  int8 step: loss {loss:.5f}, grad norm {gnorm:.5f}; the step's "
          f"round trip of {n} clipped gradients bit for bit the CPU's, "
          f"{rt_ms:.3f} ms on the card; compression error {err:.3e}",
          flush=True)
    return {"loss": loss, "grad_norm": gnorm, "gradients": n,
            "roundtrip_device_ms": rt_ms, "compression_error": err}


def _leaf_bits_equal(torch, a, b) -> bool:
    a, b = a.detach().cpu(), b.detach().cpu()
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        view = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
            a.element_size()]
        a, b = a.view(view), b.view(view)
    return torch.equal(a, b)


def ckpt_train(torch, cfg, tmp, seq=4096, batch=4, microbatch=2,
               smoke=False, device="cuda"):
    """(c): run_training for 2 steps as shm worker t0 with a checkpoint after
    each; step_1 restored into a fresh state, step 2 taken again from it
    with the same batch, held against step_2's files; t0's published maps
    against the final state's."""
    import os
    from repro_torch.ckpt import checkpoint as CK
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.core.runtime import to_numpy
    from repro_torch.core.shm import ShmRegion
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.launch import train as T
    from repro_torch.optim import tree_leaves
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)
    shm, ck = os.path.join(tmp, "train_shm"), os.path.join(tmp, "ckpt")
    os.makedirs(ck)
    rt, _, _ = _train_runtime()
    save, save_s = CK.save, []

    def timed_save(*a, **kw):
        t0 = time.perf_counter()
        out = save(*a, **kw)
        save_s.append(time.perf_counter() - t0)
        return out
    CK.save = timed_save
    try:
        state, hist = T.run_training(
            cfg.name, steps=2, smoke=smoke, runtime=rt,
            probe_mode="fused", seq_len=seq, batch=batch,
            microbatch=microbatch, log_every=0, shm_dir=shm, worker_id="t0",
            ckpt_dir=ck, save_every=1, device=device)
    finally:
        CK.save = save
    if CK.latest(ck) != 2 or len(save_s) != 2:
        fail(f"phase 9: checkpoints {os.listdir(ck)} after 2 steps")
    final = to_numpy(state["maps"])
    region = ShmRegion.attach(shm, mode="r", worker_id="t0")
    for m, st in final.items():
        got = region.snapshot_device(m)
        if any(not (got[f] == a).all() for f, a in st.items()):
            fail(f"phase 9: t0's published {m} differs from the final state")
    del state
    gb = sum(os.path.getsize(os.path.join(ck, "step_1", f))
             for f in os.listdir(os.path.join(ck, "step_1"))) / 1e9
    tcfg = TrainConfig(microbatch=microbatch, remat=True, warmup=10,
                       total_steps=2)
    rt2, _, _ = _train_runtime()
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED + 1)
    fresh = init_train_state(cfg, tcfg, rt2, gen, device)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    restored = CK.restore(ck, 1, fresh, device=device)
    torch.cuda.synchronize()
    restore_s = time.perf_counter() - t0
    del fresh
    data = SyntheticDataset(cfg, ShapeConfig("ckpt", seq, batch, "train"),
                            tcfg)
    data.next()
    state2, _ = make_train_step(cfg, tcfg, rt2, probe_mode="fused")(
        restored, data.next())
    del restored
    want = CK.restore(ck, 2, state2, device="cpu")
    with open(os.path.join(ck, "step_2", "tree.json")) as f:
        names = json.load(f)["names"]
    got_l, want_l = tree_leaves(state2), tree_leaves(want)
    diff = [nm for nm, a, b in zip(names, got_l, want_l)
            if not _leaf_bits_equal(torch, a, b)]
    if any(not nm.startswith(("params/", "opt/")) for nm in diff):
        fail(f"phase 9: the restored step 2 differs in {diff[:8]}")
    if diff:
        # not bitwise repeatable: phase 8's tolerances
        for nm, a, b in zip(names, got_l, want_l):
            d = float((a.detach().cpu().float() - b.float()).abs().max())
            if nm in diff and d > TRAIN_PARAM_TOL:
                fail(f"phase 9: restored step 2's {nm} is off by {d}")
    print(f"  run_training as shm worker t0: 2 steps, checkpoints of "
          f"{gb:.3f} GB saved in {', '.join(f'{t:.2f}' for t in save_s)} s "
          f"(host copy and files, blocking), step_1 restored to the card in "
          f"{restore_s:.2f} s; step 2 again from it: "
          f"{'bit for bit' if not diff else f'{len(diff)} leaves within {TRAIN_PARAM_TOL}'}"
          f" step_2's {len(names)} leaves; t0's published maps equal the "
          "final state's", flush=True)
    return {"gb_per_checkpoint": gb, "save_s": save_s,
            "restore_s": restore_s, "leaves": len(names),
            "not_bitwise": diff, "losses": [h["loss"] for h in hist]}


# --------------------------------------------------------------------------
# phase 10: the fleet aggregator and the grammar fuzzer
# --------------------------------------------------------------------------

FLEET_WIDS = ("w000", "w001", "w002", "w003")
ATTACHED = ("w001", "w002")          # the CLI attach's --worker targets


def _pct(xs, q):
    xs = sorted(xs)
    return xs[min(len(xs) - 1, int(len(xs) * q))] if xs else float("nan")


def tree_aggregator(src, root, wids, device, stop, out) -> None:
    """The aggregator process of phase 10(a) (started with spawn): the port
    alone runs TreeAggregator(root, fan_in=2, depth=1) with its node folds
    on `device`, cycling until `stop` is set and twice more after it, and
    sends back its cycle times, what each cycle had folded, and the node
    folds' device time beside the numpy twins' on the same stacks."""
    sys.path.insert(0, src)
    sys.modules["jax"] = None
    sys.modules["repro"] = None
    import numpy as np
    import torch
    from repro_torch.core import daemon as D, maps as M
    from repro_torch.core.treeagg import TreeAggregator
    z = np.zeros((2, 4), np.int64)
    # the CUDA context and the fold's first launches are not timed
    M.t_group_summary_fold_multi({"w": {"values": (z[0], z, z)}}, device)
    M.t_hash_coalesce(np.arange(4), np.ones(4, np.int64), device)
    stacks, fold = [], M.t_group_summary_fold_multi

    def recording(s, device="cuda"):
        stacks.append(s)
        del stacks[:-24]
        return fold(s, device)
    M.t_group_summary_fold_multi = recording
    tree = TreeAggregator(root, fan_in=2, depth=1, worker_ids=wids,
                          config=D.AggregatorConfig(device=device))
    node_ms, root_ms, cycles = [], [], []

    def cycle():
        for na in tree.node_aggs:
            t0 = time.perf_counter()
            na.poll_once()
            node_ms.append((time.perf_counter() - t0) * 1e3)
        t0 = time.perf_counter()
        tree.root_agg.poll_once()
        root_ms.append((time.perf_counter() - t0) * 1e3)
        cycles.append((time.monotonic(), {
            w: int(na.workers[w]["seq"]) for na in tree.node_aggs
            for w in na.workers}))
    out.put("ready")
    while not stop.is_set():
        cycle()
        time.sleep(0.01)
    cycle()
    cycle()
    dev_ms, host_ms, np_ms = [], [], []
    for s in stacks:
        if device != "cpu":
            ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
            torch.cuda.synchronize()
            ev[0].record()
        t0 = time.perf_counter()
        got = fold(s, device)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        if device != "cpu":
            ev[1].record()
            torch.cuda.synchronize()
            dev_ms.append(ev[0].elapsed_time(ev[1]))
        t0 = time.perf_counter()
        want = M.n_group_summary_fold_multi(s)
        np_ms.append((time.perf_counter() - t0) * 1e3)
        if any(not np.array_equal(got[n][f], want[n][f])
               for n in want for f in want[n]):
            out.put({"error": "a device fold differs from the numpy twin"})
            return
    out.put({"node_ms": node_ms, "root_ms": root_ms, "cycles": cycles,
             "nodes": [na.node_id for na in tree.node_aggs],
             "fold_device_ms": dev_ms, "fold_host_ms": host_ms,
             "fold_numpy_ms": np_ms, "folds_timed": len(stacks)})


def mirror_root(root: str, twin: str) -> str:
    """A root over the same worker regions (meta, programs and workers are
    links) with a global view and node registry of its own."""
    import os
    os.makedirs(twin)
    for name in ("meta.json", "progs", "workers"):
        os.symlink(os.path.join(root, name), os.path.join(twin, name))
    return twin


def view_states(root: str) -> dict:
    from repro_torch.core import shm as SH
    g = SH.GlobalView.attach(root)
    return {s.name: g.snapshot(s.name) for s in SH.read_meta_specs(root)}


def views_differ(a: dict, b: dict) -> list:
    return [f"{m}.{f}" for m in b for f in b[m]
            if m not in a or f not in a[m] or a[m][f].shape != b[m][f].shape
            or not (a[m][f] == b[m][f]).all()]


def flat_oracle(root: str, wids) -> dict:
    """The global view the plane must publish, from every worker's final
    published maps folded by the numpy twins: summary fields summed, HASH
    items summed and laid out canonically, ring records interleaved by
    (step, worker, position)."""
    import numpy as np
    from repro_torch.core import maps as M, shm as SH
    specs = SH.read_meta_specs(root)
    snaps = {w: {s.name: SH.ShmRegion.attach(root, mode="r", worker_id=w)
                 .snapshot_device(s.name) for s in specs} for w in wids}
    out = {}
    for spec in specs:
        sts = [snaps[w][spec.name] for w in wids]
        if M.is_summary_kind(spec.kind):
            with np.errstate(over="ignore"):
                out[spec.name] = {f: np.sum([st[f] for st in sts], axis=0,
                                            dtype=np.int64)
                                  for f in M.SUMMARY_FIELDS[spec.kind]}
        elif spec.kind == M.MapKind.HASH:
            items: dict = {}
            for st in sts:
                for k, v in M.n_hash_items(st).items():
                    items[k] = int(np.int64(items.get(k, 0) + v))
            out[spec.name] = M.n_hash_canonical(spec, items)
        else:
            tagged, total = [], 0
            for w, st in zip(wids, sts):
                t, head = M.n_ringbuf_tagged(
                    st, w, step_lane=spec.flags.get("step_lane"))
                tagged += t
                total += head
            out[spec.name] = M.ringbuf_merge_global(spec, tagged, total)
    return out, snaps


def _cli(argv) -> tuple[int, str]:
    import contextlib
    import io
    from repro_torch.core import daemon as D
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = D.main(argv)
    return rc, buf.getvalue()


def fleet_tree(torch, ops, cfg, tmp, device="cuda", rounds=4, per_turn=4):
    """(a): four serving workers w000-w003 on the card, each with phase 6's
    runtime (phase 3's probes, the live lane), sharing one set of phase 3's
    weights and taking turns of `per_turn` requests; a spawned process runs
    the tree aggregator while they serve. After w000's turn of round 2 the
    daemon CLI queues an attach of LIVE_PROBES[0] on w001 and w002, after
    w000's turn of round 3 the matching detach."""
    import multiprocessing as mp
    import os
    import queue
    from repro_torch.core import daemon as D, loader, maps as M, shm as SH
    from repro_torch.core.maps import MapKind, MapSpec
    from repro_torch.core.runtime import to_numpy
    from repro_torch.launch import serve as L
    from repro_torch.models import registry as MR
    from repro_torch.serve.engine import ServeEngine
    root = os.path.join(tmp, "fleet")
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    params = MR.init_params(cfg, gen, device)
    engines, steps, pubs, applied = {}, {w: [] for w in FLEET_WIDS}, [], {}
    part, mark = [1], {}
    for i, wid in enumerate(FLEET_WIDS):
        rt, _ = _live_runtime("table")
        eng = ServeEngine(params, cfg, slots=4, max_seq=128, runtime=rt,
                          shm_dir=root, worker_id=wid, device=device)
        stage, publish, poll = rt.probe_stage, rt.publish, rt.poll_control

        def recording(rows, maps, aux, mode=None, _s=stage, _w=wid):
            out = _s(rows, maps, aux, mode=mode)
            steps[_w].append((part[0], rows, {
                k: v for k, v in maps.items() if k != "__live_table__"},
                aux, out[0]))
            if _w == "w001" and "queued" in mark and \
                    "first_run" not in mark:
                if device != "cpu":
                    torch.cuda.synchronize()
                mark["first_run"] = time.perf_counter()
            return out

        def timed_publish(maps, _p=publish, _rt=rt, _w=wid):
            _p(maps)
            pubs.append((time.monotonic(), _w, int(_rt.shm.seq.max())))

        def recording_poll(_p=poll, _w=wid):
            got = _p()
            applied.setdefault(_w, []).extend(got)
            return got
        rt.probe_stage, rt.publish, rt.poll_control = (
            recording, timed_publish, recording_poll)
        engines[wid] = (eng, eng._decode,
                        L.make_requests(rounds * per_turn, 8,
                                        cfg.vocab_size, SEED + 10 + i))
    name, text, (mname, kind, n, w), target = L.LIVE_PROBES[0]
    obj = loader.build_object(name, text, [MapSpec(mname, MapKind(kind), n,
                                                   rec_width=w)],
                              "uprobe", attach_to=target)
    obj_path = os.path.join(tmp, f"{name}.json")
    with open(obj_path, "w") as fh:
        fh.write(obj.to_json())
    ctx = mp.get_context("spawn")
    stop, out_q = ctx.Event(), ctx.Queue()
    agg = ctx.Process(target=tree_aggregator, args=(
        str(SRC), root, list(FLEET_WIDS), device, stop, out_q))
    agg.start()
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    cli = [sys.executable, "-m", "repro_torch.core.daemon", root]
    workers = " ".join(f"--worker {w}" for w in ATTACHED).split()
    try:
        if out_q.get(timeout=300) != "ready":
            fail("phase 10: the aggregator process did not start")
        if device != "cpu":
            torch.cuda.synchronize()
        ops.reset_launch_counts()
        t_serve = time.perf_counter()
        for r in range(rounds):
            for wid in FLEET_WIDS:
                eng, _, reqs = engines[wid]
                eng.submit_all(reqs[r * per_turn:(r + 1) * per_turn])
                if wid != "w000" or r not in (1, 2):
                    continue
                if r == 1:
                    t0 = time.perf_counter()
                    res = subprocess.run(
                        cli + ["attach", obj_path, "--mode", "table",
                               "--no-promote"] + workers, env=env,
                        capture_output=True, text=True, timeout=300)
                    mark["queued"] = time.perf_counter()
                    mark["cli_attach_s"] = mark["queued"] - t0
                    part[0] = 2
                else:
                    lids = set()
                    for a in ATTACHED:
                        st = SH.ShmRegion.attach(root, worker_id=a) \
                            .read_status()
                        lids |= {k for k, v in st["promotions"].items()
                                 if v["lane"] == "table"}
                    if len(lids) != 1:
                        fail(f"phase 10: w001/w002 report table links "
                             f"{sorted(lids)}")
                    res = subprocess.run(
                        cli + ["detach", lids.pop()] + workers, env=env,
                        capture_output=True, text=True, timeout=300)
                    part[0] = 3
                if res.returncode != 0:
                    fail(f"phase 10: the daemon CLI exited {res.returncode}:"
                         f" {res.stderr.strip()[-400:]}")
        if device != "cpu":
            torch.cuda.synchronize()
        serve_s = time.perf_counter() - t_serve
        launches = ops.launch_counts()
        # each worker publishes its unchanged maps once more (what an idle
        # worker's heartbeat does), then the aggregator's two last cycles
        for wid in FLEET_WIDS:
            eng = engines[wid][0]
            eng.runtime.publish(eng.maps)
        stop.set()
        got = out_q.get(timeout=300)
    finally:
        stop.set()
        agg.join(timeout=60)
        if agg.is_alive():
            agg.kill()
            agg.join()
    if not isinstance(got, dict) or "error" in got or agg.exitcode != 0:
        fail(f"phase 10: the aggregator process gave {got!r} "
             f"(exit code {agg.exitcode})")
    # ---- what the workers did
    probed = {w: {k: sum(1 for s in steps[w] if s[0] == k) for k in (1, 2, 3)}
              for w in FLEET_WIDS}
    for wid in FLEET_WIDS:
        eng, decode, _ = engines[wid]
        rt = eng.runtime
        del rt.probe_stage, rt.publish, rt.poll_control
        if eng._decode is not decode:
            fail(f"phase 10: {wid}'s decode step was rebuilt")
        ops_ = [(a["op"], a.get("error")) for a in applied.get(wid, [])]
        want = ([("load_attach", None), ("detach", None)]
                if wid in ATTACHED else [])
        if ops_ != want:
            fail(f"phase 10: {wid} applied control requests {ops_}")
        if wid in ATTACHED and not probed[wid][2]:
            fail(f"phase 10: {wid} ran no probed step while attached "
                 f"({probed[wid]})")
        for k, rows, maps_in, aux, out in steps[wid]:
            moved = int(out[mname]["values"].sum()
                        - maps_in[mname]["values"].sum())
            if moved != (cfg.num_layers if wid in ATTACHED and k == 2
                         else 0):
                fail(f"phase 10: {wid} part {k}: {name} counted {moved}")
    n_probed = sum(len(s) for s in steps.values())
    if launches["table_interp"] != n_probed:
        fail(f"phase 10: {launches['table_interp']} interpreter launches "
             f"for {n_probed} probed steps")
    if any(launches[k] == 0 for k in ("tensor_stats", "hash_fetch_add_batch",
                                      "ringbuf_emit_batch")):
        fail(f"phase 10: a serving kernel was not launched: {launches}")
    for wid in ATTACHED:
        rf, fp = _live_runtime(None)
        link, detached = None, False
        for k, rows, maps_in, aux, out in steps[wid]:
            if k == 2 and link is None and not detached:
                link = rf.attach(fp[name], target, mode="fused")
            if k == 3 and link is not None:
                rf.detach(link)
                link, detached = None, True
            want, _ = rf.probe_stage(rows, maps_in, aux)
            bad = _same_maps(out, want)
            if bad:
                fail(f"phase 10: {wid} part {k}: {bad} differ from the "
                     "fused-lane replay")
    # ---- what the aggregator published
    oracle, snaps = flat_oracle(root, FLEET_WIDS)
    for wid in FLEET_WIDS:
        final = to_numpy(engines[wid][0].maps)
        bad = views_differ(snaps[wid], final)
        if bad:
            fail(f"phase 10: {wid}'s published {bad} differ from its maps")
    tree_view = view_states(root)
    bad = views_differ(tree_view, oracle)
    if bad:
        fail(f"phase 10: the tree's global {bad} differ from the flat oracle")
    flat = D.Aggregator(mirror_root(root, os.path.join(tmp, "flat")),
                        config=D.AggregatorConfig(device_fold=False))
    flat.poll_once()
    bad = views_differ(view_states(flat.root), tree_view)
    if bad:
        fail(f"phase 10: a flat aggregator's {bad} differ from the tree's")
    rc, txt = _cli([root, "fleet", "health", "--json"])
    health = json.loads(txt)
    states = {w: health["health"].get(w, {}).get("state")
              for w in FLEET_WIDS}
    if rc != 0 or set(states.values()) != {D.HEALTHY} or \
            sorted(health["nodes"]) != ["n0_0", "n0_1"] or \
            any(health["stream_lost"].values()) or \
            any(health["hash_dropped"].values()):
        fail(f"phase 10: fleet health: workers {states}, nodes "
             f"{sorted(health['nodes'])}, stream_lost "
             f"{health['stream_lost']}, hash_dropped "
             f"{health['hash_dropped']}")
    hname = next(s.name for s in SH.read_meta_specs(root)
                 if s.kind == MapKind.HASH)
    rc, txt = _cli([root, "map", "dump", hname, "--json"])
    (doc,) = json.loads(txt)
    if rc != 0 or any(doc[f] != tree_view[hname][f].tolist()
                      for f in tree_view[hname]):
        fail(f"phase 10: map dump {hname} differs from the global view")
    # ---- times
    lat = []
    for t_pub, wid, seq in pubs:
        t_in = next((t for t, seen in got["cycles"]
                     if seen.get(wid, -1) >= seq), None)
        if t_in is not None:
            lat.append((t_in - t_pub) * 1e3)
    to_run_ms = (mark["first_run"] - mark["queued"]) * 1e3
    res = {"workers": list(FLEET_WIDS), "probed_steps": probed,
           "decode_steps": {w: engines[w][0].step_count for w in FLEET_WIDS},
           "serve_s": serve_s, "publishes": len(pubs),
           "tree_cycles": len(got["cycles"]), "nodes": got["nodes"],
           "node_cycle_host_ms_median": _pct(got["node_ms"], 0.5),
           "node_cycle_host_ms_p90": _pct(got["node_ms"], 0.9),
           "root_cycle_host_ms_median": _pct(got["root_ms"], 0.5),
           "root_cycle_host_ms_p90": _pct(got["root_ms"], 0.9),
           "fold_device_ms_median": _pct(got["fold_device_ms"], 0.5),
           "fold_host_ms_median": _pct(got["fold_host_ms"], 0.5),
           "fold_numpy_ms_median": _pct(got["fold_numpy_ms"], 0.5),
           "folds_timed": got["folds_timed"],
           "publish_to_root_ms_median": _pct(lat, 0.5),
           "publish_to_root_ms_p90": _pct(lat, 0.9),
           "publishes_seen": len(lat),
           "cli_attach_process_s": mark["cli_attach_s"],
           "cli_queue_to_first_run_ms": to_run_ms,
           "launches": launches}
    print(f"  4 workers served {res['decode_steps']} decode steps in "
          f"{serve_s:.1f} s ({probed} probed per part); {len(pubs)} "
          f"publishes, {len(got['cycles'])} tree cycles; node cycle "
          f"{res['node_cycle_host_ms_median']:.2f} ms median, "
          f"{res['node_cycle_host_ms_p90']:.2f} p90; root cycle "
          f"{res['root_cycle_host_ms_median']:.2f} / "
          f"{res['root_cycle_host_ms_p90']:.2f} ms of host", flush=True)
    print(f"  node fold on the card {res['fold_device_ms_median']:.3f} ms "
          f"(CUDA events; {res['fold_host_ms_median']:.3f} ms of host), "
          f"numpy twin {res['fold_numpy_ms_median']:.3f} ms, on the same "
          f"{got['folds_timed']} stacks; publish to the first root view "
          f"that holds it {res['publish_to_root_ms_median']:.1f} ms median, "
          f"{res['publish_to_root_ms_p90']:.1f} p90; CLI attach process "
          f"{mark['cli_attach_s']:.2f} s, queued to w001's first run "
          f"{to_run_ms:.1f} ms", flush=True)
    print(f"  tree view = flat oracle = flat Aggregator(device_fold=False); "
          f"fleet health: 4 HEALTHY, nodes {sorted(health['nodes'])}; "
          f"{name} counted on w001/w002 while attached only; replays "
          f"bit-identical; kernels {json.dumps(launches)}", flush=True)
    return res


def fleet_scale(tmp, device="cuda", n_workers=64, fan_in=8, rounds=7,
                events=384):
    """(b): 64 worker regions written from one seeded generator with
    benchmarks/probe_pipeline.py's fleet-scale specs and schedule, folded
    round by round by a tree on `device`, the same tree with the numpy
    twins and the flat aggregator, each over the same regions."""
    import os
    import numpy as np
    from repro_torch.core import daemon as D, maps as M, shm as SH
    from repro_torch.core.treeagg import TreeAggregator
    specs = [M.MapSpec("fs_arr", M.MapKind.ARRAY, max_entries=128),
             M.MapSpec("fs_hash", M.MapKind.HASH, max_entries=256),
             M.MapSpec("fs_hist", M.MapKind.LOG2HIST)]
    per_kind = events // 3
    root = os.path.join(tmp, "scale")
    wids = [f"w{w:03d}" for w in range(n_workers)]
    regions = [SH.ShmRegion.create(root, specs, worker_id=w) for w in wids]
    states = [M.init_states_np(specs) for _ in wids]
    rng = np.random.default_rng(11)
    dev = TreeAggregator(root, fan_in=fan_in, depth=1, worker_ids=wids,
                         config=D.AggregatorConfig(device=device))
    host = TreeAggregator(mirror_root(root, os.path.join(tmp, "scale_np")),
                          fan_in=fan_in, depth=1, worker_ids=wids,
                          config=D.AggregatorConfig(device_fold=False))
    flat = D.Aggregator(mirror_root(root, os.path.join(tmp, "scale_flat")),
                        config=D.AggregatorConfig(device_fold=False))

    def apply_round():
        for st, region in zip(states, regions):
            np.add.at(st["fs_arr"]["values"], rng.integers(0, 128, per_kind),
                      1)
            M.n_hash_fetch_add_batch(
                st["fs_hash"], rng.integers(0, 64, per_kind).astype(np.int64),
                np.ones(per_kind, np.int64))
            np.add.at(st["fs_hist"]["bins"], rng.integers(0, 64, per_kind), 1)
            region.publish_device(st)
    ms = {"node": [], "root": [], "flat": [], "node_numpy": []}

    def timed(key, fn):
        t0 = time.perf_counter()
        fn()
        ms[key].append((time.perf_counter() - t0) * 1e3)
    for agg in (dev, host, flat):
        agg.poll_once()
    for r in range(rounds + 1):             # round 0 warms the folds
        apply_round()
        for na in dev.node_aggs:
            timed("node", na.poll_once)
        timed("root", dev.root_agg.poll_once)
        for na in host.node_aggs:
            timed("node_numpy", na.poll_once)
        host.root_agg.poll_once()
        timed("flat", flat.poll_once)
        if r == 0:
            for v in ms.values():
                v.clear()
    views = [view_states(a.root) for a in (dev.root_agg, host.root_agg,
                                           flat)]
    for what, v in (("numpy-fold tree", views[1]), ("flat", views[2])):
        bad = views_differ(views[0], v)
        if bad:
            fail(f"phase 10: the tree's {bad} differ from the {what} view")
    med = {k: _pct(v, 0.5) for k, v in ms.items()}
    per_round = n_workers * 3 * per_kind
    eps = per_round / (max(med["node"], med["root"]) / 1e3)
    print(f"  {n_workers} workers x {3 * per_kind} events x {rounds} rounds: "
          f"median ms per node cycle {med['node']:.2f} (numpy fold "
          f"{med['node_numpy']:.2f}), root {med['root']:.2f}, flat "
          f"{med['flat']:.2f}; slowest tree stage "
          f"{eps:.0f} events/s, flat {per_round / (med['flat'] / 1e3):.0f}; "
          "tree = numpy-fold tree = flat, bit for bit", flush=True)
    return {"workers": n_workers, "fan_in": fan_in, "rounds": rounds,
            "events_per_round": per_round,
            **{f"{k}_cycle_ms_median": v for k, v in med.items()},
            "tree_events_per_s_slowest_stage": eps,
            "flat_events_per_s": per_round / (med["flat"] / 1e3)}


def fuzz_on_card(ops, device="cuda", seeds=100, budget_s=30.0):
    """(c): the port's fuzz harness over seeds 0-99 (and more seeds while
    less than `budget_s` has passed) at 6 events, every lane on `device`,
    and every corpus case."""
    from collections import Counter
    from repro_torch.core import fuzz as F
    t0 = time.perf_counter()
    ops.reset_launch_counts()
    lanes, cases, accepted, seed = Counter(), 0, 0, 0
    while seed < seeds or time.perf_counter() - t0 < budget_s:
        r = F.run_case(F.generate_case(seed, events=6), device)
        if r.diverged:
            fail(f"phase 10: fuzz seed {seed}: "
                 f"{r.crashed or '; '.join(r.mismatches[:3])}")
        cases += 1
        accepted += r.accepted
        lanes.update(r.lanes)
        seed += 1
    corpus = sorted((ROOT / "tests" / "corpus").glob("*.json"))
    for p in corpus:
        d = json.loads(p.read_text())
        r = F.run_case(F.FuzzCase.from_json(d), device)
        if not r.accepted or r.diverged or r.lanes != d["lanes"]:
            fail(f"phase 10: corpus {p.name}: lanes {r.lanes} (pinned "
                 f"{d['lanes']}), {r.rejected or r.crashed or r.mismatches}")
        lanes.update(r.lanes)
    secs = time.perf_counter() - t0
    launches = ops.launch_counts()
    print(f"  fuzz seeds 0-{seed - 1}: {cases} cases, {accepted} accepted, "
          f"no mismatch; corpus {len(corpus)} replayed; lanes "
          f"{json.dumps(dict(sorted(lanes.items())))}; interpreter launches "
          f"{launches['table_interp']}; {secs:.1f} s "
          f"({secs / (cases + len(corpus)):.3f} s a case)", flush=True)
    return {"seeds": [0, seed - 1], "cases": cases, "accepted": accepted,
            "corpus": len(corpus), "lanes": dict(lanes), "seconds": secs,
            "s_per_case": secs / (cases + len(corpus)), "launches": launches}


def card_line() -> str:
    """The card's name and power limit as nvidia-smi prints them."""
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    return smi.stdout.strip().splitlines()[0]


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    kernels_only = "--kernels" in argv
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("CUDA is not available: this script needs one GPU")
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        fail(f"the port's sources are not beside this script ({SRC})")
    sys.path.insert(0, str(SRC))
    sys.modules.setdefault("jax", None)       # the port must not need JAX
    sys.modules.setdefault("repro", None)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    from repro_torch.configs import registry
    from repro_torch.core import maps as M
    from repro_torch.kernels import (build, flash_attention as FA,
                                     hash_update as HU, interp_cases as IC,
                                     ops, ref, ringbuf_emit as RB,
                                     table_interp as TI, tensor_stats as TS)

    name = torch.cuda.get_device_name(0)
    print(f"device: {name}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)",
          flush=True)
    cfg = registry.get("qwen2-0.5b")
    # ---- phase 1
    t = build.build_all()
    print(f"phase 1: built {', '.join(build.SOURCES)} in {t:.1f} s",
          flush=True)
    for lib_name, log in build.BUILD_LOG.items():
        for line in log.splitlines():
            if "error" in line.lower() or "warning" in line.lower():
                print(f"  {lib_name}: {line.strip()}")
    sm90_build = check_build(build)
    probe_build = probe_build_report(build, HU, TI, IC, cfg)

    # ---- phase 2
    L2 = 2 * cfg.num_layers + 1            # rows per probed decode step
    d, pv = cfg.d_model, cfg.padded_vocab
    bf16, f32 = torch.bfloat16, torch.float32
    print("phase 2: kernels against their plain versions", flush=True)
    ts_err, ts_rows = check_tensor_stats(torch, TS, ref, ref.to_fx, [
        ((4, 1, d), bf16, False), ((4, 1, d), bf16, True),
        ((4, 1, pv), f32, True), ((2, 4096, d), bf16, True),
        ((1 << 26,), f32, True), ((1,), f32, False)])
    tomb = dict(tombstones=True, full=False)
    hash_rows = check_hash(torch, HU, ref, M, [
        ("path", 256, L2, dict(tombstones=False, full=False)),
        ("tombstones", 256, 4096, tomb),
        ("full", 256, 4096, dict(tombstones=False, full=True)),
        ("global path", 16384, L2, tomb),
        ("global 4096", 16384, 4096, tomb),
    ])
    rb_rows = check_ringbuf(torch, RB, ref, [
        ("path", 64, L2, 4), ("B<cap", 64, 40, 4), ("B>cap", 64, 4096, 4),
        ("empty", 64, 0, 4),
    ])
    rb_rows[0]["apply_device_ops"] = ringbuf_apply_ops(torch, RB, L2)
    corpus = [(p.stem, json.loads(p.read_text()))
              for p in sorted((ROOT / "tests" / "corpus").glob("*.json"))]
    interp_rows = check_interp(torch, ops, IC, corpus)
    _, fa_fwd, fa_bwd = check_flash(torch, FA, ref)
    if kernels_only:
        print(json.dumps({"tensor_stats": ts_rows, "hash": hash_rows,
                          "ringbuf": rb_rows, "interp": interp_rows,
                          "flash_fwd": fa_fwd,
                          "flash_bwd": fa_bwd, "flash_sm90": sm90_build,
                          "probe_build": probe_build}))
        print(json.dumps({"ok": True, "kernels_only": True}))
        return

    # ---- phase 3
    print("phase 3: serve qwen2-0.5b at full width on the card", flush=True)
    engine, reqs = serve(torch, cfg, "cuda")
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    engine.submit_all(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    served = [r for r in reqs if not r.rejected]
    tokens = sum(len(r.out) for r in served)
    print(f"  served {len(served)}, rejected {len(reqs) - len(served)}, "
          f"decode steps {engine.step_count}, {tokens} tokens in "
          f"{wall:.2f} s = {tokens / wall:.1f} tokens/s (prefill included)",
          flush=True)
    print(f"  kernels {json.dumps(launches)}; events collected "
          f"{engine.events}", flush=True)
    summary = maps_summary(engine.maps, cfg.num_layers)
    print(f"  maps {json.dumps(summary)}", flush=True)
    if not served or len(served) == len(reqs):
        fail("the admission filter should admit some requests and reject "
             "others")
    if any(len(r.out) != 8 for r in served):
        fail("a served request did not get max_new tokens")
    if any(not 0 <= t < cfg.vocab_size for r in served for t in r.out):
        fail("a generated token lies outside the vocabulary")
    serving_kernels = ("tensor_stats", "hash_fetch_add_batch",
                       "ringbuf_emit_batch")
    if any(launches[k] == 0 for k in serving_kernels):
        fail(f"a kernel was not launched on the serving path: {launches}")
    if launches["tensor_stats"] != engine.events:
        fail(f"tensor_stats launches {launches['tensor_stats']} != events "
             f"collected {engine.events}")
    if engine.events != engine.step_count * L2:
        fail(f"events {engine.events} != steps x {L2}")
    if summary["layer_counts"] != [engine.step_count] * cfg.num_layers:
        fail("the ARRAY layer counters do not count one per layer per step")
    if summary["hash_total"] != engine.step_count * cfg.num_layers:
        fail("the HASH layer counters do not add up")
    if summary["ringbuf_head"] != engine.step_count:
        fail("the ringbuf did not get one logits record per step")

    from repro_torch.models import registry as MR
    x = MR.prefill_fn(engine.params,
                      {"tokens": torch.tensor([reqs[0].prompt],
                                              device="cuda")},
                      MR.make_cache(cfg, 1, 128, torch.float32, "cuda"),
                      cfg)[0]
    if tuple(x.shape) != (1, len(reqs[0].prompt), cfg.padded_vocab) or \
            not bool(torch.isfinite(x).all()):
        fail(f"prefill logits: shape {tuple(x.shape)} or not finite")

    # small input: the smoke-width model on the card and on the CPU
    small = registry.smoke("qwen2-0.5b")
    e_gpu, r_gpu = serve(torch, small, "cuda")
    e_gpu.submit_all(r_gpu)
    params_cpu = to_cpu(e_gpu.params)
    e_cpu, r_cpu = serve(torch, small, "cpu", params_cpu)
    e_cpu.submit_all(r_cpu)
    same = sum(a.out == b.out for a, b in zip(r_gpu, r_cpu))
    if [r.rejected for r in r_gpu] != [r.rejected for r in r_cpu]:
        fail("smoke model: admission differs between card and CPU")
    g, c = (maps_summary(e.maps, small.num_layers) for e in (e_gpu, e_cpu))
    for k in ("layer_counts", "hash_items", "hash_total", "ringbuf_head"):
        if g[k] != c[k]:
            fail(f"smoke model: {k} differs between card and CPU: "
                 f"{g[k]} vs {c[k]}")
    pg = MR.prefill_fn(e_gpu.params, {"tokens": torch.tensor(
        [r_gpu[0].prompt], device="cuda")}, MR.make_cache(
            small, 1, 128, torch.float32, "cuda"), small)[0].cpu()
    pc = MR.prefill_fn(params_cpu, {"tokens": torch.tensor(
        [r_gpu[0].prompt])}, MR.make_cache(small, 1, 128, torch.float32,
                                           "cpu"), small)[0]
    err = float((pg - pc).abs().max())
    if not err <= 1e-4 + 1e-4 * float(pc.abs().max()):
        fail(f"smoke model: card and CPU logits differ by {err}")
    print(f"  smoke model card vs CPU: logits max abs diff {err:.2e}, "
          f"{same}/{len(r_gpu)} requests with identical tokens, map "
          "counters equal", flush=True)

    # ---- phase 4
    print("phase 4: replay the last decode tape in every mode", flush=True)
    from repro_torch.core import jit as J
    from repro_torch.core.runtime import to_numpy
    rows, maps_in, step = engine.last_tape
    results = {}
    for mode in ("fused", "scan", "vectorized"):
        out, _ = engine.runtime.probe_stage(
            rows, maps_in, J.make_aux(time_ns=step, device="cuda"),
            mode=mode)
        results[mode] = to_numpy(out)
    final = to_numpy(engine.maps)
    for mode, st in results.items():
        for mname in final:
            for f in final[mname]:
                if not (st[mname][f] == final[mname][f]).all():
                    fail(f"{mode} replay: {mname}.{f} differs from the "
                         "fused lane")
    print(f"  tape of {rows.shape[0]} events: scan, vectorized and fused "
          "map states bit-identical", flush=True)

    # ---- phase 5
    print("phase 5: warm serving time, with and without probes, and where "
          "the device time goes", flush=True)
    times = timing(torch, cfg, engine.params)
    engine_steps, engine_events = engine.step_count, engine.events

    # ---- phase 6
    print("phase 6: the live lane while qwen2-0.5b serves at full width: "
          "three programs hot-attached to the running decode step, one "
          "detached, one promoted", flush=True)
    live = live_serve(torch, ops, cfg, engine.params)
    tape = next((rows, aux) for k, rows, _, aux, *_ in live.pop("steps")
                if k == 2)
    live.update(live_timing(torch, cfg, engine.params, tape))
    from repro_torch.optim import tree_leaves
    serve_params = engine.params              # phase 9 serves them again
    n_params = sum(p.numel() for p in tree_leaves(serve_params))
    del engine, x, tape
    gc.collect()          # links and runtimes refer to each other
    torch.cuda.empty_cache()

    # ---- phase 7
    print("phase 7: train qwen2-0.5b at full width, seq 4096, batch 4 in "
          "microbatches of 2, remat, 3 steps", flush=True)
    train, state, rt = train_full(torch, ops, cfg)
    train["profiled_step"] = train_profile(torch, cfg, state, rt)
    del state
    torch.cuda.empty_cache()
    train["unprobed"] = train_unprobed(torch, cfg)
    torch.cuda.empty_cache()

    # ---- phase 8
    print("phase 8: one smoke-width training step at seq 4096, card vs CPU",
          flush=True)
    train["smoke_card_vs_cpu"] = train_compare(torch, small)

    # ---- phase 9
    print("phase 9: the fleet worker and durable training: serving as shm "
          "worker w0 with a program attached and detached through the "
          "control queue; an int8-compressed training step; run_training "
          "with checkpoints, restored and stepped again", flush=True)
    import shutil
    t9 = time.perf_counter()
    # two checkpoints of f32 parameters and both AdamW moments, plus 2 GB
    tmp = scratch_dir(2 * 12 * n_params + (2 << 30))
    try:
        fleet = fleet_serve(torch, ops, cfg, serve_params, tmp)
        fleet.update(shm_timing(torch, cfg, serve_params, tmp))
        del serve_params
        gc.collect()
        torch.cuda.empty_cache()
        for key, fn in (("int8", lambda: int8_step(torch, cfg)),
                        ("ckpt", lambda: ckpt_train(torch, cfg, tmp))):
            torch.cuda.synchronize()
            ops.reset_launch_counts()
            fleet[key] = fn()
            torch.cuda.synchronize()
            fleet[key]["launches"] = ops.launch_counts()
            if any(v == 0 for k, v in fleet[key]["launches"].items()
                   if k != "table_interp"):
                fail(f"phase 9: a kernel was not launched on the {key} "
                     f"path: {fleet[key]['launches']}")
            gc.collect()
            torch.cuda.empty_cache()
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    fleet["phase_s"] = time.perf_counter() - t9
    print(f"  phase 9 took {fleet['phase_s']:.1f} s", flush=True)
    p9 = {k: sum(fleet[part]["launches"][k]
                 for part in ("int8", "ckpt")) + fleet["launches"][k]
          for k in fleet["launches"]}

    # ---- phase 10
    print("phase 10: the fleet aggregator and the grammar fuzzer: four "
          "serving workers folded by a tree on the card, the daemon CLI's "
          "attach and detach; 64 worker regions, tree against flat; the "
          "fuzz harness's lanes on the card", flush=True)
    t10 = time.perf_counter()
    tmp = scratch_dir(1 << 30, "phase 10")
    try:
        aggregator = fleet_tree(torch, ops, cfg, tmp)
        gc.collect()
        torch.cuda.empty_cache()
        print("  (b) 64 worker regions folded by a tree of fan-in 8",
              flush=True)
        aggregator["scale"] = fleet_scale(tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    fuzz = fuzz_on_card(ops)
    aggregator["phase_s"] = time.perf_counter() - t10
    print(f"  phase 10 took {aggregator['phase_s']:.1f} s", flush=True)
    p10 = {k: aggregator["launches"][k] + fuzz["launches"][k]
           for k in aggregator["launches"]}

    # ---- report
    def pick(rows_, key, val):
        return next(r for r in rows_ if r[key] == val)

    hs_main = pick(hash_rows, "case", "path")
    rb_main = pick(rb_rows, "case", "path")
    in_main = pick(interp_rows, "case", "mixed 49")
    tl = train["launches"]

    def entry(name, source, replaces, launch_count, err, row, shapes):
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{source}",
                "replaces": replaces, "launches": launch_count,
                "max_abs_err": err, "ms": row["ms"],
                "host_us": row.get("host_us"),
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"],
                "library_ms": row.get("library_ms"),
                "library_is": row.get("library_is"),
                "phase9_launches": p9[name], "phase10_launches": p10[name],
                "shapes": shapes}

    report = {"kernels": [
        entry("tensor_stats", "tensor_stats.cu",
              "src/repro/kernels/tensor_stats.py:25", launches["tensor_stats"],
              ts_err, ts_rows[0], ts_rows),
        entry("hash_fetch_add_batch", "hash_update.cu",
              "src/repro/kernels/hash_update.py:24",
              launches["hash_fetch_add_batch"], 0, hs_main, hash_rows),
        entry("ringbuf_emit_batch", "ringbuf_emit.cu",
              "src/repro/kernels/ringbuf_emit.py:17",
              launches["ringbuf_emit_batch"], 0, rb_main, rb_rows),
        entry("table_interp", "table_interp.cu",
              "none: src/repro/core/table_interp.py:88 _build_core and :573 "
              "_build_batched_core are jnp/lax", live["launches"]
              ["table_interp"], 0, in_main, interp_rows),
        entry("flash_fwd", "flash_attention_sm90.cuh",
              "src/repro/kernels/flash_attention.py:35", tl["flash_fwd"],
              fa_fwd["max_abs_err"], fa_fwd, [fa_fwd]),
        entry("flash_bwd", "flash_attention_sm90.cuh",
              "src/repro/kernels/flash_attention.py:130", tl["flash_bwd"],
              fa_bwd["max_abs_err"], fa_bwd, [fa_bwd]),
    ], "serve": {"served": len(served), "rejected": len(reqs) - len(served),
                 "decode_steps": engine_steps,
                 "tokens_per_s": tokens / wall, "events": engine_events,
                 **times},
        "live": live,
        "train": train, "fleet": fleet, "aggregator": aggregator,
        "fuzz": fuzz, "train_launches_of_serving_kernels": {
            k: tl[k] for k in serving_kernels},
        "flash_sm90_build": sm90_build, "probe_build": probe_build}
    print(json.dumps(report), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
