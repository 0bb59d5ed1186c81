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
     norm, updated parameters and maps compared.

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
          max_seq=128, max_new=8, admit_limit=12, probes=True):
    """An engine and its requests. probes=False attaches no device probe;
    the admission filter (a host-side syscall program) stays, so the same
    requests are served."""
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
                         runtime=rt, device=device)
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
    with the most device time."""
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
    engine, reqs = serve(torch, cfg, "cuda", params)
    torch.cuda.synchronize()
    pwall, by_group, probe, ops = profiled(
        torch, lambda: engine.submit_all(reqs), PROBE_GROUPS,
        "probe kernels")
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
                "library_is": row.get("library_is"), "shapes": shapes}

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
        "train": train, "train_launches_of_serving_kernels": {
            k: tl[k] for k in serving_kernels},
        "flash_sm90_build": sm90_build, "probe_build": probe_build}
    print(json.dumps(report), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
