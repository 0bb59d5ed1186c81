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
     harness over seeds 0-99 and more within 8 s, every lane on the
     card, and every tests/corpus case: no mismatch; cases, lanes by
     kind, interpreter launches, seconds;
 11. the MoE, SSM and hybrid families, each model freed before the next:
     (a) llama4-scout-17b-a16e at full width cut to 4 of its 48 layers
     (16 experts top-1 and a shared expert in every layer; 10.9 B f32
     parameters drawn on the card, bf16 compute) served as phase 3 with
     SERVE_PROBES and MOE_PROBES (17 events a decode step). Fails unless
     the three serving kernels launched, tensor_stats once per event, the
     last tape's scan and vectorized replays equal the fused lane, the
     moe.load histogram holds one load per MoE layer per step, and the
     route's integer half (top-k, sort, positions, keep, drops) of one
     decode step's gates and of a 4096-token Zipf batch's (which must
     drop) is the same on the card and on CPU copies. Prints warm ms per
     decode step probed and unprobed, the device busy share, device ms in
     route, experts, combine and router_probes and in dtype casts, and
     peak memory. (b) mamba2-780m whole (48 layers, 145 events a step)
     served and checked as (a) with SSM_PROBES, then a 4096-token prefill
     at batch 1 (16 chunks): host and device ms and the chunk loop's
     share. (c) llama4-scout, mamba2 and jamba at smoke width (f32, TF32
     off) on the card and on the CPU from the same weights, even prompts:
     tokens, maps (bit for bit; the ring buffer's stat lanes within
     2e-5) and prefill logits (1e-4);
 12. the encoder-decoder and VLM families, each model freed before the
     next: (a) seamless-m4t-medium whole (12 + 12 layers, D 1024, 16 heads
     of 64, vocab 256,206; 0.98 B f32 parameters drawn on the card, bf16
     compute): 4 requests of 4096 frame embeddings and 16 tokens, one
     probed prefill through serve/steps.make_prefill_step with
     ENCDEC_PROBES (enc.in and 12 enc.block events; the encoder's
     non-causal self-attention is the bf16 flash forward kernel, 12
     launches) and 16 probed decode steps (one decode.logits event each)
     from its cache (f32, max_seq 128, enc_seq 4096). Fails unless the
     serving kernels launched, tensor_stats once per event, the maps
     count as they should, the prefill's and the last decode step's tapes
     replay bit for bit in every mode, and the kernel at the encoder's
     shape is within TOL_BF16_O/TOL_LSE of its plain version. Prints
     prefill ms (host, CUDA events), the encoder's device ms and the flash
     kernels' share, decode ms a step probed and not, the device busy
     share, casts, peak memory, and the kernel's us beside SDPA and the
     bound. (b) qwen2-vl-72b at full width cut to 4 of 80 layers (64/8
     heads of 128, M-RoPE 16/24/24, qkv bias; 6.0 B parameters): (i)
     phase 3's serving, text-only, with SERVE_PROBES, checked and timed as
     phase 11 (a); (ii) one request of a 32 x 32 patch grid and 3072
     tokens with M-RoPE grid ids through registry.prefill_fn (4 flash
     launches, causal, hd 128) and 8 probed decode steps, checked and
     replayed; the kernel at (BH 64, BKH 8, S 4096, hd 128) against its
     plain version, SDPA and the bound. (c) seamless (4096 frames: the f32
     flash kernel non-causal in the model) and qwen2-vl (served, and a
     multimodal request with grid ids) at smoke width, f32, TF32 off, on
     the card and on the CPU from the same weights: tokens equal, maps bit
     for bit but the ring buffers' stat lanes (within 1 of 2^16),
     prefill logits within 1e-4 relative;
 13. the MoE, SSM, encoder-decoder and VLM families trained at the
     reference's presets (launch/presets.py), seq 4096, 3 steps,
     TRAIN_PROBES on the fused lane (seamless's layer counters on
     uretprobe:enc.block and :dec.block, the family's layer exits), each
     model freed before the next: (e) first, the bf16 flash forward and
     then the backward from it at each training path's shape against
     ref.flash_fwd and ref.flash_bwd, bit for bit on a rerun, timed beside
     the plain versions, SDPA's and the bounds; (a) mamba2-780m
     whole through run_training (AdamW, f32, batch 4); (b) seamless-m4t-
     medium whole through run_training (AdamW, f32, batch 2: 4096 frames
     and 4096 tokens a row); (c) qwen2-vl-72b at full width cut to 1 layer
     (Adafactor, bf16 parameters, batch 2 in microbatches of 1, 1024 patch
     embeddings and 3072 tokens a row, step 2 with M-RoPE grid ids) and
     (d) llama4-scout at full width cut to 1 layer (Adafactor, bf16,
     batch 1), both through the functions run_training calls. Each fails
     unless every step ran unvetoed with finite loss and gradient norm,
     tensor_stats launched once per event, the events a step are the
     layers' a microbatch plus a loss a microbatch plus the gradient norm,
     the hash and ring-buffer kernels launched, the layer counters, loss
     ring and gradient-norm histogram count every event, the flash kernels
     launched twice and once a layer a microbatch, and the last tape
     replays bit for bit; prints tokens/s cold and warm, peak memory, and
     one profiled warm step (device busy, time by group, casts, the SSD or
     the MoE functions). (f) one step of llama4-scout, mamba2, seamless (at
     4096) and qwen2-vl (grid ids) at smoke width, f32, TF32 off, at each
     preset's optimizer, card against CPU as phase 8; llama4-scout's top-1
     router, whose gradient is zero in exact arithmetic, held to a
     gradient below 1e-8 and a move within Adafactor's bound;
 14. the examples' twins, the cached exported step and log2_histogram, in
     a temporary directory it deletes: (a) each of examples/torch/ with
     --device cuda (train_e2e for 20 steps, then --resume to 30): the
     single-process twins through main() in this process, tensor_stats
     launched once per collected event; fleet_agg and chaos_drill as
     subprocesses; each must exit 0 and print the lines its CPU test
     asserts; wall s of each. (b) phase 3's serving again, every probed
     decode tape recorded with the maps it started from and the eager
     fused lane's result; two spawned workers (the port alone) build phase
     3's runtime and boot its probe stage through aot_step on one fresh
     cache directory: the first must miss and store, the second hit; both
     run every tape, bit for bit the eager result, with one hash and one
     ring-buffer launch a call; export s, load ms, bytes stored, device
     and host us a call of the exported and the eager stage. Then a
     FaultPlan(corrupt_artifact=1.0) drill (detected, dropped, traced
     again, hit) and a scan-lane stage (run eagerly, unexportable 1,
     nothing stored). (c) log2_histogram of 64 Mi f32 with the special
     values, card against CPU bit for bit, and its device ms.
 15. distribution and tooling, with what phases 9 and 11 already hold (no
     model is built twice): (a) inside phase 11 (a), llama4-scout at full
     width (4 of 48 layers) under use_mesh(make_host_mesh((1, 1))), NCCL
     at world size 1, with REPRO_MOE_EP=1: a probed prefill and 8 probed
     decode steps (MOE_PROBES) and one 4096-token prefill at batch 1 (the
     flash forward at (40, 8, 4096, 128) causal), logits and every map
     state bit for bit the same steps with the switch off, one expert
     gather per MoE layer per step counted, ms per decode step and per
     prefill with the switch on and off; (b) inside phase 9 (c), step_1
     of qwen2-0.5b restored again onto a (1, 1) mesh with shardings from
     spec_for over the state tree: every leaf's full_tensor() bit for bit
     the plain restore, seconds for both; (c) the dry run of qwen2-0.5b x
     train_4k single-pod with --probes --probe-mode fused, in a
     subprocess with CUDA_VISIBLE_DEVICES="" started before phase 13 and
     read here: its roofline terms,
     dominant term and trace_s beside phase 7's measured step per 4096-
     token sequence (the dry run's per-card shape).

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
# the kernels every probed serving step launches
SERVING_KERNELS = ("tensor_stats", "hash_fetch_add_batch",
                   "ringbuf_emit_batch")


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


def route_host_us(torch, row, name, args, got, what):
    """Adds to `row` the host's us a call of the public wrapper
    `kernels.ops.<name>` (the eager route, which skips the dispatcher) and
    of the custom operator `torch.ops.repro_torch.<name>` (the route of an
    exported step); fails unless the operator gives `got` bit for bit with
    one launch of the kernel."""
    from repro_torch.kernels import ops
    op = getattr(torch.ops.repro_torch, name)
    torch.cuda.synchronize()
    before = ops.launch_counts()
    out = op(*args)
    torch.cuda.synchronize()
    kernel = "tensor_stats" if name == "tensor_stats_row" else name
    launched = ops.launch_counts()[kernel] - before[kernel]
    outs = out if isinstance(out, (tuple, list)) else (out,)
    gots = got if isinstance(got, (tuple, list)) else (got,)
    if launched != 1 or not all(torch.equal(a, b) for a, b in zip(outs, gots)):
        fail(f"{what}: the custom operator launched {launched} times or "
             "differs from the kernel's wrapper")
    row["wrapper_host_us"] = host_us(torch, lambda: getattr(ops, name)(*args),
                                     200)
    row["op_host_us"] = host_us(torch, lambda: op(*args), 200)


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
        route_host_us(torch, r, "tensor_stats_row", (x, 3, 1, 17), row, what)
        r["gb_per_s"] = nbytes / r["ms"] / 1e6
        r["share_of_bound"] = r["bound_ms"] / r["ms"]
        rows.append(r)
        print(f"  tensor_stats row {tuple(shape)} {r['dtype']} (grid "
              f"{r['grid']}): device {r['ms'] * 1e3:.2f} us a launch "
              f"({r['launches_per_call']:.0f} a call; back to back "
              f"{r['queued_ms'] * 1e3:.2f} us a call; {r['gb_per_s']:.1f} "
              f"GB/s, {100 * r['share_of_bound']:.1f} % of the bound), host "
              f"{r['host_us']:.1f} us a call (ops {r['wrapper_host_us']:.1f}"
              f", torch.ops {r['op_host_us']:.1f}), calls back-to-back on "
              f"the host {r['call_ms'] * 1e3:.2f} us, plain "
              f"{r['plain_ms']:.4f} ms, bound {r['bound_ms'] * 1e3:.4f} us "
              f"({r['bound_by']})", flush=True)
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
        route_host_us(torch, r, "hash_fetch_add_batch", dev, got,
                      f"hash {label}")
        rows.append(r)
        print(f"  hash {label} n={n} B={batch} ({route} route): device "
              f"{r['ms'] * 1e3:.2f} us a launch ({r['launches_per_call']:.0f}"
              f" a call; back to back {r['queued_ms'] * 1e3:.2f} us a call), "
              f"host {r['host_us']:.1f} us a call (ops "
              f"{r['wrapper_host_us']:.1f}, torch.ops {r['op_host_us']:.1f})"
              f", calls back-to-back on the "
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
        route_host_us(torch, r, "ringbuf_emit_batch", dev, got,
                      f"ringbuf {label}")
        rows.append(r)
        print(f"  ringbuf {label} cap={cap} B={batch} W={width}: device "
              f"{r['ms'] * 1e3:.2f} us a launch (back to back "
              f"{r['queued_ms'] * 1e3:.2f} us a call), host "
              f"{r['host_us']:.1f} us a call (ops {r['wrapper_host_us']:.1f}"
              f", torch.ops {r['op_host_us']:.1f}), calls back-to-back on "
              f"the host {r['call_ms'] * 1e3:.2f} us, plain "
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
    both are timed beside scaled_dot_product_attention (`flash_bwd_at`).
    Returns (max abs err at the path's shape, fwd row, bwd row)."""
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
    bwd_row, fwd_row = flash_bwd_at(torch, FA, ref, B * H, B * KH, S, hd,
                                    True, "phase 2 path shape", fwd=True,
                                    seed=7)
    return (max(fwd_row["max_abs_err"], bwd_row["max_abs_err"]), fwd_row,
            bwd_row)


# --------------------------------------------------------------------------
# phase 3: serving
# --------------------------------------------------------------------------

def serve(torch, cfg, device, params=None, *, requests=8, slots=4,
          max_seq=128, max_new=8, admit_limit=12, probes=True,
          shm_dir=None, worker_id=None):
    """An engine and its requests. probes=True attaches the family's
    serving probes (launch/serve.family_probes: SERVE_PROBES, plus the MoE
    and SSM programs where the model has such layers); probes=False
    attaches no device probe; the admission filter (a host-side syscall
    program) stays, so the same requests are served. shm_dir joins the shm
    plane as `worker_id`. Prompts are cut to whole SSD chunks
    (`whole_chunks`)."""
    from repro_torch.core.runtime import BpftimeRuntime
    from repro_torch.launch import serve as L
    from repro_torch.models import registry as MR
    from repro_torch.serve.engine import ServeEngine

    rt = BpftimeRuntime()
    pid = rt.load_asm("admit", L.admit_filter_text(admit_limit), [],
                      "filter")
    rt.attach(pid, "filter:sys_serve_admit")
    if probes:
        L.attach_serve_probes(rt, L.family_probes(cfg))
    if params is None:
        gen = torch.Generator(device=device)
        gen.manual_seed(SEED)
        params = MR.init_params(cfg, gen, device)
    engine = ServeEngine(params, cfg, slots=slots, max_seq=max_seq,
                         runtime=rt, shm_dir=shm_dir, worker_id=worker_id,
                         device=device)
    reqs = L.make_requests(requests, max_new, cfg.vocab_size, SEED)
    return engine, whole_chunks(cfg, reqs)


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


RANGE = "chip_smoke.range."


@contextlib.contextmanager
def ranged_fns(torch, fns):
    """Each function `getattr(module, name)` of fns {label: (module,
    name)} called inside a profiler range named RANGE + label while the
    block runs (callers look the name up in the module at each call)."""
    saved = {label: getattr(m, n) for label, (m, n) in fns.items()}

    def wrap(label, fn):
        def ranged(*args, **kwargs):
            with torch.profiler.record_function(RANGE + label):
                return fn(*args, **kwargs)
        return ranged
    for label, (m, n) in fns.items():
        setattr(m, n, wrap(label, saved[label]))
    try:
        yield
    finally:
        for label, (m, n) in fns.items():
            setattr(m, n, saved[label])


def range_times(prof, labels) -> dict:
    """Per label of `ranged_fns`: its calls, the host ms inside them and
    the device ms of the kernels they (and the operators under them)
    launched."""
    out = {k: {"calls": 0, "host_ms": 0.0, "device_ms": 0.0} for k in labels}

    def kernel_us(e):
        return sum(k.duration for k in e.kernels) + \
            sum(kernel_us(c) for c in e.cpu_children)
    for e in prof.events():
        if e.name.startswith(RANGE) and str(e.device_type).endswith("CPU"):
            o = out[e.name[len(RANGE):]]
            o["calls"] += 1
            o["host_ms"] += e.cpu_time_total / 1e3
            o["device_ms"] += kernel_us(e) / 1e3
    return out


def cast_device_ms(prof) -> float:
    """Device ms of every dtype conversion (aten::_to_copy, with the copy
    kernels under it) in a profile."""
    return sum(getattr(e, "device_time_total", 0.0) or
               getattr(e, "cuda_time_total", 0.0)
               for e in prof.key_averages()
               if e.key == "aten::_to_copy") / 1e3


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
            "other_by_name": names, "by_launch": launched_in_ranges(prof)}


def _activity(e) -> str:
    """A profiler event's kind, by device type and name: "device" for a
    kernel, copy or fill on the card, "launch" for a CUDA runtime or
    driver call (cudaLaunchKernel, cuLaunchKernel, ...), "range" for an
    emit range on the host, else "other" (the ranges' annotations on the
    card's timeline among them)."""
    name = e.name()
    if "cuda" in str(e.device_type()).lower():
        return "other" if name == EMIT_RANGE or name.startswith(RANGE) \
            else "device"
    if name == EMIT_RANGE:
        return "range"
    return "launch" if re.match(r"cu(da)?[A-Z]", name) else "other"


def launched_in_ranges(prof) -> dict:
    """The window's device operations (kernels, copies, fills) placed by
    the call that launched them, independently of the operator tree that
    collector_ops walks: each is matched by its correlation id to its CUDA
    runtime or driver call, and counted as the collector's when that call
    started inside an emit range on the host's clock. Returns the
    tensor_stats kernels and the other device operations launched inside
    a range (those by name), the device operations with no launch call
    in the profile, and whether every device operation has an id of its
    own; with "error" if the profile could not be read."""
    import bisect
    try:
        kev = [(e, _activity(e)) for e in
               prof.profiler.kineto_results.events()]
        spans = sorted((e.start_ns(), e.end_ns()) for e, k in kev
                       if k == "range")
        # a device operation's id is never 0; an event with id 0 (an
        # annotation on the card's timeline) is none
        calls = {e.correlation_id(): e.start_ns() for e, k in kev
                 if k == "launch" and e.correlation_id()}
        ids = [(e.name(), e.correlation_id()) for e, k in kev
               if k == "device" and e.correlation_id()]
    except Exception as exc:              # reported, never the check's pass
        return {"error": repr(exc)}
    starts = [a for a, _ in spans]
    stats, other, unmatched = 0, {}, 0
    for name, cid in ids:
        t = calls.get(cid)
        if t is None:
            unmatched += 1
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i < 0 or t > spans[i][1]:
            continue
        if "stats_" in name:
            stats += 1
        else:
            other[name[:60]] = other.get(name[:60], 0) + 1
    return {"ranges": len(spans), "stats_kernels": stats,
            "other_device_ops": sum(other.values()),
            "other_by_name": other, "unmatched": unmatched,
            "ids_distinct": len({cid for _, cid in ids}) == len(ids)}


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


def profiled(torch, fn, groups, detail, ranges=None):
    """fn() under torch.profiler, every collector event in a range: (wall
    s, device us by group, per-kernel device ms and count of the group
    `detail`, the collector's device operations, and -- with `ranges`,
    functions for `ranged_fns` -- their `range_times` and the casts' device
    ms). Prints the ten kernels with the most device time. fn must be
    repeatable: a window whose profile lacks some of the tensor_stats
    kernels the counter saw launched, and holds nothing else that is off,
    lost activity records, and is profiled once more; the check below
    holds that second window as it holds the first."""
    if ranges:
        plain = fn

        def fn():
            with ranged_fns(torch, ranges):
                plain()
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
        # a range's GPU-side annotation spans kernels counted already
        if not _is_device(e) or e.key == EMIT_RANGE or \
                e.key.startswith(RANGE):
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
    # placed by launch call, once that placement finds every tensor_stats
    # kernel the counter saw in an emit range; else linked by the operator
    # tree. The tree can link launches made outside every range to an
    # event (9 in a mamba2 step's window, a GEMM among them; why is not
    # known): those are counted in "mislinked" and fail nothing
    at = ops["by_launch"]
    placed = at.get("stats_kernels") == launched == ops["events"] and \
        at.get("ranges") == ops["events"] and at.get("ids_distinct")
    ops["counted_by"] = "launch call" if placed else "operator tree"
    other = at["other_device_ops"] if placed else ops["other_device_ops"]
    ops["mislinked"] = ops["other_device_ops"] - other if placed else None
    print(f"  collector by launch call: {json.dumps(at)}; counted by "
          f"{ops['counted_by']}: {other} other device operations"
          + (f", {ops['mislinked']} linked by the operator tree but "
             "launched outside every emit range" if ops["mislinked"]
             else ""), flush=True)
    if not ops["events"] or other or \
            ops["stats_kernels"] != ops["events"] or launched != ops["events"]:
        fail("the collector must make exactly one tensor_stats launch and "
             f"no other device operation per event: {ops}, {launched} "
             "launches by the counter")
    spans = {}
    if ranges:
        spans = {"ranges": range_times(prof, ranges),
                 "casts_device_ms": cast_device_ms(prof)}
        print(f"  device ms by function {json.dumps(spans)}", flush=True)
    return pwall, by_group, per, ops, spans


def replay_modes(engine, what):
    """The engine's last decode tape through the fused, scan and vectorized
    modes from the maps that step started from: each must end in the map
    state the engine holds, bit for bit."""
    replay_tape(engine.runtime, engine.last_tape, engine.maps, what)


def replay_tape(rt, tape, maps, what):
    """A step's tape (rows, maps_in, step) through the fused, scan and
    vectorized modes of `rt`: each must end in the map state `maps`."""
    from repro_torch.core import jit as J
    from repro_torch.core.runtime import to_numpy
    rows, maps_in, step = tape
    final = to_numpy(maps)
    for mode in ("fused", "scan", "vectorized"):
        out, _ = rt.probe_stage(
            rows, maps_in, J.make_aux(time_ns=step, device=rows.device),
            mode=mode)
        st = to_numpy(out)
        for mname in final:
            for f in final[mname]:
                if not (st[mname][f] == final[mname][f]).all():
                    fail(f"{what}: the {mode} replay's {mname}.{f} differs "
                         "from the fused lane's")
    print(f"  last tape of {rows.shape[0]} events: scan, vectorized and "
          "fused map states bit-identical", flush=True)


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


def timing(torch, cfg, params, ranges=None):
    """After one untimed pass, warm serving passes with the probes and with
    no device probe, in turns (host clock), then a profiled one: device
    busy share, device time by kernel group, device operations per
    collected event (and the device time of `ranges`, see `profiled`).
    Kernel launches here are not counted toward the phase's path."""
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
    pwall, by_group, probe, ops, spans = profiled(
        torch, lambda: engine.submit_all(whole_chunks(cfg, L.make_requests(
            8, 8, cfg.vocab_size, SEED))), PROBE_GROUPS, "probe kernels",
        ranges)
    busy = sum(by_group.values())
    return {"warm_tokens_per_s": out["probed"]["tokens_per_s"][0],
            "profiled_decode_steps": engine.step_count, **spans,
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

def block_targets(cfg=None) -> list[str]:
    """Where TRAIN_PROBES' layer counters attach: uprobe:block, which every
    decoder layer fires (launch/train.attach_train_probes); the
    encoder-decoder family fires no such site, so for it its layers'
    exits, uretprobe:enc.block and uretprobe:dec.block."""
    if cfg is not None and cfg.family == "encdec":
        return ["uretprobe:enc.block", "uretprobe:dec.block"]
    return ["uprobe:block"]


def attach_train_probes(rt, cfg=None):
    """launch/train.TRAIN_PROBES into `rt` on the fused lane, as
    launch/train.attach_train_probes loads them, with the layer counters
    at block_targets(cfg)."""
    from repro_torch.core.maps import MapKind, MapSpec
    from repro_torch.launch import train as T
    for name, text, spec, ptype, target in T.TRAIN_PROBES:
        maps = [] if spec is None else [
            MapSpec(spec[0], MapKind(spec[1]), spec[2], rec_width=spec[3])]
        pid = rt.load_asm(name, text, maps, ptype)
        for tgt in block_targets(cfg) if target == "uprobe:block" \
                else [target]:
            rt.attach(pid, tgt, mode="fused")


def _train_runtime(probes=True, cfg=None, tape=None):
    """A runtime with launch/train.TRAIN_PROBES (the layer counters where
    `cfg`'s family fires them) whose probe stage counts the rows
    of every call and whose poll_control stamps the top of every step. With
    a dict `tape`, tape["last"] is the last stage's (rows, a copy of the
    maps it started from, the step), for `replay_tape`."""
    from repro_torch.core.runtime import BpftimeRuntime
    rt = BpftimeRuntime()
    if probes:
        attach_train_probes(rt, cfg)
    events = []
    stage = rt.probe_stage

    def counting_stage(rows, maps, aux, mode=None):
        events.append(int(rows.shape[0]))
        if tape is not None:
            tape["last"] = (rows, {n: {f: a.clone() for f, a in st.items()}
                                   for n, st in maps.items()},
                            aux["time_ns"].clone())
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
    pwall, by_group, flash, col, _ = profiled(
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
    """Phase 8: one training step of the smoke-width model on the card and
    on the CPU, from the same weights, batch and probes
    (`step_card_vs_cpu`)."""
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.data.pipeline import SyntheticDataset
    tcfg = TrainConfig(warmup=0, total_steps=10)
    batch_np = SyntheticDataset(small, ShapeConfig("cmp", seq, batch,
                                                   "train"), tcfg,
                                seed=SEED).next()
    return step_card_vs_cpu(torch, small, tcfg, batch_np,
                            f"smoke {small.name} (f32) seq {seq} batch "
                            f"{batch}")


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
    elastic = elastic_restore(torch, ck, fresh, restored, restore_s, device)
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
            "not_bitwise": diff, "losses": [h["loss"] for h in hist],
            "phase15": elastic}


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


def fuzz_on_card(ops, device="cuda", seeds=100, budget_s=8.0):
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


# --------------------------------------------------------------------------
# phase 11: the MoE, SSM and hybrid families
# --------------------------------------------------------------------------

LLAMA4 = "llama4-scout-17b-a16e"
MAMBA2 = "mamba2-780m"
JAMBA = "jamba-v0.1-52b"
# llama4-scout cut to 4 of its 48 layers: 10.9 B parameters, 43.5 GB in
# f32 (the whole model's 109 B do not fit one card)
LLAMA4_LAYERS = 4
ROUTE_TOKENS = 4096
LONG_PREFILL = 4096
# phase 15 (a): llama4-scout's expert-parallel decode, 4 prompts of 16
# tokens then 8 probed decode steps, each switch setting timed twice
EP_BATCH, EP_PROMPT, EP_STEPS = 4, 16, 8
# smoke width card vs CPU (f32, TF32 off): logits as phase 3's
FAMILY_LOGIT_TOL = 1e-4


def events_per_step(cfg) -> int:
    """Rows a decode step collects for the family's serving probes: block
    entry and exit on every layer, ssm.out on a mamba layer, moe.load and
    moe.drops on a MoE layer, and the logits."""
    per_super = sum(2 + (cfg.block_kind(j) == "mamba")
                    + 2 * (cfg.ffn_kind(j) == "moe")
                    for j in range(cfg.superblock))
    return per_super * cfg.num_layers // cfg.superblock + 1


def layers_of(cfg, pred) -> int:
    return sum(pred(j) for j in range(cfg.superblock)) * \
        cfg.num_layers // cfg.superblock


def whole_chunks(cfg, reqs):
    """Each prompt cut to whole SSD chunks where the model has mamba
    layers: the reference's prefill takes a length S only as a multiple of
    min(ssm_chunk, S) (ROADMAP, limits). The smoke configs' chunk is 2, so
    their prompts become even; at chunk 256 these prompts stay whole."""
    if any(cfg.block_kind(j) == "mamba" for j in range(cfg.superblock)):
        for r in reqs:
            chunk = min(cfg.ssm_chunk, len(r.prompt))
            del r.prompt[len(r.prompt) // chunk * chunk:]
    return reqs


def family_serve(torch, ops, cfg, params, what, device="cuda"):
    """Phase 3's serving (8 requests, the filter at 12, 4 slots) of `cfg`
    with its family's probes, the counts set to 0 just before and read just
    after; phase 3's checks, the MoE histogram's, and phase 4's replays."""
    from repro_torch.core.runtime import to_numpy
    engine, reqs = serve(torch, cfg, device, params)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    engine.submit_all(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    served = [r for r in reqs if not r.rejected]
    steps = engine.step_count
    maps = to_numpy(engine.maps)
    print(f"  {what}: served {len(served)}, rejected "
          f"{len(reqs) - len(served)}, {steps} decode steps in {wall:.2f} s "
          f"(prefill included), {engine.events} events; kernels "
          f"{json.dumps(launches)}", flush=True)
    if not served or len(served) == len(reqs):
        fail(f"{what}: the admission filter should admit some requests and "
             "reject others")
    if any(len(r.out) != 8 for r in served):
        fail(f"{what}: a served request did not get max_new tokens")
    if any(not 0 <= t < cfg.vocab_size for r in served for t in r.out):
        fail(f"{what}: a generated token lies outside the vocabulary")
    if any(launches[k] == 0 for k in SERVING_KERNELS):
        fail(f"{what}: a serving kernel was not launched: {launches}")
    if launches["tensor_stats"] != engine.events:
        fail(f"{what}: tensor_stats launches {launches['tensor_stats']} != "
             f"events collected {engine.events}")
    if engine.events != steps * events_per_step(cfg):
        fail(f"{what}: events {engine.events} != {steps} steps x "
             f"{events_per_step(cfg)}")
    if maps["sv_logits_rb"]["head"][0] != steps:
        fail(f"{what}: the ringbuf did not get one logits record per step")
    out = {"served": len(served), "rejected": len(reqs) - len(served),
           "decode_steps": steps, "events": engine.events,
           "events_per_step": events_per_step(cfg), "wall_s": wall,
           "launches": launches}
    n_moe = layers_of(cfg, lambda j: cfg.ffn_kind(j) == "moe")
    if n_moe:
        bins = int(maps["load_hist"]["bins"].sum())
        if bins != n_moe * steps:
            fail(f"{what}: the moe.load histogram holds {bins} loads, not "
                 f"{n_moe} MoE layers x {steps} probed steps")
        out["moe_load_hist"] = {int(i): int(maps["load_hist"]["bins"][i])
                                for i in maps["load_hist"]["bins"]
                                .nonzero()[0]}
        out["moe_drops"] = int(maps["total_drops"]["values"][0])
    n_ssm = layers_of(cfg, lambda j: cfg.block_kind(j) == "mamba")
    if n_ssm and int(maps["ssm_rms_hist"]["bins"].sum()) != n_ssm * steps:
        fail(f"{what}: the ssm.out histogram does not hold one rms per "
             "mamba layer per step")
    replay_modes(engine, what)
    return engine, reqs, out


def route_card_vs_cpu(torch, cfg, gates, what):
    """The route's integer half (top-k, the stable sort, positions, keep
    and drops) of `gates` on the card and of their CPU copy: equal
    exactly."""
    from repro_torch.models import moe as MOE
    C = MOE.capacity(cfg, gates.shape[0])
    got = {}
    for dev, g in (("card", gates), ("cpu", gates.cpu())):
        gvals, gids = MOE.top_k(g, cfg.experts_per_token)
        sort_idx, sorted_eids, pos_c, keep = MOE.dispatch_plan(gids, C)
        got[dev] = {"gvals": gvals, "gids": gids, "sort_idx": sort_idx,
                    "sorted_eids": sorted_eids, "pos_c": pos_c,
                    "keep": keep}
    for k, v in got["cpu"].items():
        if not torch.equal(got["card"][k].cpu(), v):
            fail(f"{what}: the route's {k} differs between card and CPU")
    drops = int((~got["cpu"]["keep"]).sum())
    load = torch.bincount(got["cpu"]["gids"].reshape(-1),
                          minlength=cfg.num_experts)
    print(f"  {what}: {gates.shape[0]} tokens, capacity {C}: top-k, sort, "
          f"positions and keep equal on card and CPU; {drops} drops; "
          f"busiest expert {int(load.max())}", flush=True)
    return {"tokens": gates.shape[0], "capacity": C, "drops": drops,
            "max_load": int(load.max())}


def llama4_full(torch, ops, registry):
    """(a): llama4-scout at full width, 4 of its 48 layers, bf16 compute,
    f32 parameters drawn on the card from seed 0."""
    import dataclasses
    import numpy as np
    from repro_torch.core import events as E
    from repro_torch.models import layers as L, moe as MOE, registry as MR
    from repro_torch.optim import tree_leaves
    full = registry.get(LLAMA4)
    cfg = dataclasses.replace(full, num_layers=LLAMA4_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    t0 = time.perf_counter()
    params = MR.init_params(cfg, gen, "cuda")
    torch.cuda.synchronize()
    n = sum(p.numel() for p in tree_leaves(params))
    print(f"  (a) {LLAMA4}, {LLAMA4_LAYERS} of its {full.num_layers} layers "
          f"(the whole model's {full.param_counts()['total'] / 1e9:.1f} B "
          f"parameters do not fit one card): {n / 1e9:.2f} B parameters, "
          f"{4 * n / 1e9:.1f} GB in f32, drawn in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    # the router gates of the decode steps (the probed steps: a collector
    # is active), recorded as the engine computes them
    seen = []
    orig = MOE.gates_of

    def recorded(p, xt):
        g = orig(p, xt)
        if E.Collector.active() is not None:
            seen.append(g)
        return g
    MOE.gates_of = recorded
    try:
        engine, _, out = family_serve(torch, ops, cfg, params,
                                         "phase 11 (a)")
    finally:
        MOE.gates_of = orig
    out["peak_gb_serving"] = torch.cuda.max_memory_allocated() / 1e9
    decode_gates = seen[0]
    out["route_decode"] = route_card_vs_cpu(
        torch, cfg, decode_gates, "phase 11 (a) one decode step's route")
    # a 4096-token batch of Zipf-distributed token ids (as text is) through
    # layer 0's router: its capacity drops tokens
    rng = np.random.default_rng(SEED)
    toks = np.minimum(rng.zipf(1.2, ROUTE_TOKENS), cfg.vocab_size) - 1
    layer0 = {part: {k: v[0] for k, v in leaves.items()} for part, leaves
              in params["stack"]["blocks"][0].items()}
    x = L.embed(params["embed"], torch.as_tensor(toks, device="cuda"), cfg)
    gates = MOE.gates_of(layer0["moe"],
                         L.apply_norm(layer0["norm2"], x, cfg))
    out["route_4096"] = route_card_vs_cpu(torch, cfg, gates,
                                          "phase 11 (a) a 4096-token route")
    if out["route_4096"]["drops"] == 0:
        fail("phase 11 (a): the 4096-token route dropped nothing")
    del engine, seen, decode_gates, gates, x
    out["timing"] = timing(torch, cfg, params, ranges={
        f: (MOE, f) for f in ("route", "experts", "combine",
                              "router_probes")})
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"  (a) peak memory {out['peak_gb']:.1f} GB", flush=True)
    out["params_b"] = n / 1e9
    out["phase15"] = ep_on_card(torch, ops, cfg, params)
    return out


def long_prefill(torch, cfg, params, S=LONG_PREFILL):
    """A batch-1 prefill of S tokens (S / ssm_chunk chunks through the
    Python chunk loop): host ms (synchronised), device ms (CUDA events),
    and under torch.profiler the device busy ms and the chunk loop's and
    the SSD's device and host ms."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import registry as MR, ssm as SSM
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    toks = torch.randint(0, cfg.vocab_size, (1, S), generator=gen,
                         device="cuda")

    def run():
        return MR.prefill_fn(params, {"tokens": toks}, MR.make_cache(
            cfg, 1, S, torch.float32, "cuda"), cfg)[0]
    logits = run()
    torch.cuda.synchronize()
    if tuple(logits.shape) != (1, S, cfg.padded_vocab) or \
            not bool(torch.isfinite(logits).all()):
        fail(f"phase 11 (b): the {S}-token prefill's logits: shape "
             f"{tuple(logits.shape)} or not finite")
    del logits
    host = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    dev = cuda_ms(torch, run, reps=3, warmup=0)
    fns = {"chunk_scan": (SSM, "chunk_scan"),
           "ssd_chunked": (SSM, "ssd_chunked")}
    with ranged_fns(torch, fns), profile(
            activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run()
        torch.cuda.synchronize()
        pwall = (time.perf_counter() - t0) * 1e3
    busy = sum(_dev_us(e) for e in prof.key_averages()
               if _is_device(e) and not e.key.startswith(RANGE)) / 1e3
    spans = range_times(prof, fns)
    loop = spans["chunk_scan"]
    out = {"tokens": S, "chunks": S // min(cfg.ssm_chunk, S),
           "host_ms": host, "device_ms_events": dev,
           "profiled_wall_ms": pwall, "device_busy_ms": busy,
           "ranges": spans,
           "loop_device_share": loop["device_ms"] / busy,
           "loop_host_share": loop["host_ms"] / pwall}
    print(f"  (b) {S}-token prefill at batch 1 ({out['chunks']} chunks): "
          f"host {', '.join(f'{h:.1f}' for h in host)} ms, device "
          f"{dev:.1f} ms (CUDA events); profiled wall {pwall:.1f} ms, device "
          f"busy {busy:.1f} ms; the chunk loop {loop['device_ms']:.3f} ms of "
          f"device ({100 * out['loop_device_share']:.2f} %), "
          f"{loop['host_ms']:.2f} ms of host "
          f"({100 * out['loop_host_share']:.2f} %) in {loop['calls']} calls; "
          f"the SSD {spans['ssd_chunked']['device_ms']:.1f} ms of device",
          flush=True)
    return out


def mamba2_whole(torch, ops, registry):
    """(b): mamba2-780m at its published depth and width."""
    from repro_torch.models import registry as MR
    from repro_torch.optim import tree_leaves
    cfg = registry.get(MAMBA2)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    params = MR.init_params(cfg, gen, "cuda")
    n = sum(p.numel() for p in tree_leaves(params))
    print(f"  (b) {MAMBA2} whole: {cfg.num_layers} layers, "
          f"{n / 1e6:.0f} M parameters, {4 * n / 1e9:.2f} GB in f32",
          flush=True)
    engine, _, out = family_serve(torch, ops, cfg, params,
                                   "phase 11 (b)")
    del engine
    out["timing"] = timing(torch, cfg, params)
    out["long_prefill"] = long_prefill(torch, cfg, params)
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["params_m"] = n / 1e6
    print(f"  (b) peak memory {out['peak_gb']:.1f} GB", flush=True)
    return out


def families_card_vs_cpu(torch, ops, registry, device="cuda"):
    """(c): llama4-scout, mamba2 and jamba at smoke width (f32, TF32 off)
    served on the card and on the CPU from the same weights, prompts cut
    to even lengths: tokens equal, every map bit for bit (the logits ring
    buffer's two Q47.16 stat lanes within STATS_TOL), prefill logits
    within FAMILY_LOGIT_TOL."""
    from repro_torch.models import registry as MR
    out = {}
    for arch in (LLAMA4, MAMBA2, JAMBA):
        small = registry.smoke(arch)
        what = f"phase 11 (c) {arch} at smoke width"
        params, params_cpu, res = serve_card_vs_cpu(torch, ops, small, what,
                                                    device)
        prompt = res.pop("prompt")
        logits = [MR.prefill_fn(p, {"tokens": torch.tensor(
            [prompt], device=dev)}, MR.make_cache(
                small, 1, 128, torch.float32, dev), small)[0].cpu()
            for p, dev in ((params, device), (params_cpu, "cpu"))]
        err = logits_close(logits, what)
        print(f"  {what}: card and CPU tokens equal, maps bit for bit "
              f"(ringbuf stat lanes within {res['ringbuf_stat_max_diff']:.0f}"
              f" of 2^16), prefill logits within {err:.2e}", flush=True)
        out[arch] = {**res, "logits_max_abs_diff": err}
    return out


def serve_card_vs_cpu(torch, ops, small, what, device="cuda"):
    """Phase 3's serving of the smoke-width `small` on the card (counted,
    `family_serve`) and on the CPU from the same weights: admission and
    tokens equal, maps as `maps_card_vs_cpu` holds them. Returns (card
    params, CPU params, the card run's results with a served prompt)."""
    from repro_torch.models import registry as MR
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    params = MR.init_params(small, gen, device)
    e_gpu, r_gpu, res = family_serve(torch, ops, small, params, what,
                                     device)
    params_cpu = to_cpu(params)
    e_cpu, r_cpu = serve(torch, small, "cpu", params_cpu)
    e_cpu.submit_all(r_cpu)
    if [r.rejected for r in r_gpu] != [r.rejected for r in r_cpu] or \
            [r.out for r in r_gpu] != [r.out for r in r_cpu]:
        fail(f"{what}: tokens or admission differ between card and CPU")
    res["ringbuf_stat_max_diff"] = maps_card_vs_cpu(
        e_gpu.maps, e_cpu.maps, "sv_logits_rb", what)
    res["prompt"] = next(r.prompt for r in r_gpu if not r.rejected)
    return params, params_cpu, res


def maps_card_vs_cpu(maps_gpu, maps_cpu, rb_name, what) -> float:
    """Every map bit for bit but the ring buffer `rb_name`'s two Q47.16
    stat lanes, which must be within STATS_TOL (relative) or 1; returns
    their largest difference."""
    import numpy as np
    from repro_torch.core.runtime import to_numpy
    g, c = to_numpy(maps_gpu), to_numpy(maps_cpu)
    rb_g, rb_c = g[rb_name]["data"], c[rb_name]["data"]
    stat_err = float(np.abs(rb_g[:, 2:] - rb_c[:, 2:]).max())
    if not np.allclose(rb_g[:, 2:].astype(np.float64),
                       rb_c[:, 2:].astype(np.float64), rtol=STATS_TOL,
                       atol=1):
        fail(f"{what}: the ringbuf's stat lanes differ by {stat_err}")
    g[rb_name]["data"], c[rb_name]["data"] = rb_g[:, :2], rb_c[:, :2]
    bad = [f"{m}.{f}" for m in c for f in c[m]
           if not np.array_equal(g[m][f], c[m][f])]
    if bad or set(g) != set(c):
        fail(f"{what}: maps differ between card and CPU: {bad}")
    return stat_err


def logits_close(logits, what) -> float:
    """Card and CPU logits [card, cpu] within FAMILY_LOGIT_TOL relative to
    the largest magnitude (and absolute below 1); returns the max abs
    difference."""
    err = float((logits[0] - logits[1]).abs().max())
    if not err <= FAMILY_LOGIT_TOL * (1 + float(logits[1].abs().max())):
        fail(f"{what}: card and CPU prefill logits differ by {err}")
    return err


# --------------------------------------------------------------------------
# phase 12: the encoder-decoder and VLM families
# --------------------------------------------------------------------------

SEAMLESS = "seamless-m4t-medium"
QWEN2_VL = "qwen2-vl-72b"
# qwen2-vl-72b cut to 4 of its 80 layers: 6.0 B parameters, 24 GB in f32
QWEN2_VL_LAYERS = 4
# seamless: 4 requests of 4096 frame embeddings (the stub's serving shape,
# src/repro/launch/specs.py:118) and 16-token prompts, 16 decode steps
ENC_BATCH, ENC_FRAMES, DEC_PROMPT = 4, 4096, 16
DEC_STEPS, DEC_MAX_SEQ = 16, 128
# qwen2-vl's multimodal request: a 32 x 32 patch grid (frontend_tokens
# 1024) and 3072 text tokens, 4096 positions; 8 decode steps
VLM_GRID, VLM_TEXT, VLM_STEPS = (32, 32), 3072, 8
SMOKE_GRID = (2, 4)                   # the smoke frontend's 8 patches


def flash_fwd_at(torch, FA, ref, BH, BKH, S, hd, causal, what, seed=None):
    """The bf16 forward kernel at a model path's shape (kernel layout, B
    = 1 in SDPA's) against ref.flash_fwd within TOL_BF16_O / TOL_LSE, and
    its device ms (CUDA events) beside the plain version's and one
    scaled_dot_product_attention call's on the same inputs. Bound: 4 hd
    operations per (q, k) pair and q head at the bf16 rate, against q, k,
    v and o in bf16 and lse in f32 once. Returns the row and (q, k, v, do,
    o, lse)."""
    import torch.nn.functional as F
    q, k, v, do = _flash_inputs(torch, BH, BKH, S, hd, torch.bfloat16,
                                BH + S + hd if seed is None else seed)
    rep = BH // BKH
    o, lse = FA.flash_fwd_cuda(q, k, v, causal)
    wo, wl = ref.flash_fwd(q, k, v, causal, rep)
    err = _close(torch, o, wo, *FA.TOL_BF16_O, f"{what}: flash_fwd bf16")
    lse_err = _close(torch, lse, wl, *FA.TOL_LSE, f"{what}: flash lse")
    del wo, wl
    # SDPA's [1, heads, S, hd]: q head h reads kv head h // rep, as the
    # kernel's bh // rep does
    q4, k4, v4 = (t.view(1, -1, S, hd) for t in (q, k, v))

    def sdpa():
        return F.scaled_dot_product_attention(q4, k4, v4, is_causal=causal,
                                              enable_gqa=rep > 1)
    sd_err = float((sdpa().float().reshape(BH, S, hd) - o.float())
                   .abs().max())
    ms = cuda_ms(torch, lambda: FA.flash_fwd_cuda(q, k, v, causal), 10)
    plain = cuda_ms(torch, lambda: ref.flash_fwd(q, k, v, causal, rep), 2,
                    warmup=1)
    lib = cuda_ms(torch, sdpa, 20)
    pairs = S * (S + 1) // 2 if causal else S * S
    ops_ = 4.0 * hd * pairs * BH
    b, by = bound_ms(2 * (2 * BH + 2 * BKH) * S * hd + 4 * BH * S, ops_,
                     BF16_OPS_PER_S)
    row = {"shape": [BH, BKH, S, hd], "causal": causal, "dtype": "bfloat16",
           "ms": ms, "plain_ms": plain, "bound_ms": b, "bound_by": by,
           "library_ms": lib, "library_is": "sdpa forward",
           "gflop": ops_ / 1e9, "tflops": ops_ / ms / 1e9,
           "share_of_bound": b / ms, "max_abs_err": err,
           "lse_max_abs_err": lse_err, "max_abs_diff_vs_sdpa": sd_err}
    print(f"  {what}: flash_fwd (BH {BH}, BKH {BKH}, S {S}, hd {hd}, "
          f"{'causal' if causal else 'non-causal'}) bf16: kernel "
          f"{ms * 1e3:.1f} us ({row['tflops']:.1f} TFLOP/s, "
          f"{100 * b / ms:.1f} % of the bound), plain {plain:.2f} ms, sdpa "
          f"{lib * 1e3:.1f} us, bound {b * 1e3:.1f} us ({by}, "
          f"{row['gflop']:.0f} GFLOP); max abs err {err:.2e} (lse "
          f"{lse_err:.2e}), vs sdpa {sd_err:.2e}", flush=True)
    return row, (q, k, v, do, o, lse)


def encdec_serve(torch, cfg, params, batch, steps, device="cuda"):
    """The encoder-decoder family's serving path: one probed prefill
    (`make_prefill_step` with ENCDEC_PROBES) from a cache of max_seq
    DEC_MAX_SEQ and enc_seq the frame count, then `steps` probed decode
    steps (`make_decode_step`, greedy) from its cache. Returns the runtime,
    the steps, the prefill logits and cache, the maps after the prefill
    (a copy) and at the end, the tokens and the events per step."""
    from repro_torch.core.runtime import BpftimeRuntime
    from repro_torch.launch import serve as L
    from repro_torch.models import registry as MR
    from repro_torch.serve.steps import make_decode_step, make_prefill_step
    rt = BpftimeRuntime()
    L.attach_serve_probes(rt, L.family_probes(cfg))
    prefill, decode = make_prefill_step(cfg, rt), make_decode_step(cfg, rt)
    maps = rt.init_device_maps(device)
    cache = MR.make_cache(cfg, batch["tokens"].shape[0], DEC_MAX_SEQ,
                          torch.float32, device,
                          enc_seq=batch["enc_embeds"].shape[1])
    logits, cache0, maps = prefill(params, batch, cache, maps)
    out = {"rt": rt, "prefill": prefill, "decode": decode,
           "logits": logits, "cache": cache0,
           "maps_prefill": {n: {f: a.clone() for f, a in st.items()}
                            for n, st in maps.items()},
           "events": [prefill.last[0].shape[0]]}
    first = logits[:, -1, :cfg.vocab_size].argmax(-1)[:, None]
    nxt, cache, toks = first, cache0, [first[:, 0].tolist()]
    for step in range(steps):
        t, _, cache, maps = decode(params, nxt, cache, maps, step)
        out["events"].append(decode.last[0].shape[0])
        nxt = t[:, None].long()
        toks.append(t.tolist())
    out.update(maps=maps, tokens=toks)
    return out


def check_encdec_path(cfg, run, launches, what, flash_per_prefill):
    """The encoder-decoder path's counts: the serving kernels launched,
    tensor_stats once per event, 1 + enc_layers events in the prefill
    (enc.in, enc.block) and one (decode.logits) a decode step, the flash
    forward `flash_per_prefill` times; the maps' hist, hash and ring
    buffer counts; the prefill's and the last decode step's tapes replayed
    through every mode."""
    from repro_torch.core.maps import n_hash_items
    from repro_torch.core.runtime import to_numpy
    ev = run["events"]
    if ev[0] != 1 + cfg.enc_layers or any(e != 1 for e in ev[1:]):
        fail(f"{what}: events per step {ev}, expected "
             f"{1 + cfg.enc_layers} then 1 a decode step")
    if any(launches[k] == 0 for k in SERVING_KERNELS):
        fail(f"{what}: a serving kernel was not launched: {launches}")
    if launches["tensor_stats"] != sum(ev):
        fail(f"{what}: tensor_stats launches {launches['tensor_stats']} != "
             f"events {sum(ev)}")
    if launches["flash_fwd"] != flash_per_prefill:
        fail(f"{what}: flash_fwd launched {launches['flash_fwd']} times in "
             f"a prefill, not {flash_per_prefill}")
    m = to_numpy(run["maps"])
    steps = len(ev) - 1
    hashed = sorted((int(k), v) for k, v in
                    n_hash_items(m["ed_layer_hash"]).items())
    if int(m["ed_rms_hist"]["bins"].sum()) != cfg.enc_layers or \
            int(m["ed_in_rms_hist"]["bins"].sum()) != 1 or \
            hashed != [(i, 1) for i in range(cfg.enc_layers)] or \
            int(m["ed_logits_rb"]["head"][0]) != steps:
        fail(f"{what}: ENCDEC_PROBES' maps do not count one enc.in, one "
             f"enc.block a layer and one record a decode step: hist "
             f"{int(m['ed_rms_hist']['bins'].sum())}, hash {hashed}")
    rt = run["rt"]
    replay_tape(rt, run["prefill"].last[:3], run["maps_prefill"],
                f"{what} prefill tape")
    replay_tape(rt, run["decode"].last[:3], run["maps"], what)


def seamless_whole(torch, ops, FA, ref, registry, device="cuda"):
    """(a): seamless-m4t-medium whole (12 + 12 layers, every published
    width), bf16 compute, f32 parameters drawn on the card from seed 0."""
    from repro_torch.models import encdec as ED
    from repro_torch.models import registry as MR
    from repro_torch.optim import tree_leaves
    from repro_torch.serve.steps import make_decode_step
    cfg = registry.get(SEAMLESS)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    t0 = time.perf_counter()
    params = MR.init_params(cfg, gen, device)
    n = sum(p.numel() for p in tree_leaves(params))
    batch = {"enc_embeds": torch.randn(ENC_BATCH, ENC_FRAMES, cfg.d_model,
                                       generator=gen, device=device),
             "tokens": torch.randint(0, cfg.vocab_size,
                                     (ENC_BATCH, DEC_PROMPT), generator=gen,
                                     device=device)}
    torch.cuda.synchronize()
    print(f"  (a) {SEAMLESS} whole: {cfg.enc_layers} + {cfg.dec_layers} "
          f"layers, {n / 1e9:.3f} B parameters, {4 * n / 1e9:.2f} GB in "
          f"f32, drawn in {time.perf_counter() - t0:.1f} s; {ENC_BATCH} "
          f"requests of {ENC_FRAMES} frames and {DEC_PROMPT} tokens",
          flush=True)
    what = "phase 12 (a)"
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    run = encdec_serve(torch, cfg, params, batch, DEC_STEPS, device)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = ops.launch_counts()
    logits = run["logits"]
    if tuple(logits.shape) != (ENC_BATCH, DEC_PROMPT, cfg.padded_vocab) or \
            not bool(torch.isfinite(logits).all()):
        fail(f"{what}: prefill logits shape {tuple(logits.shape)} or not "
             "finite")
    if any(not 0 <= t < cfg.vocab_size for ts in run["tokens"] for t in ts):
        fail(f"{what}: a generated token lies outside the vocabulary")
    check_encdec_path(cfg, run, launches, what, cfg.enc_layers)
    print(f"  {what}: a probed prefill and {DEC_STEPS} probed decode steps "
          f"in {wall:.2f} s, events {run['events'][0]} + {DEC_STEPS} x 1; "
          f"kernels {json.dumps(launches)}; maps and replays checked",
          flush=True)
    out = {"params_b": n / 1e9, "wall_s": wall, "launches": launches,
           "events": run["events"], "peak_gb_path":
           torch.cuda.max_memory_allocated() / 1e9}
    cache0, maps0 = run["cache"], run["maps"]
    del run, logits

    # the prefill: host clock (synchronised) and CUDA events
    def one_prefill():
        return MR.prefill_fn(params, batch, MR.make_cache(
            cfg, ENC_BATCH, DEC_MAX_SEQ, torch.float32, device,
            enc_seq=ENC_FRAMES), cfg)
    host = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        one_prefill()
        torch.cuda.synchronize()
        host.append((time.perf_counter() - t0) * 1e3)
    out["prefill_host_ms"] = host
    out["prefill_device_ms"] = cuda_ms(torch, one_prefill, 3, warmup=0)

    # decode steps from the prefill's cache, probed and not, in turns
    from repro_torch.launch import serve as L
    from repro_torch.core.runtime import BpftimeRuntime
    rt = BpftimeRuntime()
    L.attach_serve_probes(rt, L.family_probes(cfg))
    steps = {"probed": make_decode_step(cfg, rt),
             "unprobed": make_decode_step(cfg)}
    first = torch.zeros(ENC_BATCH, 1, dtype=torch.long, device=device)
    ms = {"probed": [], "unprobed": []}
    for label in ("probed", "unprobed", "unprobed", "probed"):
        dec, maps = steps[label], (maps0 if label == "probed" else {})
        nxt, cache = first, cache0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for step in range(DEC_STEPS):
            t, _, cache, maps = dec(params, nxt, cache, maps, step)
            nxt = t[:, None].long()
        torch.cuda.synchronize()
        ms[label].append((time.perf_counter() - t0) * 1e3 / DEC_STEPS)
    out["decode_ms_per_step"] = ms

    # one probed pass (prefill and 16 decode steps) under the profiler
    groups = {"flash kernels": ("flash_",) + tuple(f"sm90::{k}"
                                                   for k in FLASH_SM90),
              **PROBE_GROUPS}
    pwall, by_group, flash, col, spans = profiled(
        torch, lambda: encdec_serve(torch, cfg, params, batch, DEC_STEPS,
                                    device), groups, "flash kernels",
        ranges={"encode": (ED, "encode")})
    busy = sum(by_group.values()) / 1e3
    enc_ms = spans["ranges"]["encode"]["device_ms"]
    flash_ms = by_group["flash kernels"] / 1e3
    out.update(profiled_wall_ms=pwall * 1e3, device_busy_ms=busy,
               device_busy_share=busy / 1e3 / pwall,
               device_ms_by_group={g: v / 1e3 for g, v in by_group.items()},
               encoder_device_ms=enc_ms, flash_device_ms=flash_ms,
               flash_share_of_encoder=flash_ms / enc_ms if enc_ms
               else None,
               flash_kernels_device=flash, collector_ops=col,
               casts_device_ms=spans["casts_device_ms"])
    out["flash_fwd"] = flash_fwd_at(
        torch, FA, ref, ENC_BATCH * cfg.num_heads,
        ENC_BATCH * cfg.num_kv_heads, ENC_FRAMES, cfg.hd, False, what)[0]
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"  {what}: prefill {', '.join(f'{h:.1f}' for h in host)} ms "
          f"(host), {out['prefill_device_ms']:.1f} ms (CUDA events); the "
          f"encoder {enc_ms:.1f} ms of device, the flash kernels "
          f"{flash_ms:.2f} ms of it "
          f"({100 * (out['flash_share_of_encoder'] or 0):.1f} %); "
          f"decode ms a step probed "
          f"{', '.join(f'{m:.2f}' for m in ms['probed'])}, unprobed "
          f"{', '.join(f'{m:.2f}' for m in ms['unprobed'])}; device busy "
          f"{100 * out['device_busy_share']:.1f} % of a profiled pass; "
          f"casts {spans['casts_device_ms']:.1f} ms; peak memory "
          f"{out['peak_gb']:.1f} GB", flush=True)
    return out


def vlm_multimodal(torch, ops, cfg, params, grid, n_text, steps, what,
                   device="cuda", flash_per_prefill=None, counted=True,
                   warm_reps=0):
    """One multimodal request at batch 1: grid[0] x grid[1] frontend
    embeddings (cfg.frontend_tokens) and n_text tokens with their M-RoPE
    grid ids, made from seed 0 on the host; prefilled through
    `registry.prefill_fn` (the counts set to 0 just before and read just
    after; flash_fwd must have launched `flash_per_prefill` times), then
    `steps` probed decode steps with the family's probes (counted again:
    the serving kernels, tensor_stats once per event; counted=False, for a
    run on the CPU, checks only the events), the last tape replayed. With
    warm_reps, the prefill is timed again that many times (host clock,
    synchronised) and by CUDA events."""
    from repro_torch.core.runtime import BpftimeRuntime
    from repro_torch.launch import serve as L
    from repro_torch.models import layers as ML, registry as MR
    from repro_torch.serve.steps import make_decode_step
    rows, cols = grid
    if rows * cols != cfg.frontend_tokens:
        fail(f"{what}: a {rows} x {cols} grid is not the frontend's "
             f"{cfg.frontend_tokens} embeddings")
    gen = torch.Generator()
    gen.manual_seed(SEED)
    S = rows * cols + n_text
    batch = {"embeds": torch.randn(1, rows * cols, cfg.d_model,
                                   generator=gen).to(device),
             "tokens": torch.randint(0, cfg.vocab_size, (1, n_text),
                                     generator=gen).to(device),
             "positions": ML.mrope_grid_positions(rows, cols, n_text, 1,
                                                  device)}

    def one_prefill():
        return MR.prefill_fn(params, batch, MR.make_cache(
            cfg, 1, S + steps, torch.float32, device), cfg)
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    logits, cache = one_prefill()
    torch.cuda.synchronize()
    first_ms = (time.perf_counter() - t0) * 1e3
    pre = ops.launch_counts()
    if tuple(logits.shape) != (1, S, cfg.padded_vocab) or \
            not bool(torch.isfinite(logits).all()):
        fail(f"{what}: prefill logits shape {tuple(logits.shape)} or not "
             "finite")
    if flash_per_prefill is not None and pre["flash_fwd"] != \
            flash_per_prefill:
        fail(f"{what}: flash_fwd launched {pre['flash_fwd']} times in the "
             f"{S}-position prefill, not {flash_per_prefill}")
    rt = BpftimeRuntime()
    L.attach_serve_probes(rt, L.family_probes(cfg))
    decode = make_decode_step(cfg, rt)
    maps = rt.init_device_maps(device)
    nxt = logits[:, -1, :cfg.vocab_size].argmax(-1)[:, None]
    toks, events = [nxt[:, 0].tolist()], 0
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    for step in range(steps):
        t, _, cache, maps = decode(params, nxt, cache, maps, step)
        events += decode.last[0].shape[0]
        nxt = t[:, None].long()
        toks.append(t.tolist())
    torch.cuda.synchronize()
    dec = ops.launch_counts()
    if counted and any(dec[k] == 0 for k in SERVING_KERNELS):
        fail(f"{what}: a serving kernel was not launched: {dec}")
    if (counted and dec["tensor_stats"] != events) or \
            events != steps * events_per_step(cfg):
        fail(f"{what}: tensor_stats launches {dec['tensor_stats']}, events "
             f"{events}, expected {steps} x {events_per_step(cfg)}")
    if any(not 0 <= t < cfg.vocab_size for ts in toks for t in ts):
        fail(f"{what}: a generated token lies outside the vocabulary")
    replay_tape(rt, decode.last[:3], maps, what)
    out = {"positions": S, "first_prefill_ms": first_ms,
           "launches_prefill": pre, "launches": dec, "events": events,
           "tokens": toks, "logits": logits, "maps": maps}
    if warm_reps:
        out["prefill_host_ms"] = []
        for _ in range(warm_reps):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            one_prefill()
            torch.cuda.synchronize()
            out["prefill_host_ms"].append((time.perf_counter() - t0) * 1e3)
        out["prefill_device_ms"] = cuda_ms(torch, one_prefill, warm_reps,
                                           warmup=0)
    return out


def qwen2vl_full(torch, ops, FA, ref, registry, device="cuda"):
    """(b): qwen2-vl-72b at full width, 4 of its 80 layers, bf16 compute,
    f32 parameters drawn on the card from seed 0: (i) phase 3's serving
    through ServeEngine, text-only; (ii) a multimodal request."""
    import dataclasses
    from repro_torch.models import layers as ML, registry as MR
    from repro_torch.optim import tree_leaves
    full = registry.get(QWEN2_VL)
    cfg = dataclasses.replace(full, num_layers=QWEN2_VL_LAYERS)
    torch.cuda.reset_peak_memory_stats()
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    t0 = time.perf_counter()
    params = MR.init_params(cfg, gen, device)
    torch.cuda.synchronize()
    n = sum(p.numel() for p in tree_leaves(params))
    print(f"  (b) {QWEN2_VL}, {QWEN2_VL_LAYERS} of its {full.num_layers} "
          f"layers (the whole model's "
          f"{full.param_counts()['total'] / 1e9:.1f} B parameters do not "
          f"fit one card): {n / 1e9:.2f} B parameters, {4 * n / 1e9:.1f} "
          f"GB in f32, drawn in {time.perf_counter() - t0:.1f} s",
          flush=True)
    engine, _, out = family_serve(torch, ops, cfg, params,
                                  "phase 12 (b)(i) text-only", device)
    del engine
    out["params_b"] = n / 1e9
    out["timing"] = timing(torch, cfg, params, ranges={
        "attention_block": (ML, "attention_block")})
    what = "phase 12 (b)(ii)"
    mm = vlm_multimodal(torch, ops, cfg, params, VLM_GRID, VLM_TEXT,
                        VLM_STEPS, what, device, cfg.num_layers, warm_reps=2)
    del mm["logits"], mm["maps"]
    host, dev_ms = mm["prefill_host_ms"], mm["prefill_device_ms"]
    print(f"  {what}: a {mm['positions']}-position prefill ({VLM_GRID[0]} x "
          f"{VLM_GRID[1]} patches, {VLM_TEXT} tokens, grid ids) "
          f"{mm['first_prefill_ms']:.1f} ms cold, "
          f"{', '.join(f'{h:.1f}' for h in host)} ms warm (host), "
          f"{dev_ms:.1f} ms (CUDA events), flash_fwd launched "
          f"{mm['launches_prefill']['flash_fwd']} times; {VLM_STEPS} probed "
          f"decode steps, {mm['events']} events, kernels "
          f"{json.dumps(mm['launches'])}; replays checked", flush=True)
    out["multimodal"] = mm
    out["flash_fwd"] = flash_fwd_at(
        torch, FA, ref, cfg.num_heads, cfg.num_kv_heads, mm["positions"],
        cfg.hd, True, what)[0]
    out["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    print(f"  (b) peak memory {out['peak_gb']:.1f} GB", flush=True)
    return out


def new_families_card_vs_cpu(torch, ops, registry, device="cuda"):
    """(c): seamless and qwen2-vl at smoke width (f32, TF32 off) on the
    card and on the CPU from the same weights. seamless: 2 requests of
    4096 frames (the f32 flash kernel, non-causal, in each encoder layer on
    the card) and 8 tokens, a probed prefill and 4 probed decode steps;
    qwen2-vl: phase 3's serving, then a multimodal request (2 x 4 patches,
    6 tokens, grid ids) and 4 probed decode steps. Tokens equal, maps bit
    for bit but the ring buffers' stat lanes (within STATS_TOL or 1),
    prefill logits within FAMILY_LOGIT_TOL."""
    from repro_torch.models import registry as MR
    out = {}
    small = registry.smoke(SEAMLESS)
    what = f"phase 12 (c) {SEAMLESS} at smoke width"
    gen = torch.Generator(device=device)
    gen.manual_seed(SEED)
    params = MR.init_params(small, gen, device)
    params_cpu = to_cpu(params)
    gen = torch.Generator()
    gen.manual_seed(SEED)
    batch_cpu = {"enc_embeds": torch.randn(2, ENC_FRAMES, small.d_model,
                                           generator=gen),
                 "tokens": torch.randint(0, small.vocab_size, (2, 8),
                                         generator=gen)}
    batch = {k: v.to(device) for k, v in batch_cpu.items()}
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    run = encdec_serve(torch, small, params, batch, 4, device)
    torch.cuda.synchronize()
    launches = ops.launch_counts()
    check_encdec_path(small, run, launches, what, small.enc_layers)
    run_cpu = encdec_serve(torch, small, params_cpu, batch_cpu, 4, "cpu")
    if run["tokens"] != run_cpu["tokens"]:
        fail(f"{what}: tokens differ between card and CPU")
    stat = maps_card_vs_cpu(run["maps"], run_cpu["maps"], "ed_logits_rb",
                            what)
    err = logits_close([run["logits"].cpu(), run_cpu["logits"]], what)
    print(f"  {what}: card and CPU tokens equal, maps bit for bit (ringbuf "
          f"stat lanes within {stat:.0f} of 2^16), prefill logits within "
          f"{err:.2e}; the f32 flash kernel launched "
          f"{launches['flash_fwd']} times (non-causal)", flush=True)
    out[SEAMLESS] = {"launches": launches, "events": run["events"],
                     "ringbuf_stat_max_diff": stat,
                     "logits_max_abs_diff": err}
    del run, run_cpu

    small = registry.smoke(QWEN2_VL)
    what = f"phase 12 (c) {QWEN2_VL} at smoke width"
    params, params_cpu, res = serve_card_vs_cpu(torch, ops, small, what,
                                                device)
    res.pop("prompt")
    mm = [vlm_multimodal(torch, ops, small, p, SMOKE_GRID, 6, 4, what, dev,
                         counted=dev != "cpu")
          for p, dev in ((params, device), (params_cpu, "cpu"))]
    if mm[0]["tokens"] != mm[1]["tokens"]:
        fail(f"{what}: the multimodal request's tokens differ between card "
             "and CPU")
    stat = maps_card_vs_cpu(mm[0]["maps"], mm[1]["maps"], "sv_logits_rb",
                            what)
    err = logits_close([mm[0]["logits"].cpu(), mm[1]["logits"]], what)
    print(f"  {what}: served tokens and maps equal on card and CPU; the "
          f"multimodal request's tokens equal, maps bit for bit (stat lanes "
          f"within {stat:.0f}), prefill logits within {err:.2e}", flush=True)
    launches = {k: res["launches"][k] + mm[0]["launches"][k]
                for k in res["launches"]}
    out[QWEN2_VL] = {**res, "launches": launches,
                     "multimodal_logits_max_abs_diff": err,
                     "multimodal_ringbuf_stat_max_diff": stat}
    return out


# --------------------------------------------------------------------------
# phase 13: the MoE, SSM, encoder-decoder and VLM families trained
# --------------------------------------------------------------------------

# train_4k's sequence (src/repro/configs/base.py:133) and phase 7's steps;
# the global batches are cut to what one card holds (train_4k has 256)
TRAIN_SEQ, TRAIN_STEPS = 4096, 3
MAMBA2_BATCH, SEAMLESS_BATCH = 4, 2
# qwen2-vl: 2 rows in microbatches of 1 (the f32 accumulation runs), each a
# 32 x 32 patch grid and 3072 tokens; the rows of step GRID_STEP carry
# their M-RoPE grid ids. llama4-scout: 1 row, no accumulation
QWEN2_VL_BATCH, QWEN2_VL_MICRO, LLAMA4_BATCH = 2, 1, 1
GRID_STEP = 1
# qwen2-vl-72b and llama4-scout at full width cut to 1 layer (3.37 B and
# 4.27 B parameters: embedding and head alone are 2.5 B and 2.07 B)
TRAIN_CUT_LAYERS = 1
# a gradient at most this large is rounding noise of a zero (phase 13 (f))
NOISE_GRAD = 1e-8
# the flash backward at the training paths' shapes (BH, BKH, S, hd,
# causal, what): seamless's encoder and decoder at batch 2 (16 heads of
# 64), qwen2-vl's and llama4-scout's rows (64/8 and 40/8 heads of 128)
FLASH_BWD_PATHS = [(32, 32, 4096, 64, False, "seamless encoder"),
                   (32, 32, 4096, 64, True, "seamless decoder"),
                   (64, 8, 4096, 128, True, "qwen2-vl"),
                   (40, 8, 4096, 128, True, "llama4-scout")]


def layer_events(cfg) -> int:
    """Layer-counter events of one microbatch: one a layer; an encoder and
    a decoder layer each in the encoder-decoder family."""
    if cfg.family == "encdec":
        return cfg.enc_layers + cfg.dec_layers
    return cfg.num_layers


def attention_layers(cfg) -> int:
    """Layers whose self-attention takes the flash kernels at 4096."""
    if cfg.family == "encdec":
        return cfg.enc_layers + cfg.dec_layers
    return layers_of(cfg, lambda j: cfg.block_kind(j) == "attn")


def flash_bwd_at(torch, FA, ref, BH, BKH, S, hd, causal, what, fwd=False,
                 seed=None):
    """The bf16 backward kernels (delta, dkv, dq) at a training path's shape
    against ref.flash_bwd within TOL_BF16_GRAD / TOL_BF16_NORM, bit for bit
    on a rerun, and timed (CUDA events) beside the plain version and SDPA's
    backward alone on the same inputs. With fwd, the forward is first held
    and timed by flash_fwd_at. Bound: 2.5x the forward's operations (the
    least work is five products: q k^T recomputed, do v^T, p^T do, ds^T q,
    ds k) at the bf16 rate, against q, k, v, o, do, lse read and dq, dk, dv
    written once. Returns (backward row, forward row or None)."""
    import torch.nn.functional as F
    rep = BH // BKH
    fwd_row = None
    if fwd:
        fwd_row, (q, k, v, do, o, lse) = flash_fwd_at(
            torch, FA, ref, BH, BKH, S, hd, causal, what, seed)
    else:
        q, k, v, do = _flash_inputs(torch, BH, BKH, S, hd, torch.bfloat16,
                                    BH + S + hd if seed is None else seed)
        o, lse = FA.flash_fwd_cuda(q, k, v, causal)
    got = FA.flash_bwd_cuda(q, k, v, o, lse, do, causal)
    again = FA.flash_bwd_cuda(q, k, v, o, lse, do, causal)
    want = ref.flash_bwd(q, k, v, o, lse, do, causal, rep)
    torch.cuda.synchronize()
    gerr, rtol, atol = 0.0, *FA.TOL_BF16_GRAD
    for name, g, a, w in zip(("dq", "dk", "dv"), got, again, want):
        if not torch.equal(g, a):
            fail(f"{what}: flash_bwd {name}: two runs are not bit-identical")
        scale = max(1.0, float(w.float().abs().max()))
        gerr = max(gerr, _close(torch, g, w, rtol, atol * scale,
                                f"{what}: flash_bwd {name} bf16",
                                FA.TOL_BF16_NORM))
    del got, again, want
    q4, k4, v4, do4 = (t.view(1, -1, S, hd) for t in (q, k, v, do))
    qg, kg, vg = (t.detach().clone().requires_grad_(True)
                  for t in (q4, k4, v4))
    sd_out = F.scaled_dot_product_attention(qg, kg, vg, is_causal=causal,
                                            enable_gqa=rep > 1)
    ms = cuda_ms(torch, lambda: FA.flash_bwd_cuda(q, k, v, o, lse, do,
                                                  causal), 5)
    plain = cuda_ms(torch, lambda: ref.flash_bwd(q, k, v, o, lse, do,
                                                 causal, rep), 2, warmup=1)
    lib = cuda_ms(torch, lambda: torch.autograd.grad(
        sd_out, (qg, kg, vg), do4, retain_graph=True), 10)
    del sd_out
    pairs = S * (S + 1) // 2 if causal else S * S
    io = 2 * (2 * BH + 2 * BKH) * S * hd
    ops_ = 10.0 * hd * pairs * BH
    b, by = bound_ms(io + 2 * BH * S * hd + 4 * BH * S
                     + 2 * (BH + 2 * BKH) * S * hd, ops_, BF16_OPS_PER_S)
    row = {"shape": [BH, BKH, S, hd], "causal": causal, "what": what,
           "dtype": "bfloat16", "ms": ms, "plain_ms": plain, "bound_ms": b,
           "bound_by": by, "library_ms": lib,
           "library_is": "sdpa backward", "gflop": ops_ / 1e9,
           "times_bound": ms / b, "max_abs_err": gerr}
    print(f"  {what}: flash_bwd (BH {BH}, BKH {BKH}, S {S}, hd {hd}, "
          f"{'causal' if causal else 'non-causal'}) bf16: kernel {ms:.3f} "
          f"ms ({ms / b:.2f}x the bound), plain {plain:.2f} ms, sdpa "
          f"backward {lib:.3f} ms, bound {b:.4f} ms ({by}, "
          f"{row['gflop']:.0f} GFLOP); max abs err {gerr:.2e}; two runs "
          "bit-identical", flush=True)
    return row, fwd_row


def flash_bwd_paths(torch, FA, ref):
    """(e): flash_bwd_at at every FLASH_BWD_PATHS shape, each from the
    forward that flash_fwd_at has just held against ref.flash_fwd there
    (the training step launches both kernels at these shapes)."""
    rows, fwd_rows = [], []
    for BH, BKH, S, hd, causal, what in FLASH_BWD_PATHS:
        row, fwd = flash_bwd_at(torch, FA, ref, BH, BKH, S, hd, causal,
                                f"phase 13 (e) {what}", fwd=True)
        rows.append(row)
        fwd_rows.append(fwd)
        gc.collect()
        torch.cuda.empty_cache()
    return rows, fwd_rows


def check_train_run(cfg, what, run, steps=TRAIN_STEPS):
    """Phase 13's checks of one training run (`run` from `train_run`): every
    step ran, none vetoed, losses and gradient norms finite; tensor_stats
    once per collected event; events per step the layers' events, a loss a
    microbatch and the gradient norm; the hash and ring-buffer kernels
    launched; the layer counters one a layer a microbatch (an encoder and a
    decoder layer share an index); the loss ring and the gradient-norm
    histogram every event; the flash kernels twice (forward and remat
    recompute) and once (backward) a layer a microbatch; the last step's
    tape replayed through every mode to the fused lane's maps."""
    from repro_torch.core.runtime import to_numpy
    hist, events, launches, n_mb = (run["hist"], run["events"],
                                    run["launches"], run["microbatches"])
    if len(hist) != steps or any(h["vetoed"] != 0 for h in hist):
        fail(f"{what}: {len(hist)} steps, vetoed "
             f"{[h['vetoed'] for h in hist]}")
    if not all(math.isfinite(h["loss"]) and math.isfinite(h["grad_norm"])
               for h in hist):
        fail(f"{what}: a loss or gradient norm is not finite")
    if launches["tensor_stats"] != sum(events):
        fail(f"{what}: tensor_stats launches {launches['tensor_stats']} != "
             f"events collected {sum(events)}")
    per_step = layer_events(cfg) * n_mb + n_mb + 1
    if events != [per_step] * steps:
        fail(f"{what}: events per step {events}, expected {per_step}")
    if launches["hash_fetch_add_batch"] == 0 or \
            launches["ringbuf_emit_batch"] == 0:
        fail(f"{what}: the hash or ring-buffer kernel was not launched: "
             f"{launches}")
    maps = to_numpy(run["state"]["maps"])
    n_idx = cfg.enc_layers if cfg.family == "encdec" else cfg.num_layers
    per_idx = (2 if cfg.family == "encdec" else 1) * n_mb * steps
    counts = maps["tr_layer_counts"]["values"]
    if counts[:n_idx].tolist() != [per_idx] * n_idx or counts[n_idx:].any():
        fail(f"{what}: the ARRAY layer counters {counts[:n_idx + 2]} do "
             f"not count {per_idx} a layer index")
    if int(maps["tr_loss_rb"]["head"][0]) != n_mb * steps or \
            int(maps["tr_gnorm_hist"]["bins"].sum()) != steps:
        fail(f"{what}: the loss record or the gradient-norm histogram "
             "missed an event")
    attn = attention_layers(cfg)
    want = (2 * attn * n_mb * steps, attn * n_mb * steps)
    if (launches["flash_fwd"], launches["flash_bwd"]) != want:
        fail(f"{what}: flash launches {launches['flash_fwd']}/"
             f"{launches['flash_bwd']} != {want[0]}/{want[1]}")
    replay_tape(run["rt"], run["tape"]["last"], run["state"]["maps"], what)


def report_train(what, run, batch, seq=TRAIN_SEQ):
    """Print a run's steps, tokens/s cold (step 1) and warm, peak memory
    and kernel launches; returns the summary."""
    hist, step_s = run["hist"], run["step_s"]
    tokens = batch * seq
    for i, h in enumerate(hist):
        print(f"  {what} step {i + 1}: loss {h['loss']:.5f}, grad norm "
              f"{h['grad_norm']:.5f}, lr {h['lr']:.3e}, {step_s[i]:.3f} s "
              f"= {tokens / step_s[i]:.0f} tokens/s", flush=True)
    warm = sum(step_s[1:]) / max(len(step_s) - 1, 1)
    out = {"steps": [{k: h[k] for k in ("loss", "grad_norm", "lr",
                                        "vetoed")} | {"s": s}
                     for h, s in zip(hist, step_s)],
           "tokens_per_step": tokens, "tokens_per_s_cold": tokens / step_s[0],
           "tokens_per_s_warm": tokens / warm,
           "peak_gb_step1": run["peak_step1"] / 1e9,
           "peak_gb": run["peak"] / 1e9, "events": run["events"],
           "microbatches": run["microbatches"], "launches": run["launches"]}
    print(f"  {what}: tokens/s cold {out['tokens_per_s_cold']:.0f}, warm "
          f"{out['tokens_per_s_warm']:.0f}; peak memory allocated "
          f"{out['peak_gb_step1']:.2f} GB after step 1, {out['peak_gb']:.2f} "
          f"GB in the run; events {run['events']}; kernels "
          f"{json.dumps(run['launches'])}", flush=True)
    return out


def train_run(torch, ops, cfg, tcfg, batch, grid=None, steps=TRAIN_STEPS,
              seq=TRAIN_SEQ, through_run_training=False):
    """One training run of `cfg` on the card with the family's train probes
    on the fused lane, the counts set to 0 just before and read just after.
    through_run_training: launch/train.run_training(cfg.name, smoke=False)
    itself (its TrainConfig is `tcfg`'s preset: AdamW, f32, no
    accumulation). Otherwise the functions it calls, on a config it cannot
    build (a cut depth): the preset's `tcfg`, init_train_state,
    make_train_step and SyntheticDataset, in run_training's loop; with
    grid=(rows, cols) the rows of step GRID_STEP carry their M-RoPE grid
    ids. Returns the run: hist, step seconds, events, launches, peak memory
    after step 1 and in all, the runtime, its last tape, the state, the
    microbatches a step, and (not through run_training) the step and its
    last batch."""
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.launch import train as T
    from repro_torch.models import layers as ML
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)
    tape = {}
    rt, events, begins = _train_runtime(cfg=cfg, tape=tape)
    ends, peak1 = [], []

    def on_step(s, st, m):
        ends.append(time.perf_counter())
        if not peak1:
            peak1.append(torch.cuda.max_memory_allocated())
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    out = {}
    if through_run_training:
        if tcfg != TrainConfig(microbatch=tcfg.microbatch, remat=True,
                               warmup=10, total_steps=steps):
            fail(f"{cfg.name}: the preset {tcfg} is not what run_training "
                 "builds")
        state, hist = T.run_training(
            cfg.name, steps=steps, smoke=False, runtime=rt,
            probe_mode="fused", seq_len=seq, batch=batch,
            microbatch=tcfg.microbatch, log_every=0, on_step=on_step,
            device="cuda")
    else:
        data = SyntheticDataset(cfg, ShapeConfig("train_4k_cut", seq, batch,
                                                 "train"), tcfg, runtime=rt)
        gen = torch.Generator(device="cuda")
        gen.manual_seed(SEED)
        state = init_train_state(cfg, tcfg, rt, gen, "cuda")
        step = make_train_step(cfg, tcfg, rt, probe_mode="fused")
        hist = []
        for s in range(steps):
            rt.poll_control()
            state["maps"] = rt.sync_live_table(state["maps"])
            rt.syscalls.invoke("sys_step_begin", [s], impl=lambda: None)
            b = data.next()
            if grid is not None and s == GRID_STEP:
                lead = b["tokens"].shape[:-1]
                pos = ML.mrope_grid_positions(*grid, b["tokens"].shape[-1],
                                              math.prod(lead))
                b["positions"] = pos.reshape(tuple(lead) + pos.shape[1:])
            state, m = step(state, b)
            hist.append({k: float(v) for k, v in m.items()})
            rt.syscalls.invoke("sys_step_end", [s + 1, 0],
                               impl=lambda: None)
            on_step(s + 1, state, m)
        out.update(step=step, batch=b)
    torch.cuda.synchronize()
    out.update(hist=hist, step_s=[e - b for b, e in zip(begins, ends)],
               events=list(events), launches=ops.launch_counts(),
               peak_step1=peak1[0], peak=torch.cuda.max_memory_allocated(),
               rt=rt, tape=tape, state=state,
               microbatches=batch // tcfg.microbatch if tcfg.microbatch
               else 1)
    return out


def profile_train_step(torch, cfg, tcfg, run, batch, ranges, what,
                       seq=TRAIN_SEQ):
    """One more warm step of a run under torch.profiler (never a process's
    first session here): device busy share, device ms by group (flash
    kernels, matmul, probe kernels, other), casts, and the device ms of
    `ranges` (forward and remat recompute: the backward runs outside
    them)."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.train.train_step import make_train_step
    step = run.get("step") or make_train_step(cfg, tcfg, run["rt"],
                                              probe_mode="fused")
    b = run.get("batch") or SyntheticDataset(
        cfg, ShapeConfig("prof", seq, batch, "train"), tcfg,
        seed=SEED).next()
    groups = {"flash kernels": ("flash_",) + tuple(f"sm90::{k}"
                                                   for k in FLASH_SM90),
              **PROBE_GROUPS}
    torch.cuda.synchronize()
    pwall, by_group, flash, col, spans = profiled(
        torch, lambda: step(run["state"], b), groups, "flash kernels",
        ranges)
    busy = sum(by_group.values())
    out = {"profiled_wall_ms": pwall * 1e3, "device_busy_ms": busy / 1e3,
           "device_busy_share": busy / 1e6 / pwall,
           "device_ms_by_group": {g: v / 1e3 for g, v in by_group.items()},
           "flash_kernels_device": flash, "collector_ops": col, **spans}
    print(f"  {what}: one profiled warm step: wall {pwall * 1e3:.1f} ms, "
          f"device busy {100 * out['device_busy_share']:.1f} %, casts "
          f"{spans['casts_device_ms']:.1f} ms of device", flush=True)
    return out


def family_train(torch, ops, registry, arch, what, batch, ranges, micro=0,
                 cut=None, grid=None):
    """(a)-(d): `arch` at full width (cut to `cut` layers) trained at its
    preset, checked, reported and profiled; the model is freed after."""
    import dataclasses
    from repro_torch.launch import presets
    from repro_torch.optim import tree_leaves
    full = registry.get(arch)
    cfg = full if cut is None else dataclasses.replace(full, num_layers=cut)
    tcfg = presets.train_config(arch, microbatch=micro, warmup=10,
                                total_steps=TRAIN_STEPS)
    t0 = time.perf_counter()
    run = train_run(torch, ops, cfg, tcfg, batch, grid=grid,
                    through_run_training=cut is None)
    n = sum(p.numel() for p in tree_leaves(run["state"]["params"]))
    print(f"  {what} {arch}"
          + ("" if cut is None else f", {cut} of its {full.num_layers} "
             "layers") + f": {n / 1e9:.3f} B parameters in "
          f"{tcfg.param_dtype}, {tcfg.optimizer}, global batch {batch} in "
          f"{run['microbatches']} microbatch(es), seq {TRAIN_SEQ}; "
          f"{time.perf_counter() - t0:.1f} s with the parameters' init",
          flush=True)
    check_train_run(cfg, what, run)
    out = report_train(what, run, batch)
    out.update(params_b=n / 1e9, optimizer=tcfg.optimizer,
               param_dtype=tcfg.param_dtype, layers=layer_events(cfg))
    out["profiled_step"] = profile_train_step(torch, cfg, tcfg, run, batch,
                                              ranges, what)
    del run
    gc.collect()
    torch.cuda.empty_cache()
    return out


def step_card_vs_cpu(torch, small, tcfg, batch_np, what, noise=()):
    """One training step of `small` on the card and on the CPU from the
    same weights, batch and train probes: loss and gradient norm within
    TRAIN_CMP_TOL relative; each gradient leaf (before clipping) within
    TRAIN_CMP_TOL of its own norm, floored at 1e-3 of the whole
    gradient's; updated parameters within TRAIN_PARAM_TOL; counter, hash
    and histogram maps bit for bit. A leaf whose name holds one of `noise`
    has a gradient that is zero in exact arithmetic: its largest gradient
    must be below NOISE_GRAD on both devices and its move within
    Adafactor's bound (optim/optimizers.adafactor_move_bound) on both,
    since its direction is rounding noise."""
    from repro_torch.core.runtime import to_numpy
    from repro_torch.models import registry as MR
    from repro_torch.optim import optimizers as TO, tree_leaves, tree_map
    from repro_torch.train.train_step import (init_train_state,
                                              make_train_step)
    gen = torch.Generator()
    gen.manual_seed(SEED)
    params = MR.init_params(small, gen, "cpu")
    names = TO.tree_paths(params)
    is_noise = [any(s in n for s in noise) for n in names]
    if noise and (tcfg.optimizer != "adafactor" or not any(is_noise)):
        fail(f"{what}: the noise leaves {noise} need Adafactor and a leaf")
    out = {}
    for dev in ("cuda", "cpu"):
        # the gradients the step takes, before clipping and the update
        pg = tree_map(lambda t: t.detach().to(dev).requires_grad_(True),
                      params)
        b = {k: torch.as_tensor(v) for k, v in batch_np.items()}
        b = {k: (v if v.is_floating_point() else v.to(torch.int64)).to(dev)
             for k, v in b.items()}
        loss, _ = MR.loss_fn(pg, b, small, remat=tcfg.remat)
        grads = [g.cpu() for g in torch.autograd.grad(loss,
                                                      tree_leaves(pg))]
        del pg, loss
        rt, _, _ = _train_runtime(cfg=small)
        p = tree_map(lambda t: t.to(dev), params)
        state = init_train_state(small, tcfg, rt, device=dev, params=p)
        state, m = make_train_step(small, tcfg, rt, probe_mode="fused")(
            state, batch_np)
        out[dev] = (state, m, to_numpy(state["maps"]), grads)
    (sg, mg, mapg, gg), (sc, mc, mapc, gc_) = out["cuda"], out["cpu"]
    floor = 1e-3 * float(torch.sqrt(sum(w.square().sum() for w in gc_)))
    d_g = max(float((g - w).norm()) / max(float(w.norm()), floor)
              for g, w, z in zip(gg, gc_, is_noise) if not z)
    d_loss = abs(float(mg["loss"]) - float(mc["loss"]))
    d_gn = abs(float(mg["grad_norm"]) - float(mc["grad_norm"]))
    pg_, pc_, p0 = (tree_leaves(sg["params"]), tree_leaves(sc["params"]),
                    tree_leaves(params))
    d_p = max(float((a.cpu() - b).abs().max())
              for a, b, z in zip(pg_, pc_, is_noise) if not z)
    if not (d_loss <= TRAIN_CMP_TOL * abs(float(mc["loss"]))
            and d_gn <= TRAIN_CMP_TOL * float(mc["grad_norm"])
            and d_g <= TRAIN_CMP_TOL and d_p <= TRAIN_PARAM_TOL):
        fail(f"{what} card vs CPU: loss {d_loss:.2e}, grad norm "
             f"{d_gn:.2e}, worst gradient leaf {d_g:.2e} (relative, limit "
             f"{TRAIN_CMP_TOL}), params {d_p:.2e} (limit {TRAIN_PARAM_TOL})")
    for name in ("tr_layer_counts", "tr_key_hash", "tr_gnorm_hist"):
        for f in mapc[name]:
            if not (mapg[name][f] == mapc[name][f]).all():
                fail(f"{what}: map {name}.{f} differs between card and CPU")
    held = {}
    lr = float(mc["lr"])
    for i, z in enumerate(is_noise):
        if not z:
            continue
        g_max = max(float(gg[i].abs().max()), float(gc_[i].abs().max()))
        moves = [TO.adafactor_move_bound(
            p0[i], after.cpu(), lr, getattr(torch, tcfg.param_dtype),
            weight_decay=tcfg.weight_decay) for after in (pg_[i], pc_[i])]
        if not g_max < NOISE_GRAD or any(r > b for r, b in moves):
            fail(f"{what}: the noise-trained leaf {names[i]}: largest "
                 f"gradient {g_max:.2e} (limit {NOISE_GRAD}), move RMS "
                 f"{[r for r, _ in moves]} (bound {moves[0][1]:.3e})")
        held[names[i]] = {"max_abs_grad": g_max, "move_rms_card":
                          moves[0][0], "move_rms_cpu": moves[1][0],
                          "move_bound": moves[0][1],
                          "card_vs_cpu": float((pg_[i].cpu() - pc_[i])
                                               .abs().max())}
    print(f"  {what}, one step: loss {float(mc['loss']):.6f}; card vs CPU "
          f"abs diff loss {d_loss:.2e}, grad norm {d_gn:.2e} (relative "
          f"limit {TRAIN_CMP_TOL}), worst gradient leaf {d_g:.2e} relative "
          f"(limit {TRAIN_CMP_TOL}), params max {d_p:.2e} (limit "
          f"{TRAIN_PARAM_TOL}); counter, hash and histogram maps equal"
          + "".join(f"; noise-trained leaf {n}: largest gradient "
                    f"{h['max_abs_grad']:.2e} (limit {NOISE_GRAD}), move RMS "
                    f"card {h['move_rms_card']:.3e} / CPU "
                    f"{h['move_rms_cpu']:.3e} within Adafactor's bound "
                    f"{h['move_bound']:.3e}, card vs CPU "
                    f"{h['card_vs_cpu']:.2e} apart" for n, h in held.items()),
          flush=True)
    return {"loss_diff": d_loss, "grad_norm_diff": d_gn,
            "grad_leaf_rel_diff": d_g, "param_diff": d_p,
            "noise_leaves": held}


def families_train_card_vs_cpu(torch, ops, registry, seq=256, batch=2):
    """(f): one training step of llama4-scout, mamba2, seamless (one row of
    4096 frames and tokens: the f32 flash backward, non-causal in the
    encoder)
    and qwen2-vl (patch-grid M-RoPE ids) at smoke width, f32, TF32 off, at
    each family's preset optimizer, card against CPU (step_card_vs_cpu).
    llama4-scout's router (top-1: every gate is 1, renormalised over the
    one chosen expert) is held as a noise-trained leaf. The card's
    launches are counted."""
    from repro_torch.configs.base import ShapeConfig
    from repro_torch.data.pipeline import SyntheticDataset
    from repro_torch.launch import presets
    from repro_torch.models import layers as ML
    out, launches = {}, None
    for arch in (LLAMA4, MAMBA2, SEAMLESS, QWEN2_VL):
        small = registry.smoke(arch)
        S, B = (TRAIN_SEQ, 1) if arch == SEAMLESS else (seq, batch)
        tcfg = presets.train_config(arch, param_dtype="float32",
                                    microbatch=0, warmup=0, total_steps=10)
        b = SyntheticDataset(small, ShapeConfig("cmp", S, B, "train"),
                             tcfg, seed=SEED).next()
        if arch == QWEN2_VL:
            b["positions"] = ML.mrope_grid_positions(
                *SMOKE_GRID, b["tokens"].shape[-1], B).numpy()
        noise = ("router",) if small.experts_per_token == 1 else ()
        what = f"phase 13 (f) {arch} at smoke width (f32, {tcfg.optimizer})"
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        out[arch] = step_card_vs_cpu(torch, small, tcfg, b, what, noise)
        torch.cuda.synchronize()
        got = ops.launch_counts()
        out[arch]["launches"] = got
        launches = got if launches is None else {
            k: launches[k] + got[k] for k in got}
    out["launches"] = launches
    return out


def phase13(torch, ops, FA, ref, registry):
    """(e), then (a)-(d), then (f); returns the results and the launches
    of the paths (a)-(d) and (f)."""
    from repro_torch.models import (encdec as ED, layers as ML, moe as MOE,
                                    ssm as SSM)
    out = {}
    print("  (e) the flash backward at the training paths' shapes",
          flush=True)
    out["flash_bwd"], out["flash_fwd"] = flash_bwd_paths(torch, FA, ref)
    runs = [("mamba2", MAMBA2, "(a)", MAMBA2_BATCH, 0, None, None,
             {"chunk_scan": (SSM, "chunk_scan"),
              "ssd_chunked": (SSM, "ssd_chunked")}),
            ("seamless", SEAMLESS, "(b)", SEAMLESS_BATCH, 0, None, None,
             {"encode": (ED, "encode")}),
            ("qwen2_vl", QWEN2_VL, "(c)", QWEN2_VL_BATCH, QWEN2_VL_MICRO,
             TRAIN_CUT_LAYERS, VLM_GRID,
             {"attention_block": (ML, "attention_block")}),
            ("llama4", LLAMA4, "(d)", LLAMA4_BATCH, 0, TRAIN_CUT_LAYERS,
             None, {f: (MOE, f) for f in ("route", "experts", "combine")})]
    for key, arch, label, batch, micro, cut, grid, ranges in runs:
        gc.collect()
        torch.cuda.empty_cache()
        out[key] = family_train(torch, ops, registry, arch,
                                f"phase 13 {label}", batch, ranges,
                                micro=micro, cut=cut, grid=grid)
    out["smoke"] = families_train_card_vs_cpu(torch, ops, registry)
    launches = {k: sum(out[r[0]]["launches"][k] for r in runs)
                + out["smoke"]["launches"][k]
                for k in out["smoke"]["launches"]}
    return out, launches



# --------------------------------------------------------------------------
# phase 14: the examples' twins, the cached exported step, log2_histogram
# --------------------------------------------------------------------------

TWINS = ROOT / "examples" / "torch"
# twin -> (arguments beside --device cuda, runs in this process, the lines
# it must print: those tests/test_examples_smoke.py asserts of its JAX twin,
# and tests/test_torch_examples.py of it)
TWIN_RUNS = [
    ("quickstart.py", [], True, ["step 4: loss=", "per-layer probe hits"]),
    ("serve_demo.py", [], True, ["per-request generated tokens",
                                 "decode steps run:"]),
    ("train_e2e.py", ["--steps", "20"], True,
     ["model: 64M params", "latest checkpoint: step 20"]),
    ("train_e2e.py", ["--steps", "30", "--resume"], True,
     ["resumed from step 20", "latest checkpoint: step 30"]),
    ("moe_balance.py", [], True, ["total capacity drops across run:"]),
    ("opensnoop_syscalls.py", [], True,
     ["latest committed checkpoint: step 8", "OK"]),
    ("trace_training.py", [], True,
     ["did NOT restart", "jit cache of the running step stayed 1"]),
    ("fleet_agg.py", [], False,
     ["global total=768 (= 3 workers x 256 events)",
      "OK: global histogram is the exact bin-wise sum", "(AOT cache hit)",
      "12 workers -> 3 node aggregators (fan-in 4)",
      "OK: hierarchical tree view is bit-identical to the flat merge"]),
    ("chaos_drill.py", [], False,
     ["SIGKILLed mid-publish (seqlock left odd)",
      "daemon restarted from the fold journal",
      "OK: global view converged to the oracle",
      "OK: chaos drill survived worker SIGKILL + daemon crash"]),
]
AOT_KEY = ("chip_smoke phase 14",)
HIST_N = 1 << 26


def run_twins(torch, ops, tmp):
    """(a): each twin with --device cuda; the single-process ones in this
    process through main(), with the launches and the collected events
    around each call, the others as subprocesses. Returns one row a run."""
    import contextlib
    import importlib.util
    import io
    import os
    import tempfile
    from repro_torch.core import events as E

    emitted = [0]
    emit_row = E.Collector.emit_row

    def counting(self, row):
        emitted[0] += 1
        return emit_row(self, row)

    rows = []
    env = dict(os.environ, PYTHONPATH=str(SRC), TMPDIR=tmp,
               BPFTIME_SHM=os.path.join(tmp, "shm"))
    for twin, args, inproc, lines in TWIN_RUNS:
        argv = ["--device", "cuda", *args]
        what = f"phase 14 (a) {twin} {' '.join(args)}".strip()
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        emitted[0] = 0
        t0 = time.perf_counter()
        if inproc:
            spec = importlib.util.spec_from_file_location(
                f"twin_{twin[:-3]}", TWINS / twin)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            out = io.StringIO()
            old_tmp, old_shm = tempfile.tempdir, os.environ.get("BPFTIME_SHM")
            tempfile.tempdir = tmp
            os.environ["BPFTIME_SHM"] = env["BPFTIME_SHM"]
            E.Collector.emit_row = counting
            try:
                with contextlib.redirect_stdout(out):
                    rc = mod.main(argv)
            finally:
                E.Collector.emit_row = emit_row
                tempfile.tempdir = old_tmp
                if old_shm is None:
                    os.environ.pop("BPFTIME_SHM")
                else:
                    os.environ["BPFTIME_SHM"] = old_shm
            torch.cuda.synchronize()
            text = out.getvalue()
        else:
            res = subprocess.run([sys.executable, str(TWINS / twin), *argv],
                                 capture_output=True, text=True, env=env,
                                 cwd=tmp, timeout=400)
            rc, text = res.returncode, res.stdout
            if rc != 0:
                print(res.stderr[-3000:], file=sys.stderr)
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()
        if rc != 0:
            fail(f"{what} exited {rc}:\n{text[-2000:]}")
        missing = [ln for ln in lines if ln not in text]
        if missing:
            fail(f"{what} did not print {missing}:\n{text[-2000:]}")
        if inproc and launches["tensor_stats"] != emitted[0]:
            fail(f"{what}: tensor_stats launched {launches['tensor_stats']} "
                 f"times for {emitted[0]} collected events")
        row = {"twin": twin, "args": args, "wall_s": wall,
               "events": emitted[0] if inproc else None,
               "launches": launches}
        if twin == "fleet_agg.py":
            row["late_join"] = next(ln for ln in text.splitlines()
                                    if "late joiner" in ln)
        print(f"  {twin} {' '.join(args)}: exit 0 in {wall:.1f} s, events "
              f"{row['events']}, kernels {json.dumps(launches)}", flush=True)
        rows.append(row)
    return rows


def record_decode_tapes(torch, cfg):
    """Phase 3's serving (same seed, weights, requests and probes) with
    every probed decode step's tape, the maps it started from, its step and
    the maps the eager fused lane made of it recorded."""
    engine, reqs = serve(torch, cfg, "cuda")
    dec = engine._decode
    tapes = []

    def recording(params, tokens, cache, maps, step):
        out = dec(params, tokens, cache, maps, step)
        recording.last = dec.last             # the engine reads it
        if dec.last is not None:
            rows, maps_in, st, _ = dec.last
            tapes.append((rows, maps_in, st, out[3]))
        return out

    recording.last = None
    engine._decode = recording
    engine.submit_all(reqs)
    torch.cuda.synchronize()
    if len(tapes) != engine.step_count or not tapes:
        fail(f"phase 14 (b): {len(tapes)} tapes for {engine.step_count} "
             "decode steps")
    return engine, tapes


def aot_runtime(cfg):
    """Phase 3's serving runtime: the admission filter and SERVE_PROBES."""
    from repro_torch.core.runtime import BpftimeRuntime
    from repro_torch.launch import serve as L
    rt = BpftimeRuntime()
    pid = rt.load_asm("admit", L.admit_filter_text(12), [], "filter")
    rt.attach(pid, "filter:sys_serve_admit")
    L.attach_serve_probes(rt, L.family_probes(cfg))
    return rt


def _stage_args(torch, rows, maps_in, step, device="cuda"):
    from repro_torch.core import jit as J
    return (rows, maps_in, J.make_aux(time_ns=step, device=device))


def _stage_factory(rt, mode=None):
    return lambda: (lambda r, m, a: rt.probe_stage(r, m, a, mode=mode))


def _tapes_npz(torch, tapes, path):
    import numpy as np
    from repro_torch.core.runtime import to_numpy
    arrays = {}
    for k, (rows, maps_in, st, _) in enumerate(tapes):
        arrays[f"{k}/rows"] = rows.cpu().numpy()
        arrays[f"{k}/step"] = np.asarray(st)
        for name, fields in to_numpy(maps_in).items():
            for f, a in fields.items():
                arrays[f"{k}/maps/{name}/{f}"] = a
    np.savez(path, **arrays)


def _load_tapes(torch, path):
    import numpy as np
    with np.load(path) as z:
        n = 1 + max(int(k.split("/")[0]) for k in z.files)
        out = []
        for k in range(n):
            maps = {}
            for key in z.files:
                parts = key.split("/")
                if parts[0] == str(k) and parts[1] == "maps":
                    maps.setdefault(parts[2], {})[parts[3]] = \
                        torch.from_numpy(z[key]).cuda()
            out.append(_stage_args(torch, torch.from_numpy(
                z[f"{k}/rows"]).cuda(), maps, int(z[f"{k}/step"])))
    return out


def aot_child(src: str, spec_path: str, out_path: str) -> None:
    """A booting worker of phase 14 (b) (started with spawn, the port
    alone): phase 3's runtime on the card, its probe stage booted through
    aot_step on the given cache directory, then run over every recorded
    tape (launches counted per call) and timed beside the eager stage."""
    sys.path.insert(0, src)
    sys.modules["jax"] = None
    sys.modules["repro"] = None
    import numpy as np
    import torch
    from repro_torch.configs import registry
    from repro_torch.core import events as E
    from repro_torch.core.runtime import to_numpy
    from repro_torch.kernels import build, ops
    with open(spec_path) as f:
        spec = json.load(f)
    for name in spec["sites"]:                  # the parent's site ids
        E.SITES.get_or_create(name)
    build.build_all()                           # the parent's libraries
    rt = aot_runtime(registry.get(spec["arch"]))
    cache = rt.enable_artifact_cache(spec["cache"])
    tapes = _load_tapes(torch, spec["tapes"])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    step, hit = rt.aot_step(_stage_factory(rt), tapes[0],
                            extra_key=AOT_KEY + (tapes[0][0].shape[0],))
    boot_s = time.perf_counter() - t0
    arrays, per_call = {}, []
    for k, args in enumerate(tapes):
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        maps, _ = step(*args)
        torch.cuda.synchronize()
        per_call.append(ops.launch_counts())
        for name, fields in to_numpy(maps).items():
            for f, a in fields.items():
                arrays[f"{k}/{name}/{f}"] = a
    torch.cuda.synchronize()
    ops.reset_launch_counts()
    rt.probe_stage(*tapes[0])
    torch.cuda.synchronize()
    eager_call = ops.launch_counts()
    times = {}
    for what, fn in (("exported", lambda: step(*tapes[0])),
                     ("eager", lambda: rt.probe_stage(*tapes[0]))):
        times[what] = {"device_us": cuda_ms(torch, fn, 50) * 1e3,
                       "host_us": host_us(torch, fn, 50)}
    np.savez(out_path, **arrays)
    with open(out_path + ".json", "w") as f:
        json.dump({"hit": hit, "boot_s": boot_s,
                   "counters": dict(cache.counters),
                   "bytes": cache.stats()["bytes"],
                   "export_error": rt.last_export_error,
                   "per_call": per_call, "eager_call": eager_call,
                   "times": times}, f)


def boot_in_subprocess(spec_path: str, out_path: str) -> dict:
    import numpy as np
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    p = ctx.Process(target=aot_child, args=(str(SRC), spec_path, out_path))
    p.start()
    p.join(timeout=400)
    if p.is_alive():
        p.kill()
        p.join()
        fail("phase 14 (b): a booting worker did not finish in 400 s")
    if p.exitcode != 0:
        fail(f"phase 14 (b): a booting worker exited {p.exitcode}")
    with open(out_path + ".json") as f:
        info = json.load(f)
    with np.load(out_path) as z:
        info["maps"] = {k: z[k] for k in z.files}
    return info


def _maps_bad(got, want, k=None) -> list:
    """The fields of the map states `want` (tensors) that differ in `got`:
    map states too, or with `k` a flat dict of tape k's ("k/name/field")."""
    import numpy as np
    from repro_torch.core.runtime import to_numpy
    if k is None:
        got = {f"{name}/{f}": a for name, st in to_numpy(got).items()
               for f, a in st.items()}
    return [f"{name}.{f}" for name, st in to_numpy(want).items()
            for f, a in st.items()
            if not np.array_equal(got[f"{name}/{f}" if k is None
                                      else f"{k}/{name}/{f}"], a)]


def aot_full_width(torch, ops, cfg, tmp):
    """(b): phase 3's decode tapes, booted through aot_step in two spawned
    workers (a miss that stores, then a hit), a corrupted entry, and a
    scan-lane stage."""
    import os
    from repro_torch.core import events as E, faults as F
    engine, tapes = record_decode_tapes(torch, cfg)
    n_ev = tapes[0][0].shape[0]
    if any(t[0].shape[0] != n_ev for t in tapes):
        fail("phase 14 (b): the decode tapes differ in length")
    print(f"  (b) {len(tapes)} decode tapes of {n_ev} events recorded",
          flush=True)
    tapes_path = os.path.join(tmp, "tapes.npz")
    _tapes_npz(torch, tapes, tapes_path)
    known = E.SITES.known()
    spec = {"sites": sorted(known, key=known.get), "arch": cfg.name,
            "cache": os.path.join(tmp, "cache"), "tapes": tapes_path}
    spec_path = os.path.join(tmp, "spec.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    boots = [boot_in_subprocess(spec_path, os.path.join(tmp, f"boot{i}.npz"))
             for i in range(2)]
    first, second = boots
    if first["hit"] or first["counters"]["stores"] != 1 or \
            first["export_error"] is not None:
        fail(f"phase 14 (b): the first worker did not trace and store: "
             f"{first['counters']}, {first['export_error']}")
    if not second["hit"] or second["counters"]["hits"] != 1 or \
            second["counters"]["stores"] != 0:
        fail(f"phase 14 (b): the second worker missed: "
             f"{second['counters']}")
    for b in boots:
        for k, (_, _, _, want) in enumerate(tapes):
            bad = _maps_bad(b["maps"], want, k)
            if bad:
                fail(f"phase 14 (b): tape {k}: {bad} differ from the eager "
                     "fused lane")
        per = {name: {c[name] for c in b["per_call"]}
               for name in ("hash_fetch_add_batch", "ringbuf_emit_batch",
                            "tensor_stats", "table_interp")}
        if per != {"hash_fetch_add_batch": {1}, "ringbuf_emit_batch": {1},
                   "tensor_stats": {0}, "table_interp": {0}} or \
                b["eager_call"]["hash_fetch_add_batch"] != 1 or \
                b["eager_call"]["ringbuf_emit_batch"] != 1:
            fail(f"phase 14 (b): launches per exported call {per}, per "
                 f"eager call {b['eager_call']}")
    out = {"tapes": len(tapes), "events": n_ev,
           "export_s": first["boot_s"], "load_ms": second["boot_s"] * 1e3,
           "stored_bytes": first["bytes"],
           "exported": second["times"]["exported"],
           "eager": second["times"]["eager"],
           "miss_worker_times": first["times"],
           "launches_per_exported_call": first["per_call"][0]}
    print(f"  (b) export {out['export_s']:.2f} s, load "
          f"{out['load_ms']:.1f} ms, {out['stored_bytes']} bytes stored; "
          f"per call: exported {out['exported']['device_us']:.0f} us device, "
          f"{out['exported']['host_us']:.0f} us host; eager "
          f"{out['eager']['device_us']:.0f} us device, "
          f"{out['eager']['host_us']:.0f} us host", flush=True)

    # the corrupted-artifact drill, on the card in this process
    drill = os.path.join(tmp, "drill")
    args0 = _stage_args(torch, *tapes[0][:3])
    counters = []
    for k in range(3):
        rt = aot_runtime(cfg)
        rt.enable_artifact_cache(drill)
        ctx = (F.plan(F.FaultPlan(seed=0, rates={"corrupt_artifact": 1.0}))
               if k == 0 else contextlib.nullcontext())
        t0 = time.perf_counter()
        with ctx:
            step, hit = rt.aot_step(_stage_factory(rt), args0,
                                    extra_key=AOT_KEY + (n_ev,))
        boot = time.perf_counter() - t0
        counters.append(dict(rt.artifact_cache.counters))
        if hit != (k == 2):
            fail(f"phase 14 (b) drill: boot {k} hit={hit}: {counters}")
        bad = _maps_bad(step(*args0)[0], tapes[0][3])
        if bad:
            fail(f"phase 14 (b) drill: boot {k}: {bad} differ")
        counters[-1]["boot_s"] = boot
    if counters[1]["corrupt"] != 1 or counters[1]["stores"] != 1:
        fail(f"phase 14 (b) drill: the corrupt entry was not dropped and "
             f"stored again: {counters}")
    out["drill"] = counters
    print(f"  (b) corrupted entry detected, dropped and traced again: "
          f"{counters[1]}", flush=True)

    # a scan-lane stage cannot be exported: run eagerly, nothing stored
    rt = aot_runtime(cfg)
    cache = rt.enable_artifact_cache(os.path.join(tmp, "scan"))
    step, hit = rt.aot_step(_stage_factory(rt, "scan"), args0,
                            extra_key=AOT_KEY + (n_ev, "scan"))
    if hit or cache.counters["unexportable"] != 1 or cache.ls():
        fail(f"phase 14 (b): the scan-lane stage: hit={hit}, "
             f"{cache.counters}, entries {cache.ls()}")
    bad = _maps_bad(step(*args0)[0], tapes[0][3])
    if bad:
        fail(f"phase 14 (b): the scan-lane stage's {bad} differ")
    out["scan"] = {"unexportable": cache.counters["unexportable"],
                   "error": (rt.last_export_error or "")[:200]}
    launches = {k: sum(c[k] for b in boots for c in b["per_call"])
                for k in boots[0]["per_call"][0]}
    del engine
    return out, launches


def hist_card_vs_cpu(torch, ops):
    """(c): log2_histogram of a 64 Mi-element f32 tensor with zeros,
    negatives, NaN, +-Inf, subnormals and values past 2**46 (whose Q47.16
    value clips at 2**62), on the card against the CPU, bit for bit."""
    g = torch.Generator(device="cuda").manual_seed(SEED)
    x = torch.randn(HIST_N, generator=g, device="cuda") * torch.exp2(
        torch.randint(-40, 80, (HIST_N,), generator=g, device="cuda")
        .float())
    specials = torch.tensor(
        [0.0, -0.0, -1.0, float("nan"), float("inf"), -float("inf"),
         1e-39, -1e-40, 2.0**-16, 2.0**46, 2.0**47, 2.0**62, 3.0e38],
        device="cuda")
    x[:specials.numel()] = specials
    x[HIST_N // 2::4097] = float("nan")
    got = ops.log2_histogram(x)
    want = ops.log2_histogram(x.cpu())
    if not torch.equal(got.cpu(), want):
        fail(f"phase 14 (c): log2_histogram on the card {got.tolist()} != "
             f"the CPU's {want.tolist()}")
    ms = cuda_ms(torch, lambda: ops.log2_histogram(x), 20)
    b_ms, b_by = bound_ms(4 * HIST_N + 8 * 64, 0)
    out = {"numel": HIST_N, "device_ms": ms, "bound_ms": b_ms,
           "bound_by": b_by, "total": int(got.sum()),
           "bin0": int(got[0]), "bin63": int(got[63])}
    print(f"  (c) log2_histogram of {HIST_N} f32 on the card: equal to the "
          f"CPU's; {ms:.3f} ms (bound {b_ms:.3f} ms)", flush=True)
    return out


def phase14(torch, ops, cfg):
    """(a), (b), (c); returns the results and the launches of (a) and
    (b)'s exported calls."""
    import shutil
    out = {}
    tmp = scratch_dir(8 << 30, "phase 14")
    try:
        out["twins"] = run_twins(torch, ops, tmp)
        gc.collect()
        torch.cuda.empty_cache()
        out["aot"], aot_launches = aot_full_width(torch, ops, cfg, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    gc.collect()
    torch.cuda.empty_cache()
    out["log2_histogram"] = hist_card_vs_cpu(torch, ops)
    launches = {k: sum(r["launches"][k] for r in out["twins"])
                + aot_launches[k] for k in aot_launches}
    return out, launches



# --------------------------------------------------------------------------
# phase 15: expert parallelism, elastic restore, the dry run
# --------------------------------------------------------------------------

def ep_on_card(torch, ops, cfg, params):
    """Phase 15 (a), inside phase 11 (a): the expert-parallel path of
    `cfg` (llama4-scout at full width) on a (1, 1) mesh, NCCL at world
    size 1, against the same steps with REPRO_MOE_EP off. The kernel
    counts are set to 0 just before the switch-on run and read just
    after it."""
    import os
    import numpy as np
    from repro_torch.core.runtime import BpftimeRuntime, to_numpy
    from repro_torch.dist import expert_parallel as EP, sharding as SH
    from repro_torch.launch import serve as L
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.models import registry as MR
    from repro_torch.serve.steps import make_decode_step, make_prefill_step
    print("  phase 15 (a): llama4-scout's experts behind the mesh's 'model' "
          "axis (REPRO_MOE_EP=1, NCCL at world size 1)", flush=True)
    t_start = time.perf_counter()
    mesh = make_host_mesh((1, 1), device="cuda")
    n_moe = layers_of(cfg, lambda j: cfg.ffn_kind(j) == "moe")
    rng = np.random.default_rng(SEED)
    prompts = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                           (EP_BATCH, EP_PROMPT)),
                              device="cuda")
    long_toks = torch.as_tensor(rng.integers(0, cfg.vocab_size,
                                             (1, LONG_PREFILL)),
                                device="cuda")

    def switch(on):
        os.environ["REPRO_MOE_EP"] = "1" if on else "0"

    def decode_run(on, keep):
        """A probed prefill then EP_STEPS probed decode steps: per step
        the logits, the maps (keep) and the host ms, and the gathers."""
        rt = BpftimeRuntime()
        L.attach_serve_probes(rt, L.family_probes(cfg))
        prefill = make_prefill_step(cfg, rt)
        decode = make_decode_step(cfg, rt, probe_mode="fused")
        maps = rt.init_device_maps("cuda")
        cache = MR.make_cache(cfg, EP_BATCH, EP_PROMPT + EP_STEPS + 1,
                              torch.float32, "cuda")
        switch(on)
        logits_all, maps_all, ms, gathers = [], [], [], []
        with SH.use_mesh(mesh):
            logits, cache, maps = prefill(params, {"tokens": prompts},
                                          cache, maps)
            tok = torch.argmax(logits[:, -1, :cfg.vocab_size], -1)[:, None]
            for i in range(EP_STEPS):
                g0 = EP.GATHERS
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                nxt, logits, cache, maps = decode(params, tok, cache, maps,
                                                  i + 1)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                gathers.append(EP.GATHERS - g0)
                tok = nxt[:, None].to(torch.int64)
                if keep:
                    logits_all.append(logits.clone())
                    maps_all.append(to_numpy(maps))
        switch(False)
        return logits_all, maps_all, ms, gathers

    def long_run(on):
        switch(on)
        g0 = EP.GATHERS
        with SH.use_mesh(mesh):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            logits = MR.prefill_fn(params, {"tokens": long_toks},
                                   MR.make_cache(cfg, 1, LONG_PREFILL,
                                                 torch.float32, "cuda"),
                                   cfg)[0]
            torch.cuda.synchronize()
        switch(False)
        return logits, (time.perf_counter() - t0) * 1e3, EP.GATHERS - g0

    try:
        off = decode_run(False, True)
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        on = decode_run(True, True)
        long_on, long_on_ms, long_gathers = long_run(True)
        torch.cuda.synchronize()
        launches = ops.launch_counts()
        long_off, long_off_ms, _ = long_run(False)
        # logits and maps, bit for bit
        for i, (a, b) in enumerate(zip(on[0], off[0])):
            if not _leaf_bits_equal(torch, a, b):
                fail(f"phase 15 (a): decode step {i + 1}'s logits differ "
                     "with REPRO_MOE_EP=1")
        for i, (a, b) in enumerate(zip(on[1], off[1])):
            bad = [f"{m}.{f}" for m, st in b.items() for f, x in st.items()
                   if not np.array_equal(a[m][f], x)]
            if bad:
                fail(f"phase 15 (a): after decode step {i + 1} the maps "
                     f"{bad[:4]} differ with REPRO_MOE_EP=1")
        if not _leaf_bits_equal(torch, long_on, long_off):
            fail(f"phase 15 (a): the {LONG_PREFILL}-token prefill's logits "
                 "differ with REPRO_MOE_EP=1")
        del long_on, long_off
        if on[3] != [n_moe] * EP_STEPS or long_gathers != n_moe or \
                any(off[3]):
            fail(f"phase 15 (a): expert gathers per step {on[3]} (prefill "
                 f"{long_gathers}, switch off {off[3]}), not one per MoE "
                 f"layer ({n_moe})")
        if any(launches[k] == 0 for k in SERVING_KERNELS) or \
                launches["flash_fwd"] != attention_layers(cfg):
            fail(f"phase 15 (a): kernels {launches}: every serving kernel, "
                 f"and the flash forward once per attention layer in the "
                 f"{LONG_PREFILL}-token prefill")
        events = EP_STEPS * events_per_step(cfg)
        if launches["tensor_stats"] < events:
            fail(f"phase 15 (a): tensor_stats launched "
                 f"{launches['tensor_stats']} times for at least {events} "
                 "decode events")
        # the collective on the card: one profiled switch-on decode step
        nccl = _nccl_ops(torch, lambda: decode_run(True, False))
        # timed passes in turns: off, on, on, off
        timed = {"on": [], "off": []}
        for flag in (False, True, True, False):
            timed["on" if flag else "off"].append(decode_run(flag, False)[2])
        prefill_ms = {"on": [long_on_ms], "off": [long_off_ms]}
        for flag in (True, False):
            prefill_ms["on" if flag else "off"].append(long_run(flag)[1])
    finally:
        switch(False)
    med = {k: sorted(x for run in v for x in run[1:])[
        len(v) * (EP_STEPS - 1) // 2] for k, v in timed.items()}
    out = {"moe_layers": n_moe, "gathers_per_step": on[3],
           "gathers_long_prefill": long_gathers, "launches": launches,
           "nccl_device_ops_one_step": nccl, "decode_ms": timed,
           "decode_ms_median": med, "prefill_ms": prefill_ms,
           "s": time.perf_counter() - t_start}
    print(f"  (a) {EP_STEPS} probed decode steps and a {LONG_PREFILL}-token "
          f"prefill: logits and maps bit for bit the switch-off steps; "
          f"{n_moe} expert gathers a step ({on[3]}), {long_gathers} in the "
          f"prefill; profiled step's NCCL device operations {nccl}; "
          f"kernels {json.dumps(launches)}", flush=True)
    print(f"  (a) ms per decode step (median, steps 2-{EP_STEPS} of two "
          f"passes each): on {med['on']:.2f}, off {med['off']:.2f}; "
          f"{LONG_PREFILL}-token prefill on "
          f"{', '.join(f'{m:.1f}' for m in prefill_ms['on'])}, off "
          f"{', '.join(f'{m:.1f}' for m in prefill_ms['off'])} ms; "
          f"(a) took {out['s']:.1f} s", flush=True)
    return out


def _nccl_ops(torch, fn) -> dict:
    """Device operations named like NCCL's kernels, or copies, in one
    profiled call of fn (world size 1: NCCL may copy instead of launching
    a kernel)."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.key_averages():
        if _is_device(e) and ("nccl" in e.key.lower() or
                              "allgather" in e.key.lower()):
            out[e.key] = e.count
    return out


def _same_on_device(torch, a, b) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        view = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
            a.element_size()]
        a, b = a.view(view), b.view(view)
    return torch.equal(a, b)


def elastic_restore(torch, ck, like, plain, plain_s, device="cuda"):
    """Phase 15 (b), inside phase 9 (c): step_1 restored again onto a
    (1, 1) mesh (NCCL at world size 1 on the card) with shardings from
    spec_for over the state tree; every leaf's full_tensor() held bit for
    bit against the plain restore."""
    from repro_torch.ckpt import checkpoint as CK
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.launch.specs import state_shardings
    from repro_torch.optim import tree_leaves
    import torch.distributed.tensor as DT
    t_start = time.perf_counter()
    mesh = make_host_mesh((1, 1), device=device)
    shardings = state_shardings(like, mesh)
    place, spent = DT.distribute_tensor, []

    def timed_place(*a, **kw):              # the placing, apart from reads
        t = time.perf_counter()
        out = place(*a, **kw)
        torch.cuda.synchronize()
        spent.append(time.perf_counter() - t)
        return out
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    DT.distribute_tensor = timed_place
    try:
        placed = CK.restore(ck, 1, like, mesh=mesh, shardings=shardings)
    finally:
        DT.distribute_tensor = place
    torch.cuda.synchronize()
    s = time.perf_counter() - t0
    leaves = tree_leaves(placed)
    sharded = sum(any(p.is_shard() for p in t.placements) for t in leaves)
    bad = [i for i, (a, b) in enumerate(zip(leaves, tree_leaves(plain)))
           if not _same_on_device(torch, a.full_tensor(), b)]
    if bad or len(leaves) != len(tree_leaves(plain)):
        fail(f"phase 15 (b): the elastic restore differs from the plain "
             f"one in leaves {bad[:8]}")
    del placed, leaves
    out = {"restore_s": s, "plain_restore_s": plain_s,
           "distribute_s": sum(spent), "first_distribute_s": spent[0],
           "leaves": len(tree_leaves(plain)), "sharded_leaves": sharded,
           "s": time.perf_counter() - t_start}
    print(f"  phase 15 (b): step_1 restored onto a (1, 1) mesh "
          f"({out['leaves']} leaves, {sharded} with a Shard placement) in "
          f"{s:.2f} s (plain restore {plain_s:.2f} s), distribute_tensor "
          f"{sum(spent):.2f} s of it (the first leaf {spent[0]:.2f} s): "
          "every full_tensor() bit for bit the plain restore", flush=True)
    return out


DRYRUN_CELL = ("qwen2-0.5b", "train_4k")


def dryrun_start(tmp):
    """Phase 15 (c), started before phase 13 (device-bound training
    leaves the host's cores free) and read in phase 15: one dry-run cell
    in a subprocess that sees no card. Returns (process, start time)."""
    import atexit
    import os
    arch, shape = DRYRUN_CELL
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="", PYTHONPATH=str(SRC))
    code = ("import sys; sys.modules['jax'] = None; "
            "sys.modules['repro'] = None; "
            "from repro_torch.launch import dryrun; dryrun.main(sys.argv[1:])")
    proc = subprocess.Popen([sys.executable, "-c", code, "--arch", arch,
                             "--shape", shape, "--probes", "--probe-mode",
                             "fused", "--out", tmp], stdout=subprocess.PIPE,
                            stderr=subprocess.PIPE, text=True, env=env,
                            cwd=tmp)
    atexit.register(proc.kill)          # a failed phase leaves no process
    return proc, time.perf_counter()


def dryrun_cell(started, tmp, phase7) -> dict:
    """Phase 15 (c): the dry run's cell read back; its roofline beside
    phase 7's measured step per 4096-token sequence (train_4k's 256
    sequences over 256 cards: one a card)."""
    import os
    arch, shape = DRYRUN_CELL
    proc, t_start = started
    t0 = time.perf_counter()
    try:
        stdout, stderr = proc.communicate(timeout=300)
    except subprocess.TimeoutExpired:
        proc.kill()
        fail("phase 15 (c): the dry run did not finish in 300 s")
    waited = time.perf_counter() - t0
    path = os.path.join(tmp, f"{arch}__{shape}__sp__probes.json")
    if proc.returncode != 0 or not os.path.exists(path):
        fail(f"phase 15 (c): the dry run failed: {stdout[-1500:]} "
             f"{stderr[-1500:]}")
    with open(path) as f:
        d = json.load(f)
    if "error" in d:
        fail(f"phase 15 (c): the dry run wrote an error: {d['error']}")
    rf = d["roofline"]
    step_s = phase7["tokens_per_step"] / phase7["tokens_per_s_warm"]
    per_seq = step_s * 4096 / phase7["tokens_per_step"]
    out = {"arch": arch, "shape": shape, "mesh": d["mesh"],
           "trace_s": d["trace_s"], "total_s": d["total_s"],
           "ops": d["ops"], "roofline": rf,
           "roofline_unfused_attention": d["roofline_unfused_attention"],
           "collectives": d["collectives"],
           "phase7_step_s": step_s, "phase7_s_per_sequence": per_seq,
           "since_start_s": time.perf_counter() - t_start,
           "waited_s": waited}
    print(f"  phase 15 (c): dry run {arch} x {shape} on a "
          f"{'x'.join(map(str, d['mesh']))} mesh, no card visible: "
          f"{d['ops']} operations traced in {d['trace_s']} s; per card "
          f"compute {rf['compute_s']:.4f} s, memory {rf['memory_s']:.4f} s, "
          f"collective {rf['collective_s']:.4f} s, dominant "
          f"{rf['dominant']}, roofline fraction "
          f"{rf['roofline_fraction']:.3f}; phase 7's measured step "
          f"{step_s:.3f} s for {phase7['tokens_per_step']} tokens = "
          f"{per_seq:.3f} s per 4096-token sequence ("
          f"{per_seq / max(rf['compute_s'], rf['memory_s'], rf['collective_s']):.1f}x "
          f"the bound); {d['total_s']} s in its process, started "
          f"{out['since_start_s']:.1f} s ago beside phases 13-14, "
          f"{waited:.1f} s waited for here", flush=True)
    return out


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
    # phase 11's shapes too: llama4-scout's block and logits, the router's
    # moe.load ([16]) and moe.drops ([1]), mamba2's block and logits; and
    # phase 12's: seamless's enc.in/enc.block and decode.logits, qwen2-vl's
    # block and logits; and phase 13's block entries: mamba2's, qwen2-vl's
    # and llama4-scout's at 4096 tokens
    ts_err, ts_rows = check_tensor_stats(torch, TS, ref, ref.to_fx, [
        ((4, 1, d), bf16, False), ((4, 1, d), bf16, True),
        ((4, 1, pv), f32, True), ((2, 4096, d), bf16, True),
        ((1 << 26,), f32, True), ((1,), f32, False),
        ((4, 1, 5120), bf16, False), ((16,), f32, False),
        ((4, 1, 202240), f32, True), ((4, 1, 1536), bf16, False),
        ((4, 1, 50432), f32, True), ((4, 4096, 1024), bf16, True),
        ((4, 1, 256256), f32, True), ((4, 1, 8192), bf16, False),
        ((4, 1, 152064), f32, False), ((4, 4096, 1536), bf16, True),
        ((1, 4096, 8192), bf16, False), ((1, 4096, 5120), bf16, True)])
    tomb = dict(tombstones=True, full=False)
    hash_rows = check_hash(torch, HU, ref, M, [
        ("path", 256, L2, dict(tombstones=False, full=False)),
        ("tombstones", 256, 4096, tomb),
        ("full", 256, 4096, dict(tombstones=False, full=True)),
        ("global path", 16384, L2, tomb),
        ("global 4096", 16384, 4096, tomb),
        ("moe path", 256, 17, dict(tombstones=False, full=False)),
        ("ssm path", 256, 145, dict(tombstones=False, full=False)),
        ("encdec prefill", 64, 13, dict(tombstones=False, full=False)),
        ("vlm path", 256, 9, dict(tombstones=False, full=False)),
    ])
    rb_rows = check_ringbuf(torch, RB, ref, [
        ("path", 64, L2, 4), ("B<cap", 64, 40, 4), ("B>cap", 64, 4096, 4),
        ("empty", 64, 0, 4), ("moe path", 64, 17, 4),
        ("ssm path", 64, 145, 4), ("encdec decode", 64, 1, 4),
        ("vlm path", 64, 9, 4),
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
    if any(launches[k] == 0 for k in SERVING_KERNELS):
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
    replay_modes(engine, "phase 4")

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

    # ---- phase 11
    print("phase 11: the MoE, SSM and hybrid families: llama4-scout at full "
          f"width ({LLAMA4_LAYERS} of 48 layers), mamba2-780m whole, and "
          "llama4-scout, mamba2 and jamba at smoke width on the card and "
          "the CPU", flush=True)
    t11 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    families = {"llama4": llama4_full(torch, ops, registry)}
    gc.collect()
    torch.cuda.empty_cache()
    families["mamba2"] = mamba2_whole(torch, ops, registry)
    gc.collect()
    torch.cuda.empty_cache()
    families["smoke"] = families_card_vs_cpu(torch, ops, registry)
    families["phase_s"] = time.perf_counter() - t11
    print(f"  phase 11 took {families['phase_s']:.1f} s", flush=True)
    p11_runs = [families["llama4"], families["mamba2"],
                *families["smoke"].values()]
    p11 = {k: sum(r["launches"][k] for r in p11_runs)
           for k in p11_runs[0]["launches"]}

    # ---- phase 12
    print("phase 12: the encoder-decoder and VLM families: seamless-m4t-"
          f"medium whole, qwen2-vl-72b at full width ({QWEN2_VL_LAYERS} of "
          "80 layers) with M-RoPE, and both at smoke width on the card and "
          "the CPU", flush=True)
    t12 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    encvlm = {"seamless": seamless_whole(torch, ops, FA, ref, registry)}
    gc.collect()
    torch.cuda.empty_cache()
    encvlm["qwen2_vl"] = qwen2vl_full(torch, ops, FA, ref, registry)
    gc.collect()
    torch.cuda.empty_cache()
    encvlm["smoke"] = new_families_card_vs_cpu(torch, ops, registry)
    encvlm["phase_s"] = time.perf_counter() - t12
    print(f"  phase 12 took {encvlm['phase_s']:.1f} s", flush=True)
    p12_runs = [encvlm["seamless"], encvlm["qwen2_vl"],
                encvlm["qwen2_vl"]["multimodal"],
                *encvlm["smoke"].values()]
    p12 = {k: sum(r["launches"][k] for r in p12_runs)
           for k in p12_runs[0]["launches"]}
    p12["flash_fwd"] += encvlm["qwen2_vl"]["multimodal"][
        "launches_prefill"]["flash_fwd"]

    # phase 15 (c) runs beside phases 13 and 14: it needs no card
    import tempfile
    dry_tmp = tempfile.mkdtemp(prefix="chip_smoke_dryrun_")
    dry = dryrun_start(dry_tmp)

    # ---- phase 13
    print("phase 13: the MoE, SSM, encoder-decoder and VLM families trained "
          "at the reference's presets: the flash backward at their shapes; "
          f"mamba2-780m and seamless-m4t-medium whole, qwen2-vl-72b and "
          f"llama4-scout at full width ({TRAIN_CUT_LAYERS} layer), seq "
          f"{TRAIN_SEQ}, {TRAIN_STEPS} steps; the four at smoke width on the "
          "card and the CPU", flush=True)
    t13 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    fam_train, p13 = phase13(torch, ops, FA, ref, registry)
    fam_train["phase_s"] = time.perf_counter() - t13
    print(f"  phase 13 took {fam_train['phase_s']:.1f} s", flush=True)

    # ---- phase 14
    print("phase 14: the eight examples' twins on the card; qwen2-0.5b's "
          "probe stage at full width booted through aot_step in two "
          "workers, a corrupted entry and a scan-lane stage; "
          "log2_histogram card vs CPU", flush=True)
    t14 = time.perf_counter()
    gc.collect()
    torch.cuda.empty_cache()
    examples, p14 = phase14(torch, ops, cfg)
    examples["phase_s"] = time.perf_counter() - t14
    print(f"  phase 14 took {examples['phase_s']:.1f} s", flush=True)

    # ---- phase 15
    print("phase 15: distribution and tooling: (a) llama4-scout's expert-"
          "parallel steps (run inside phase 11), (b) the elastic restore "
          "(inside phase 9), (c) the dry run of qwen2-0.5b x train_4k with "
          "no card", flush=True)
    try:
        dist15 = {"ep": families["llama4"].pop("phase15"),
                  "elastic": fleet["ckpt"].pop("phase15"),
                  "dryrun": dryrun_cell(dry, dry_tmp, train)}
    finally:
        shutil.rmtree(dry_tmp, ignore_errors=True)
    # (c) ran beside phases 13-14: its share is the time waited for here
    dist15["phase_s"] = dist15["ep"]["s"] + dist15["elastic"]["s"] + \
        dist15["dryrun"]["waited_s"]
    print(f"  phase 15 took {dist15['phase_s']:.1f} s ((a) "
          f"{dist15['ep']['s']:.1f}, (b) {dist15['elastic']['s']:.1f}, (c) "
          f"{dist15['dryrun']['waited_s']:.1f} waited, "
          f"{dist15['dryrun']['total_s']} in its process)", flush=True)
    p15 = dist15["ep"]["launches"]
    import torch.distributed as dist
    if dist.is_initialized():
        dist.destroy_process_group()

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
                "phase11_launches": p11[name],
                "phase12_launches": p12[name],
                "phase13_launches": p13[name],
                "phase14_launches": p14[name],
                "phase15_launches": p15[name], "shapes": shapes}

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
              fa_fwd["max_abs_err"], fa_fwd,
              [fa_fwd, encvlm["seamless"]["flash_fwd"],
               encvlm["qwen2_vl"]["flash_fwd"], *fam_train["flash_fwd"]]),
        entry("flash_bwd", "flash_attention_sm90.cuh",
              "src/repro/kernels/flash_attention.py:130", tl["flash_bwd"],
              max(r["max_abs_err"]
                  for r in [fa_bwd, *fam_train["flash_bwd"]]),
              fa_bwd, [fa_bwd, *fam_train["flash_bwd"]]),
    ], "serve": {"served": len(served), "rejected": len(reqs) - len(served),
                 "decode_steps": engine_steps,
                 "tokens_per_s": tokens / wall, "events": engine_events,
                 **times},
        "live": live,
        "train": train, "fleet": fleet, "aggregator": aggregator,
        "fuzz": fuzz, "families": families, "encdec_vlm": encvlm,
        "family_training": fam_train, "examples": examples,
        "distribution": dist15,
        "train_launches_of_serving_kernels": {
            k: tl[k] for k in SERVING_KERNELS},
        "flash_sm90_build": sm90_build, "probe_build": probe_build}
    print(json.dumps(report), flush=True)
    print(card_line(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
