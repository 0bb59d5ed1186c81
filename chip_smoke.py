#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py              # all phases; needs one CUDA device
    python3 chip_smoke.py --kernels    # phases 1-2 only (build + checks)

Phases:
  1. build the four Hopper kernel sources from src/repro_torch/kernels/csrc
     with nvcc (one process per source, in parallel); print each bf16 flash
     kernel's registers, spill bytes and shared memory (ptxas -v) and its
     HGMMA (wgmma) instructions in `cuobjdump -sass` of the library, and
     fail if one has no HGMMA;
  2. hold each kernel against its plain PyTorch version on the card, at the
     main paths' shapes and at stress shapes, and time both; flash
     attention forward and backward also against
     scaled_dot_product_attention's forward and its backward alone (the
     yardsticks, never called by the port), and the backward twice for
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
  5. serve again warm (host clock) and once under torch.profiler: device
     busy share and device time by kernel group;
  6. train qwen2-0.5b at full width through launch/train.run_training:
     seq 4096, global batch 4 in microbatches of 2, AdamW, remat, 3 steps,
     the TRAIN_PROBES set on the fused lane (layer counters, a gradient-norm
     histogram, a loss record and a NaN guard); every attention layer runs
     the flash kernels, forward (and again in the remat recompute) and
     backward, and all five kernels must have launched. Then one more step
     under torch.profiler: device busy share and time by kernel group;
  7. one training step of the smoke-width model (f32) at seq 4096 on the
     card and on the CPU from the same weights and batch: loss, gradient
     norm, updated parameters and maps compared.

Prints a JSON line of per-kernel numbers, the card's name and power limit,
and as its last line {"ok": true, "device": {...}}. Any failure exits
non-zero; without CUDA, or without the repository beside it, it exits
non-zero before printing any result. No JAX is imported.
"""
from __future__ import annotations

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


def ptxas_report(log: str) -> dict:
    """{kernel: registers, spill bytes, shared memory} of the bf16 flash
    kernels, from nvcc's -Xptxas=-v output."""
    out, cur = {}, None
    for line in log.splitlines():
        m = re.search(r"(?:Compiling entry function '|Function properties "
                      r"for )(\w+)", line)
        if m:
            cur = _sm90_label(m.group(1))
            if cur:
                out.setdefault(cur, {})
            continue
        if cur is None:
            continue
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


# --------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# --------------------------------------------------------------------------

def check_tensor_stats(torch, TS, ref, shapes):
    """Returns (max abs err, per-shape timings)."""
    gen = torch.Generator(device="cuda")
    gen.manual_seed(SEED)
    worst, rows = 0.0, []
    for shape, dtype, seed_bad in shapes:
        x = torch.randn(shape, generator=gen, device="cuda") * 3.0
        if seed_bad:
            flat = x.view(-1)
            idx = torch.randint(0, flat.numel(), (64,), generator=gen,
                                device="cuda")
            flat[idx[:16]] = float("nan")
            flat[idx[16:24]] = float("inf")
            flat[idx[24:32]] = float("-inf")
        x = x.to(dtype)
        got = TS.tensor_stats_cuda(x)
        again = TS.tensor_stats_cuda(x)
        want = ref.tensor_stats(x)
        torch.cuda.synchronize()
        for k in got:
            if not torch.equal(got[k], again[k]):
                fail(f"tensor_stats {shape} {dtype}: {k} differs between "
                     "two runs")
        for k in ("nan_cnt", "inf_cnt"):
            if int(got[k]) != int(want[k]):
                fail(f"tensor_stats {shape} {dtype}: {k} {int(got[k])} != "
                     f"{int(want[k])}")
        for k in ("mean", "rms", "min", "max", "absmax"):
            g, w = float(got[k]), float(want[k])
            if abs(g - w) > STATS_TOL + STATS_TOL * abs(w):
                fail(f"tensor_stats {shape} {dtype}: {k} {g} vs plain {w}")
            worst = max(worst, abs(g - w))
        n = x.numel()
        reps = 20 if n > 1 << 24 else 200
        ms = cuda_ms(torch, lambda: TS.tensor_stats_cuda(x), reps)
        plain = cuda_ms(torch, lambda: ref.tensor_stats(x), max(reps // 10, 5))
        bms, by = bound_ms(n * x.element_size() + 5 * 4 + 2 * 8, 8.0 * n)
        rows.append({"shape": list(shape), "dtype": str(dtype).split(".")[-1],
                     "ms": ms, "plain_ms": plain, "bound_ms": bms,
                     "bound_by": by})
        print(f"  tensor_stats {tuple(shape)} {rows[-1]['dtype']}: kernel "
              f"{ms:.4f} ms, plain {plain:.4f} ms, bound {bms:.5f} ms "
              f"({by}), GB/s {n * x.element_size() / ms / 1e6:.1f}",
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


def check_hash(torch, HU, ref, M, cases):
    import numpy as np
    rng = np.random.default_rng(SEED)
    rows = []
    for label, n, batch, kw in cases:
        st, keys, deltas, valid = _hash_case(torch, M, n, batch, rng, **kw)
        dev = [torch.as_tensor(a, device="cuda") for a in
               (st["keys"], st["used"], st["values"], keys, deltas, valid)]
        got = HU.hash_fetch_add_batch_cuda(*dev)
        want = ref.hash_fetch_add_batch(*dev)
        oracle = {f: a.copy() for f, a in st.items()}
        M.n_hash_fetch_add_batch(oracle, keys, deltas, valid)
        for f, g, w in zip(("keys", "used", "values"), got, want):
            if not torch.equal(g, w):
                fail(f"hash {label}: {f} differs from the plain version")
            if not np.array_equal(g.cpu().numpy(), oracle[f]):
                fail(f"hash {label}: {f} differs from the numpy twin")
        ms = cuda_ms(torch, lambda: HU.hash_fetch_add_batch_cuda(*dev), 50)
        plain = cuda_ms(torch, lambda: ref.hash_fetch_add_batch(*dev), 1,
                        warmup=1)
        bms, by = bound_ms(batch * 17 + 6 * n * 8, 4.0 * batch)
        rows.append({"case": label, "n": n, "batch": batch, "ms": ms,
                     "plain_ms": plain, "bound_ms": bms, "bound_by": by})
        print(f"  hash {label} n={n} B={batch}: kernel {ms:.4f} ms, plain "
              f"{plain:.3f} ms, bound {bms:.6f} ms ({by}), bit-identical",
              flush=True)
    return rows


def check_ringbuf(torch, RB, ref, cases):
    import numpy as np
    rng = np.random.default_rng(SEED + 1)
    rows = []
    for label, cap, batch, width in cases:
        data = rng.integers(-9, 9, size=(cap, width))
        head = np.array([int(rng.integers(0, 3 * cap))])
        recs = rng.integers(-(1 << 40), 1 << 40, size=(batch, width))
        valid = rng.random(batch) < 0.7
        dev = [torch.as_tensor(a, device="cuda")
               for a in (data, head, recs, valid)]
        got = RB.ringbuf_emit_batch_cuda(*dev)
        want = ref.ringbuf_emit_batch(*dev)
        for f, g, w in zip(("data", "head"), got, want):
            if not torch.equal(g, w):
                fail(f"ringbuf {label}: {f} differs from the plain version")
        ms = cuda_ms(torch, lambda: RB.ringbuf_emit_batch_cuda(*dev), 50)
        plain = cuda_ms(torch, lambda: ref.ringbuf_emit_batch(*dev), 1,
                        warmup=1)
        bms, by = bound_ms(batch + batch * width * 8 + 2 * cap * width * 8
                           + 16, 2.0 * batch)
        rows.append({"case": label, "cap": cap, "batch": batch, "ms": ms,
                     "plain_ms": plain, "bound_ms": bms, "bound_by": by})
        print(f"  ringbuf {label} cap={cap} B={batch} W={width}: kernel "
              f"{ms:.4f} ms, plain {plain:.3f} ms, bound {bms:.6f} ms "
              f"({by}), bit-identical", flush=True)
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
          max_seq=128, max_new=8, admit_limit=12):
    from repro_torch.core.runtime import BpftimeRuntime
    from repro_torch.launch import serve as L
    from repro_torch.models import registry as MR
    from repro_torch.serve.engine import ServeEngine

    rt = BpftimeRuntime()
    pid = rt.load_asm("admit", L.admit_filter_text(admit_limit), [],
                      "filter")
    rt.attach(pid, "filter:sys_serve_admit")
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


PROBE_GROUPS = {"probe kernels": ("stats_partial", "stats_final", "hash_",
                                  "ringbuf_emit"),
                "matmul": ("gemm", "cutlass", "sm90", "cublas", "nvjet")}


def profiled(torch, fn, groups, detail):
    """fn() under torch.profiler: (wall s, device us by group, per-kernel
    device ms and count of the group `detail`). Prints the ten kernels
    with the most device time."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    by_group = {g: 0.0 for g in list(groups) + ["other"]}
    top, per = [], {}
    for e in prof.key_averages():
        us = _dev_us(e)
        if us <= 0 or e.device_type is None or "cuda" not in \
                str(e.device_type).lower():
            continue
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
    return pwall, by_group, per


def timing(torch, cfg, params):
    """A warm serving pass (host clock), then a profiled one: device busy
    share and device time by kernel group. Kernel launches here are not
    counted toward phase 3."""
    engine, reqs = serve(torch, cfg, "cuda", params)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    engine.submit_all(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    tokens = sum(len(r.out) for r in reqs if not r.rejected)
    print(f"  warm: {tokens} tokens, {engine.step_count} decode steps in "
          f"{wall:.3f} s = {tokens / wall:.1f} tokens/s, "
          f"{wall / engine.step_count * 1e3:.1f} ms per step (prefill "
          "included)", flush=True)
    engine, reqs = serve(torch, cfg, "cuda", params)
    torch.cuda.synchronize()
    pwall, by_group, probe = profiled(
        torch, lambda: engine.submit_all(reqs), PROBE_GROUPS,
        "probe kernels")
    busy = sum(by_group.values())
    return {"warm_tokens_per_s": tokens / wall,
            "warm_ms_per_step": wall / engine.step_count * 1e3,
            "profiled_wall_ms": pwall * 1e3, "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / 1e6 / pwall,
            "device_ms_by_group": {g: v / 1e3 for g, v in by_group.items()},
            "probe_kernels_device": probe}


# --------------------------------------------------------------------------
# phases 6-7: training
# --------------------------------------------------------------------------

def _train_runtime():
    from repro_torch.core.runtime import BpftimeRuntime
    from repro_torch.launch import train as T
    rt = BpftimeRuntime()
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
    if any(v == 0 for v in launches.values()):
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
    """One more warm step, after phase 6's launches were read, under
    torch.profiler: device busy share and device time by kernel group."""
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
    pwall, by_group, flash = profiled(torch, lambda: step(state, b), groups,
                                      "flash kernels")
    busy = sum(by_group.values())
    return {"profiled_wall_ms": pwall * 1e3, "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / 1e6 / pwall,
            "device_ms_by_group": {g: v / 1e3 for g, v in by_group.items()},
            "flash_kernels_device": flash}


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
                                     hash_update as HU, ops, ref,
                                     ringbuf_emit as RB, tensor_stats as TS)

    name = torch.cuda.get_device_name(0)
    print(f"device: {name}, torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}, {torch.cuda.device_count()} device(s)",
          flush=True)

    # ---- phase 1
    t = build.build_all()
    print(f"phase 1: built {', '.join(build.SOURCES)} in {t:.1f} s",
          flush=True)
    for src, log in build.BUILD_LOG.items():
        for line in log.splitlines():
            if "error" in line.lower() or "warning" in line.lower() or (
                    "registers" in line and src != "flash_attention"):
                print(f"  {src}: {line.strip()}")
    sm90_build = check_build(build)

    # ---- phase 2
    cfg = registry.get("qwen2-0.5b")
    L2 = 2 * cfg.num_layers + 1            # rows per probed decode step
    print("phase 2: kernels against their plain versions", flush=True)
    ts_err, ts_rows = check_tensor_stats(torch, TS, ref, [
        ((4, 1, cfg.d_model), torch.bfloat16, False),
        ((4, 1, cfg.d_model), torch.bfloat16, True),
        ((4, 1, cfg.padded_vocab), torch.float32, True),
        ((1 << 26,), torch.float32, True),
    ])
    hash_rows = check_hash(torch, HU, ref, M, [
        ("path", 256, L2, dict(tombstones=False, full=False)),
        ("tombstones", 256, 4096, dict(tombstones=True, full=False)),
        ("full", 256, 4096, dict(tombstones=False, full=True)),
    ])
    rb_rows = check_ringbuf(torch, RB, ref, [
        ("path", 64, L2, 4), ("B<cap", 64, 40, 4), ("B>cap", 64, 4096, 4),
    ])
    _, fa_fwd, fa_bwd = check_flash(torch, FA, ref)
    if kernels_only:
        print(json.dumps({"tensor_stats": ts_rows, "hash": hash_rows,
                          "ringbuf": rb_rows, "flash_fwd": fa_fwd,
                          "flash_bwd": fa_bwd, "flash_sm90": sm90_build}))
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
    print("phase 5: warm serving time and where the device time goes",
          flush=True)
    times = timing(torch, cfg, engine.params)
    engine_steps, engine_events = engine.step_count, engine.events
    del engine, x
    torch.cuda.empty_cache()

    # ---- phase 6
    print("phase 6: train qwen2-0.5b at full width, seq 4096, batch 4 in "
          "microbatches of 2, remat, 3 steps", flush=True)
    train, state, rt = train_full(torch, ops, cfg)
    train["profiled_step"] = train_profile(torch, cfg, state, rt)
    del state
    torch.cuda.empty_cache()

    # ---- phase 7
    print("phase 7: one smoke-width training step at seq 4096, card vs CPU",
          flush=True)
    train["smoke_card_vs_cpu"] = train_compare(torch, small)

    # ---- report
    def pick(rows_, key, val):
        return next(r for r in rows_ if r[key] == val)

    hs_main = pick(hash_rows, "case", "path")
    rb_main = pick(rb_rows, "case", "path")
    tl = train["launches"]

    def entry(name, source, replaces, launch_count, err, row, shapes):
        return {"name": name, "route": "cuda",
                "source": f"src/repro_torch/kernels/csrc/{source}",
                "replaces": replaces, "launches": launch_count,
                "max_abs_err": err, "ms": row["ms"],
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
        "train": train, "train_launches_of_serving_kernels": {
            k: tl[k] for k in serving_kernels},
        "flash_sm90_build": sm90_build}
    print(json.dumps(report), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    if smi.returncode != 0 or not smi.stdout.strip():
        fail(f"nvidia-smi failed: {smi.stderr.strip()}")
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
