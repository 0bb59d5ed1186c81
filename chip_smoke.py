#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py              # all phases; needs one CUDA device
    python3 chip_smoke.py --kernels    # phases 1-2 only (build + checks)

Phases:
  1. build the three Hopper kernels from src/repro_torch/kernels/csrc with
     nvcc (one process per source, in parallel);
  2. hold each kernel against its plain PyTorch version on the card, at the
     serving path's shapes and at stress shapes, and time both;
  3. serve qwen2-0.5b at full width (bf16, random weights from a seed):
     8 requests, 4 slots, max_seq 128, max_new 8, the sys_serve_admit filter
     at limit 12, and four probes on the fused lane (ARRAY and HASH layer
     counters on uprobe:block, an rms LOG2HIST on uretprobe:block, a RINGBUF
     record on probe:logits); every kernel must have launched on this path
     and tensor_stats once per collected event. The smoke-width model is
     also served on the card and on the CPU and the two compared;
  4. replay the last decode step's tape through the scan and vectorized
     modes: their map states must equal the fused lane's bit for bit;
  5. serve again warm (host clock) and once under torch.profiler: device
     busy share and device time by kernel group.

Prints a JSON line of per-kernel numbers, the card's name and power limit,
and as its last line {"ok": true, "device": {...}}. Any failure exits
non-zero; without CUDA, or without the repository beside it, it exits
non-zero before printing any result. No JAX is imported.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# published peaks of the H100 SXM at its 700 W power limit (NVIDIA data
# sheet): device memory, and f32 outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
STATS_TOL = 2e-5
SEED = 0


def fail(msg: str):
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def bound_ms(nbytes: float, ops: float) -> tuple[float, str]:
    tb, to = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
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


def timing(torch, cfg, params):
    """A warm serving pass (host clock), then a profiled one: device busy
    share and device time by kernel group. Kernel launches here are not
    counted toward phase 3."""
    from torch.profiler import ProfilerActivity, profile
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
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.submit_all(reqs)
        torch.cuda.synchronize()
        pwall = time.perf_counter() - t0
    groups = {"probe kernels": ("stats_partial", "stats_final", "hash_",
                                "ringbuf_emit"),
              "matmul": ("gemm", "cutlass", "sm90", "cublas", "nvjet")}
    by_group = {g: 0.0 for g in list(groups) + ["other"]}
    top, probe = [], {}
    for e in prof.key_averages():
        us = _dev_us(e)
        if us <= 0 or e.device_type is None or "cuda" not in \
                str(e.device_type).lower():
            continue
        g = next((g for g, keys in groups.items()
                  if any(k in e.key.lower() for k in keys)), "other")
        by_group[g] += us
        top.append((us, e.count, e.key[:70]))
        if g == "probe kernels":
            m = re.search(r"::(\w+(?:<[^>]*>)?)\(", e.key)
            p = probe.setdefault(m.group(1) if m else e.key[:40],
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
    for p in probe.values():
        p["us_per_launch"] = p["device_ms"] * 1e3 / max(p["count"], 1)
    print(f"  probe kernels on the device: {json.dumps(probe)}", flush=True)
    return {"warm_tokens_per_s": tokens / wall,
            "warm_ms_per_step": wall / engine.step_count * 1e3,
            "profiled_wall_ms": pwall * 1e3, "device_busy_ms": busy / 1e3,
            "device_busy_share": busy / 1e6 / pwall,
            "device_ms_by_group": {g: v / 1e3 for g, v in by_group.items()},
            "probe_kernels_device": probe}


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
    from repro_torch.kernels import (build, hash_update as HU, ops, ref,
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
            if "registers" in line or "error" in line.lower():
                print(f"  {src}: {line.strip()}")

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
    if kernels_only:
        print(json.dumps({"tensor_stats": ts_rows, "hash": hash_rows,
                          "ringbuf": rb_rows}))
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
    if any(v == 0 for v in launches.values()):
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

    # ---- report
    def pick(rows_, key, val):
        return next(r for r in rows_ if r[key] == val)

    ts_main = ts_rows[0]
    hs_main = pick(hash_rows, "case", "path")
    rb_main = pick(rb_rows, "case", "path")
    report = {"kernels": [
        {"name": "tensor_stats", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/tensor_stats.cu",
         "replaces": "src/repro/kernels/tensor_stats.py:25",
         "launches": launches["tensor_stats"], "max_abs_err": ts_err,
         "ms": ts_main["ms"], "plain_ms": ts_main["plain_ms"],
         "bound_ms": ts_main["bound_ms"], "bound_by": ts_main["bound_by"],
         "library_ms": None, "shapes": ts_rows},
        {"name": "hash_fetch_add_batch", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/hash_update.cu",
         "replaces": "src/repro/kernels/hash_update.py:24",
         "launches": launches["hash_fetch_add_batch"], "max_abs_err": 0,
         "ms": hs_main["ms"], "plain_ms": hs_main["plain_ms"],
         "bound_ms": hs_main["bound_ms"], "bound_by": hs_main["bound_by"],
         "library_ms": None, "shapes": hash_rows},
        {"name": "ringbuf_emit_batch", "route": "cuda",
         "source": "src/repro_torch/kernels/csrc/ringbuf_emit.cu",
         "replaces": "src/repro/kernels/ringbuf_emit.py:17",
         "launches": launches["ringbuf_emit_batch"], "max_abs_err": 0,
         "ms": rb_main["ms"], "plain_ms": rb_main["plain_ms"],
         "bound_ms": rb_main["bound_ms"], "bound_by": rb_main["bound_by"],
         "library_ms": None, "shapes": rb_rows},
    ], "serve": {"served": len(served), "rejected": len(reqs) - len(served),
                 "decode_steps": engine.step_count,
                 "tokens_per_s": tokens / wall, "events": engine.events,
                 **times}}
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
