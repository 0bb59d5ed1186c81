"""Multi-pod dry run: count every (arch x shape) cell on the production
meshes with no card, and write JSON for the roofline report
(`benchmarks/roofline_report_torch.py`).

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch qwen2-0.5b \\
        --shape train_4k [--multi-pod] [--probes] [--out results_torch/]
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all [--multi-pod]

The port's twin of `src/repro/launch/dryrun.py`. Where JAX fakes 512 CPU
devices with XLA_FLAGS and lowers each cell through GSPMD, this starts a
fake process group (`torch.testing`'s FakeStore, backend "fake") of 256
or 512 ranks, builds the production `DeviceMesh` on it, and runs one step
of the cell under `op_cost.analyze`: fake tensors with the cell's global
shapes, the kernels through their custom operators. The fake tensors are
on the CPU device: a CPU-only torch cannot fake every CUDA operation, and
no shape or dtype of a step depends on its device. The
group is started in `run_cell`, never at import, and destroyed when the
cell is done.

Differences from JAX's JSON: `trace_s` in place of `lower_s`/
`compile_s`; `memory_analysis` is an error entry (eager PyTorch has no
compiled artifact); the counts are global and the per-device terms
divide them by the ranks (even sharding assumed); the collectives are
those the port's code issues itself (the expert gather with
REPRO_MOE_EP=1): eager PyTorch has no partitioner to insert GSPMD's.
`--probe-mode scan` is refused: the scan lanes read the tape on the host.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import time
import traceback

import torch

from ..configs import SHAPES, registry, shape_applicable
from . import analysis, presets, specs as SP
from .mesh import PRODUCTION, make_production_mesh

NO_ARTIFACT = "eager PyTorch has no compiled artifact"


def _maybe_probe_runtime(cfg):
    """Representative bpftime instrumentation: per-layer activation stats
    into an array map + rms histogram."""
    from ..core import maps as M
    from ..core.runtime import BpftimeRuntime
    rt = BpftimeRuntime()
    pid = rt.load_asm("layer_counts", """
        mov r9, r1                  ; save ctx across calls
        ldxdw r6, [r1+ctx:layer]
        stxdw [r10-8], r6
        lddw r1, map:layer_counts
        mov r2, r10
        add r2, -8
        mov r3, 1
        call map_fetch_add
        ldxdw r2, [r9+ctx:rms]
        lddw r1, map:rms_hist
        call hist_add
        mov r0, 0
        exit
    """, [M.MapSpec("layer_counts", M.MapKind.ARRAY, max_entries=128),
          M.MapSpec("rms_hist", M.MapKind.LOG2HIST)], "uprobe")
    rt.attach(pid, "uprobe:block")
    rt.attach(pid, "uretprobe:block")
    return rt


class _FakeGroup:
    """The fake process group of `n` ranks a cell is counted on, started
    unless one of that size already runs, destroyed on exit if started."""

    def __init__(self, n: int):
        self.n, self.started = n, False

    def __enter__(self):
        import torch.distributed as dist
        if dist.is_initialized():
            if dist.get_world_size() != self.n:
                raise RuntimeError(
                    f"a process group of {dist.get_world_size()} ranks is "
                    f"running; the dry run needs {self.n}")
            return self
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=self.n)
        self.started = True
        return self

    def __exit__(self, *exc):
        if self.started:
            import torch.distributed as dist
            dist.destroy_process_group()


def build_cell(arch: str, shape_name: str, *, multi_pod: bool,
               probes: bool = False, probe_mode: str = "fused"):
    """Returns (step, args, mesh, meta): the step function and its fake
    arguments. Call inside the cell's fake group; the arguments belong to
    a FakeTensorMode of their own."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    cfg = registry.get(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return None, None, None, {"skip": why}
    if probes and probe_mode == "scan":
        raise ValueError("--probe-mode scan: the scan lanes read the event "
                         "tape on the host (core/jit.run_over_events), so a "
                         "step on fake tensors cannot run them; use fused")
    mesh = make_production_mesh(multi_pod=multi_pod)
    tcfg = presets.train_config(arch)
    rt = _maybe_probe_runtime(cfg) if probes else None
    dev = "cpu"
    with FakeTensorMode():
        if shape.mode == "train":
            from ..train.train_step import (abstract_train_state,
                                            make_train_step)
            state = abstract_train_state(cfg, tcfg, rt, dev)
            batch = SP.train_batch_specs(cfg, shape, tcfg, dev)
            shardings = (SP.state_shardings(state, mesh),
                         SP.batch_shardings(batch, mesh, cfg, shape,
                                            tcfg))
            step = make_train_step(cfg, tcfg, rt, probe_mode=probe_mode)
            args = (state, batch)
        elif shape.mode == "prefill":
            from ..serve.steps import make_prefill_step
            params = SP.abstract_params(cfg, tcfg.param_dtype, dev)
            batch = SP.prefill_batch_specs(cfg, shape, dev)
            dspec = SP.decode_specs(cfg, shape, tcfg.param_dtype, dev)
            maps = rt.init_device_maps(dev) if rt else {}
            shardings = (SP.state_shardings(params, mesh),
                         SP.batch_shardings(
                             batch, mesh, cfg, shape,
                             presets.train_config(arch, microbatch=0)),
                         SP.cache_shardings(dspec["cache"], mesh, cfg,
                                            shape))
            step = make_prefill_step(cfg, rt)
            args = (params, batch, dspec["cache"], maps)
        else:  # decode
            from ..serve.steps import make_decode_step
            params = SP.abstract_params(cfg, tcfg.param_dtype, dev)
            dspec = SP.decode_specs(cfg, shape, tcfg.param_dtype, dev)
            maps = rt.init_device_maps(dev) if rt else {}
            shardings = (SP.state_shardings(params, mesh),
                         SP.batch_shardings(
                             {"tokens": dspec["tokens"]}, mesh, cfg,
                             shape, presets.train_config(
                                 arch, microbatch=0)),
                         SP.cache_shardings(dspec["cache"], mesh, cfg,
                                            shape))
            step = make_decode_step(cfg, rt, probe_mode=probe_mode)
            args = (params, dspec["tokens"], dspec["cache"], maps, 0)
    meta = {"arch": arch, "shape": shape_name, "mode": shape.mode,
            "mesh": list(mesh.devices_shape), "multi_pod": multi_pod,
            "probes": probes, "probe_mode": probe_mode,
            "sharded_leaves": sum(any(e is not None for e in s)
                                  for _, s in SP.leaf_paths(shardings))}
    return step, args, mesh, meta


def run_cell(arch: str, shape_name: str, *, multi_pod: bool,
             probes: bool = False, probe_mode: str = "fused",
             verbose: bool = True) -> dict:
    from . import op_cost
    t0 = time.time()
    chips = math.prod(PRODUCTION[multi_pod][0])
    with _FakeGroup(chips):
        step, args, mesh, meta = build_cell(
            arch, shape_name, multi_pod=multi_pod, probes=probes,
            probe_mode=probe_mode)
        if step is None:
            return meta
        cfg = registry.get(arch)
        shape = SHAPES[shape_name]
        t1 = time.time()
        oc = op_cost.analyze(step, *args)
        t_trace = time.time() - t1

    out = dict(meta)
    out["trace_s"] = round(t_trace, 1)
    out["memory_analysis"] = {"error": NO_ARTIFACT}
    out["analytic_state_bytes_global"] = _analytic_bytes(args)
    out["ops"] = oc.ops
    out["collectives"] = {
        "counts": {k: int(v) for k, v in oc.collective_counts.items()},
        "bytes_by_type": {k: float(v)
                          for k, v in oc.collective_bytes.items()},
        "wire_bytes_per_dev": oc.coll_wire / chips,
        # the flash kernels issue no collective: JAX's keys, fixed here
        "flash_interior_bytes": 0.0,
        "wire_fused_per_dev": oc.coll_wire / chips}
    mf = analysis.model_flops(cfg, shape)
    rf = analysis.roofline_from_cost(oc, chips, mf, fused_attention=True)
    out["roofline"] = rf.to_dict()
    out["roofline"]["bytes_flash_interior_per_dev"] = \
        oc.bytes_flash_interior / chips
    out["roofline"]["card"] = analysis.CARD
    rf_unfused = analysis.roofline_from_cost(oc, chips, mf,
                                             fused_attention=False)
    out["roofline_unfused_attention"] = {
        "memory_s": rf_unfused.memory_s,
        "dominant": rf_unfused.dominant,
        "roofline_fraction": rf_unfused.roofline_fraction}
    out["total_s"] = round(time.time() - t0, 1)
    if verbose:
        print(f"[dryrun] {arch} x {shape_name} mesh={out['mesh']} "
              f"probes={probes}: trace {out['trace_s']}s, {oc.ops} ops, "
              f"dominant={rf.dominant}, terms=({rf.compute_s:.4f}, "
              f"{rf.memory_s:.4f}, {rf.collective_s:.4f})s, roofline_frac="
              f"{rf.roofline_fraction:.3f}", flush=True)
    return out


def _analytic_bytes(args) -> int:
    """Global bytes of all inputs (the per-device table divides them,
    assuming even sharding)."""
    from torch.utils._pytree import tree_leaves
    return int(sum(t.numel() * t.element_size() for t in tree_leaves(args)
                   if isinstance(t, torch.Tensor)))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch")
    ap.add_argument("--shape")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--probes", action="store_true")
    ap.add_argument("--probe-mode", default="fused")
    ap.add_argument("--out", default="results_torch")
    args = ap.parse_args(argv)

    os.makedirs(args.out, exist_ok=True)
    if args.all:
        cells = [(arch, shape) for arch in sorted(registry.ARCHS)
                 for shape in SHAPES]
    else:
        cells = [(args.arch, args.shape)]

    failures = 0
    for arch, shape in cells:
        tag = f"{arch}__{shape}__{'mp' if args.multi_pod else 'sp'}" + \
              ("__probes" if args.probes else "")
        path = os.path.join(args.out, tag + ".json")
        if os.path.exists(path):
            print(f"[dryrun] skip existing {tag}")
            continue
        try:
            res = run_cell(arch, shape, multi_pod=args.multi_pod,
                           probes=args.probes, probe_mode=args.probe_mode)
        except Exception as e:
            failures += 1
            res = {"arch": arch, "shape": shape, "error": str(e),
                   "traceback": traceback.format_exc()}
            print(f"[dryrun] FAIL {arch} x {shape}: {e}")
        with open(path, "w") as f:
            json.dump(res, f, indent=1)
    if failures:
        raise SystemExit(f"{failures} cell(s) failed")


if __name__ == "__main__":
    main()
