"""Run one cell of BENCHMARK.json once and print its result line.

    python3 portbench/run.py --workload qwen2-0.5b.train_4k --seed 7 \
        --seconds 40 --trace 0

(or `PYTHONPATH=src python -m portbench.run ...` from the root of the
repository). It loads the cell's configuration and mix, makes the weights
and inputs from --seed on the card, warms up, measures for --seconds,
checks the timed path's output against the plain reference, and prints
one JSON object as the last line of standard output: with --trace 0 the
cell's end-to-end metrics, with --trace 1 its per-layer metrics from a
profiled sub-window. The numbers the check compared, each with its
limit, are the result's last key and the last lines of standard error.

It needs a CUDA device: without one it exits with an error and prints no
result. It never imports JAX or the JAX package, and fails if either is
loaded once the window has closed.
"""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# run as a script, its own folder leads sys.path; it holds no module that
# should shadow one of the standard library's
if sys.path and Path(sys.path[0] or ".").resolve() == ROOT / "portbench":
    del sys.path[0]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)
os.environ.setdefault("USE_FLAX", "0")
# one host thread for PyTorch's CPU work: the serving loop is host-bound,
# and a pool of spinning threads on a shared host makes its pace wander
# from process to process
os.environ.setdefault("OMP_NUM_THREADS", "1")

FORBIDDEN = ("jax", "jaxlib", "flax", "repro")


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared whole: `repro_torch` is not `repro`."""
    return sorted({n for n in sys.modules if n.split(".")[0] in FORBIDDEN})


def result(cell, run, checks, attempted, failed, trace, device) -> dict:
    """The result line's object."""
    from portbench import cell as C
    import torch
    metrics = {}
    for spec in (cell.per_layer if trace else cell.end_to_end):
        v = C.metric_reader(spec["name"])(run)
        if v is not None:
            metrics[spec["name"]] = {"value": v, "unit": spec["unit"]}
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "kind": torch.cuda.get_device_name(device)
           if device.type == "cuda" else "cpu",
           "count": 1, "memory_peak_bytes": run.peak_bytes}
    out = {"correct": C.passed(checks), "attempted": attempted,
           "failed": failed, "metrics": metrics, "device": dev}
    if trace and run.trace is not None:
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.trace.window_s
        out["breakdown"] = run.trace.breakdown()
    out["checks"] = checks
    return out


def run_cell(cell, seed: int, seconds: float, trace: bool, device,
             t_start: float, faults=()) -> dict:
    """Run `cell` once on `device` and return its result object."""
    from portbench import cell as C, serve_cell, train_cell
    mode = {"serve": serve_cell, "train": train_cell}[cell.traffic["mode"]]
    run, values, attempted, failed = mode.run(cell, seed, seconds, trace,
                                              device, t_start, faults)
    return result(cell, run, C.limited(cell.limits, values), attempted,
                  failed, trace, device)


def power_limit() -> str:
    import subprocess
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20).stdout.strip()
    except (OSError, subprocess.SubprocessError) as exc:
        return f"unknown ({exc!r})"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch
    from portbench import cell as C
    cell = C.load_cell(args.workload)
    need = cell_chips(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < need:
        print(f"portbench: needs {need} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    print(f"portbench: {args.workload} seed {args.seed} on "
          f"{power_limit()}", file=sys.stderr, flush=True)
    device = torch.device("cuda", 0)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), device,
                   T_START)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: loaded {bad}; the benchmark must not load JAX or "
              "the JAX package", file=sys.stderr)
        return 3
    C.print_checks(out["checks"])
    print(json.dumps(out), flush=True)
    return 0


def cell_chips(name: str) -> int:
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    return next(w["chips"] for w in bench["workloads"] if w["name"] == name)


if __name__ == "__main__":
    sys.exit(main())
