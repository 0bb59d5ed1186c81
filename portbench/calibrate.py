"""Readings the check's limits are set from: a cell's numbers on many
seeds in one process, for the program as it stands, for the float8
control ("control": the reference in the program's place, one step of
precision below the bfloat16 the configuration states) and for faults
planted in the timed path.

    python3 portbench/calibrate.py --workload qwen2-0.5b.train_4k \
        --seeds 11,12,13 --seconds 4 [--faults control] [--out FILE]

Each seed is a whole run of the cell (set-up, a window of --seconds, the
check) and prints one JSON line {"seed", "faults", "values"}; --out also
appends the lines to FILE. A serving cell also takes
"reference:<precision>" among the faults: the gap of the token that the
reference in that precision (reference/lowp.py) puts first is read beside
the program's as "logit_gap_<precision>". A cell held out of
BENCHMARK.json (smoke.HELD_BACK) runs too. The benchmark's own runs never
call this.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# run as a script, its own folder leads sys.path; it holds no module that
# should shadow one of the standard library's
if sys.path and Path(sys.path[0] or ".").resolve() == ROOT / "portbench":
    del sys.path[0]
for p in (str(ROOT / "src"), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)


def readings(workload: str, seeds, seconds: float, faults=(), device=None,
             cell=None):
    """Yield (seed, values) of one run of `workload` a seed."""
    import torch
    from portbench import serve_cell, smoke, train_cell
    cell = cell or smoke.any_cell(workload)
    mode = {"serve": serve_cell, "train": train_cell}[cell.traffic["mode"]]
    device = device or torch.device("cuda", 0)
    for seed in seeds:
        _, values, _, _ = mode.run(cell, seed, seconds, False, device,
                                   time.perf_counter(), set(faults))
        if device.type == "cuda":
            torch.cuda.empty_cache()
        yield seed, values


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True,
                    help="comma-separated seeds")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--faults", default="",
                    help="comma-separated: control, half_batch, "
                         "frozen_state, alter_token, stale_state, "
                         "reference:<precision>")
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    faults = [f for f in args.faults.split(",") if f]
    for seed, values in readings(args.workload,
                                 [int(s) for s in args.seeds.split(",")],
                                 args.seconds, faults):
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "faults": faults, "values": values})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
