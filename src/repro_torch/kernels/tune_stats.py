"""Measure the `tensor_stats` grid constants on the current card.

    PYTHONPATH=src python -m repro_torch.kernels.tune_stats

Times the row kernel back to back (the stream held by a device sleep while
the host enqueues, so CUDA events time the device alone) at grids chosen
here rather than by `grid_for`:
- one block against the smallest rounded grid around ONE_BLOCK_MAX;
- grids that are and are not multiples of GRID_MULTIPLE at the same size;
- caps from 264 to SCRATCH_GRID blocks at 64 Mi f32 (MAX_GRID's choice).
Prints the card's name and power limit and one JSON object of device us per
call. Not used by the port at run time.
"""
from __future__ import annotations

import json
import subprocess

import torch

from . import build, tensor_stats as TS

REPS = 50
CUT_SIZES = (4096, 8192, 12288, 16384, 32768, 65536)
GRID_SIZES = (        # (numel, dtype, grids)
    (8192, torch.float32, (2, 16, 32)),
    (65536, torch.float32, (16, 32, 64)),
    (4 * 152064, torch.float32, (132, 149, 160)),
    (1 << 21, torch.float32, (264, 384, 512, 528)),
    (2 * 4096 * 896, torch.bfloat16, (384, 512, 528)),
    (1 << 26, torch.float32, (264, 384, 512, 528, 768, 1024)),
)


def us_per_call(x: torch.Tensor, grid: int) -> float:
    row = torch.empty(16, dtype=torch.int64, device=x.device)

    def call():
        TS._launch("repro_tensor_stats_row", x, grid, 0, 0, 0,
                   row.data_ptr())
    call()
    torch.cuda.synchronize()
    cycles = 20_000_000
    while True:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(cycles)
        a.record()
        for _ in range(REPS):
            call()
        b.record()
        held = not a.query()        # the device still slept: a queue formed
        b.synchronize()
        if held:
            return a.elapsed_time(b) / REPS * 1e3
        cycles *= 4


def main() -> None:
    build.build_all()
    gen = torch.Generator(device="cuda").manual_seed(0)
    out = {"cut": [], "grids": []}
    for n in CUT_SIZES:
        x = torch.randn(n, generator=gen, device="cuda")
        out["cut"].append({"numel": n, "one_block_us": us_per_call(x, 1),
                           "grid": 32, "grid_us": us_per_call(x, 32)})
    for n, dtype, grids in GRID_SIZES:
        x = torch.randn(n, generator=gen, device="cuda").to(dtype)
        out["grids"].append({"numel": n, "dtype": str(dtype), "us": {
            str(g): us_per_call(x, g) for g in grids}})
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60)
    print(smi.stdout.strip())
    print(json.dumps(out))


if __name__ == "__main__":
    main()
