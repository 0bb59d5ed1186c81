"""Instrumented serving on the PyTorch port: continuous batching with an
eBPF admission filter (reject long prompts) and a per-request token-count
map. The twin of examples/serve_demo.py, on `repro_torch`.

    PYTHONPATH=src python examples/torch/serve_demo.py              # CUDA
    PYTHONPATH=src python examples/torch/serve_demo.py --device cpu
"""
import argparse
import sys

import numpy as np

from repro_torch.configs import registry
from repro_torch.core import maps as M
from repro_torch.core.runtime import BpftimeRuntime
from repro_torch.models import registry as MR
from repro_torch.serve.engine import Request, ServeEngine

ADMIT = """
    ldxdw r6, [r1+ctx:arg1]     ; prompt length
    jle r6, 12, ok
    mov r1, 429                 ; too long -> reject
    call override_return
    ok:
    mov r0, 0
    exit
"""

COUNT_TOKENS = """
    ldxdw r6, [r1+ctx:arg0]     ; request id
    stxdw [r10-8], r6
    ldxdw r3, [r1+ctx:arg1]     ; generated tokens (read ctx BEFORE lddw r1)
    lddw r1, map:tokens_out
    mov r2, r10
    add r2, -8
    call map_fetch_add
    mov r0, 0
    exit
"""


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    rt = BpftimeRuntime()
    pid = rt.load_asm("admit", ADMIT, [], "filter")
    rt.attach(pid, "filter:sys_serve_admit")
    pid2 = rt.load_asm(
        "count", COUNT_TOKENS,
        [M.MapSpec("tokens_out", M.MapKind.ARRAY, max_entries=64)],
        "tracepoint")
    rt.attach(pid2, "tracepoint:sys_serve_evict:enter")

    cfg = registry.smoke("qwen2-0.5b")
    params = MR.init_params(cfg, device=args.device)
    engine = ServeEngine(params, cfg, slots=4, max_seq=64, runtime=rt,
                         device=args.device)

    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(0, cfg.vocab_size,
                                               rng.integers(3, 20)).tolist(),
                    max_new=8) for i in range(8)]
    engine.submit_all(reqs)

    print(f"{'REQ':>4s} {'PROMPT':>6s} {'STATUS':10s} OUTPUT")
    for r in reqs:
        status = "rejected" if r.rejected else "done"
        print(f"{r.rid:4d} {len(r.prompt):6d} {status:10s} {r.out[:8]}")
    counts = rt.host_maps["tokens_out"]["values"]
    print(f"\nper-request generated tokens (eBPF map): "
          f"{ {i: int(c) for i, c in enumerate(counts) if c} }")
    print(f"decode steps run: {engine.step_count}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
