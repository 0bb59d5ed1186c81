"""What the harness counts from a launch's tensors (probes.py's bytes,
`cell.Run.flash_launches`) and from the engine's requests (the inputs of
a family's `serve_flops`), taken instead from the keys the port records
(`repro_torch.telemetry`), by the same formulas:

- `probe.tensor_stats`: (kernel symbol, numel, element size) of the
  tensor the kernel reads (f32 or bf16 by then): the collector's row
  kernel writes one event row, the statistics' dict kernel six i64
  lanes;
- `probe.hash_fetch_add` (six tensors) and `probe.ringbuf_emit` (five):
  (shape, element size) of each tensor, in the launcher's order;
- `flash.fwd`, `flash.bwd`: (BH, BKH, S, hd, causal);
- `serve.prefill_tokens`: a prefill's prompt length;
  `serve.decode_position`: the position a decode step decoded a slot at.

A record maps each key to the times it was counted."""
from __future__ import annotations

import math

from . import probes


def _nbytes(shaped) -> int:
    shape, size = shaped
    return math.prod(shape) * size


STATS_OUT_BYTES = 6 * 8


def tensor_stats(key) -> int:
    symbol, numel, size = key
    out = probes.ROW_BYTES if symbol.endswith("_row") else STATS_OUT_BYTES
    return numel * size + out


def table_kernel(key) -> int:
    """The hash fetch-add's or the ring-buffer emit's bytes: its first
    three tensors (the tables; the ring, its head and its drop count) read
    and written, the others (the batch) read."""
    return 2 * sum(map(_nbytes, key[:3])) + sum(map(_nbytes, key[3:]))


PROBE_BYTES = {"probe.tensor_stats": tensor_stats,
               "probe.hash_fetch_add": table_kernel,
               "probe.ringbuf_emit": table_kernel}


def probe_bytes(keyed: dict) -> int:
    """Bytes every recorded probe kernel launch must move."""
    return sum(fn(key) * n for name, fn in PROBE_BYTES.items()
               for key, n in keyed.get(name, {}).items())


def flash_launches(keyed: dict) -> list:
    """Every recorded flash launch as (kind, BH, BKH, S, hd, causal), the
    form `cell.Run.flash_launches` takes."""
    return [(kind,) + tuple(key) for kind in ("fwd", "bwd")
            for key, n in keyed.get(f"flash.{kind}", {}).items()
            for _ in range(n)]


def serve_positions(keyed: dict) -> tuple[list, list]:
    """(prompt lengths of the prefills, decode positions) from
    `serve.prefill_tokens` and `serve.decode_position`, as a family's
    `serve_flops` takes them (the decode positions as one list: its count
    is a sum over positions)."""
    prefills = [n for n, k in sorted(keyed.get("serve.prefill_tokens",
                                               {}).items())
                for _ in range(k)]
    positions = [p for p, k in sorted(keyed.get("serve.decode_position",
                                                {}).items())
                 for _ in range(k)]
    return prefills, [positions]
