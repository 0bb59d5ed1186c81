"""The benchmark's own operation and byte counts, from shapes alone.

`counts/<family>.py` (the configuration's "counts" key) gives a model's
model FLOPs: `matmul_params(m)`, `serve_flops(m, prefills,
decode_positions)` for prefills of the given prompt lengths and decode
steps at the given positions, and `train_flops_per_token(m, seq)`
(forward and backward, no recompute).
`flash.py` and `probes.py` count single kernels' operations and bytes.
"""
import importlib


def family(name: str):
    return importlib.import_module(f"{__name__}.{name}")
