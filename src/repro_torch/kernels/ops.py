"""Public entry points of the kernels, dispatched by the tensor's device.

A CUDA tensor goes to the Hopper kernel; a CPU tensor to the plain PyTorch
version in `ref.py`. Any other device raises. There is no switch and no
fallback: a CUDA tensor launches its kernel or raises.
"""
from __future__ import annotations

import torch

from . import hash_update, ref, ringbuf_emit, tensor_stats as ts

KERNELS = {"tensor_stats": ts, "hash_fetch_add_batch": hash_update,
           "ringbuf_emit_batch": ringbuf_emit}


def _route(t: torch.Tensor, name: str) -> bool:
    """True for the kernel, False for the plain version."""
    if t.is_cuda:
        return True
    if t.device.type == "cpu":
        return False
    raise ValueError(f"{name}: no kernel or plain version for {t.device}")


def tensor_stats(x) -> dict:
    if _route(x, "tensor_stats"):
        if x.dtype not in (torch.float32, torch.bfloat16):
            x = x.to(torch.float32)
        return ts.tensor_stats_cuda(x.contiguous())
    return ref.tensor_stats(x)


def hash_fetch_add_batch(keys_tbl, used_tbl, vals_tbl, keys, deltas, valid):
    if _route(keys_tbl, "hash_fetch_add_batch"):
        return hash_update.hash_fetch_add_batch_cuda(
            keys_tbl, used_tbl, vals_tbl, keys.contiguous(),
            deltas.contiguous(), valid.contiguous())
    return ref.hash_fetch_add_batch(keys_tbl, used_tbl, vals_tbl, keys,
                                    deltas, valid)


def ringbuf_emit_batch(data, head, rows, valid):
    if _route(data, "ringbuf_emit_batch"):
        return ringbuf_emit.ringbuf_emit_batch_cuda(
            data, head, rows.contiguous(), valid.contiguous())
    return ref.ringbuf_emit_batch(data, head, rows, valid)


def launch_counts() -> dict[str, int]:
    return {name: mod.LAUNCHES for name, mod in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod in KERNELS.values():
        mod.LAUNCHES = 0
