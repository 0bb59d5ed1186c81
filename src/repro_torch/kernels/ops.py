"""Public entry points of the kernels, dispatched by the tensor's device.

A CUDA tensor goes to the Hopper kernel; a CPU tensor to the plain PyTorch
version in `ref.py`. Any other device raises. There is no switch and no
fallback: a CUDA tensor launches its kernel or raises.
"""
from __future__ import annotations

import torch

from . import (flash_attention as fa, hash_update, ref, ringbuf_emit,
               tensor_stats as ts)
from .build import on_card

# kernel name -> (module, name of its launch counter)
KERNELS = {"tensor_stats": (ts, "LAUNCHES"),
           "hash_fetch_add_batch": (hash_update, "LAUNCHES"),
           "ringbuf_emit_batch": (ringbuf_emit, "LAUNCHES"),
           "flash_fwd": (fa, "FWD_LAUNCHES"),
           "flash_bwd": (fa, "BWD_LAUNCHES")}


def tensor_stats(x) -> dict:
    if on_card(x, "tensor_stats"):
        if x.dtype not in (torch.float32, torch.bfloat16):
            x = x.to(torch.float32)
        return ts.tensor_stats_cuda(x.contiguous())
    return ref.tensor_stats(x)


def hash_fetch_add_batch(keys_tbl, used_tbl, vals_tbl, keys, deltas, valid):
    if on_card(keys_tbl, "hash_fetch_add_batch"):
        return hash_update.hash_fetch_add_batch_cuda(
            keys_tbl, used_tbl, vals_tbl, keys.contiguous(),
            deltas.contiguous(), valid.contiguous())
    return ref.hash_fetch_add_batch(keys_tbl, used_tbl, vals_tbl, keys,
                                    deltas, valid)


def ringbuf_emit_batch(data, head, rows, valid):
    if on_card(data, "ringbuf_emit_batch"):
        return ringbuf_emit.ringbuf_emit_batch_cuda(
            data, head, rows.contiguous(), valid.contiguous())
    return ref.ringbuf_emit_batch(data, head, rows, valid)


def flash_attention(q, k, v, causal: bool = True):
    """Causal GQA attention on q [B, S, H, hd], k and v [B, S, KH, hd];
    returns o [B, S, H, hd] in q's type, differentiable. The inputs go to
    the kernel layout (q head b*H + h reads kv head b*KH + h // (H // KH),
    the grouping of `models.layers._grouped`) and through
    `FlashAttention`: the kernels for a CUDA tensor, the plain versions for
    a CPU tensor."""
    B, Sq, H, hd = q.shape
    KH, Skv = k.shape[2], k.shape[1]
    qf = q.permute(0, 2, 1, 3).reshape(B * H, Sq, hd).contiguous()
    kf = k.permute(0, 2, 1, 3).reshape(B * KH, Skv, hd).contiguous()
    vf = v.permute(0, 2, 1, 3).reshape(B * KH, Skv, hd).contiguous()
    o = fa.FlashAttention.apply(qf, kf, vf, causal)
    return o.reshape(B, H, Sq, hd).permute(0, 2, 1, 3)


def launch_counts() -> dict[str, int]:
    return {name: getattr(mod, attr) for name, (mod, attr) in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod, attr in KERNELS.values():
        setattr(mod, attr, 0)
