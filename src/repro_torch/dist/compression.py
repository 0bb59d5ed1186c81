"""Gradient compression: per-leaf symmetric int8 quantization.

`int8_roundtrip` is the wire format simulated in the step (quantize ->
dequantize); training uses it when tcfg.grad_compression == "int8" to model
8-bit gradient all-reduce. `compression_error` reports the relative L2
error of the roundtrip (monitoring / tests).

Bit for bit the JAX package's, on the CPU and on the card: the scale is an
f32 scalar, every division is IEEE f32 (no reciprocal), and `torch.round`
rounds half to even, as `jnp.round` does.
"""
from __future__ import annotations

import torch

from ..optim import tree_leaves, tree_map

F32 = torch.float32


def _roundtrip_leaf(g):
    if not g.is_floating_point():
        return g
    gf = g.to(F32)
    absmax = torch.clamp_min(gf.abs().max(), 1e-30)
    # divide by a tensor: CUDA divides by a Python scalar as a multiply by
    # its reciprocal, which can land one ulp away from jnp's division
    scale = absmax / torch.full_like(absmax, 127.0)
    q = torch.clamp(torch.round(gf / scale), -127, 127).to(torch.int8)
    return (q.to(F32) * scale).to(g.dtype)


def int8_roundtrip(tree):
    """Quantize every floating leaf to int8 (per-leaf absmax scale) and
    dequantize back -- the gradient-compression wire format."""
    return tree_map(_roundtrip_leaf, tree)


def compression_error(tree) -> torch.Tensor:
    """Relative global-L2 error of the int8 roundtrip."""
    rt = int8_roundtrip(tree)
    sq_err = sum(torch.sum((a.to(F32) - b.to(F32)) ** 2)
                 for a, b in zip(tree_leaves(tree), tree_leaves(rt)))
    sq_ref = sum(torch.sum(a.to(F32) ** 2) for a in tree_leaves(tree))
    return torch.sqrt(sq_err) / torch.clamp_min(torch.sqrt(sq_ref), 1e-30)
