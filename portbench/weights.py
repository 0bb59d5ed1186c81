"""Seeded weights in the port's parameter layout, made on the device.

Every leaf is one draw from a `torch.Generator` of its own on the target
device, seeded from the run's seed and the leaf's index, so a single leaf
can be made again later (the training check compares each leaf's change
against its first value) without keeping a copy. Leaves are float32, the
type the port keeps its parameters in; layers are stacked on dim 0 as
`models/transformer.py` stacks them: one tree a superblock position, each
leaf with a row a superblock (pattern.py).

Both sides get these tensors: the port runs on them, the plain reference
reads the same tree by its keys.
"""
from __future__ import annotations

import math

import torch

from . import pattern, reference as R
from .reference.train import unflat

F32 = torch.float32
_MIX = 0x9E3779B97F4A7C15


def leaf_seed(seed: int, index: int) -> int:
    """A 63-bit generator seed for leaf `index` of a run seeded `seed`."""
    return ((seed * 1_000_003 + index * 7919 + 1) * _MIX) % (1 << 63)


def _vpad(m: dict) -> int:
    return -(-m["vocab_size"] // 256) * 256


def leaf_specs(config: dict) -> list:
    """(path, shape, kind, scale) of every leaf of the model the
    configuration describes, in a fixed order: the embedding; for each
    superblock position j, its first norm and the leaves its reference
    module's `block_leaves(m, j)` gives; the final norm; and the output
    head where the embedding is not tied. The leaf's index in this list
    seeds its draw, so a list that keeps its order keeps every seed's
    weights."""
    m = config["model"]
    D = m["d_model"]
    ref = R.model(config["reference"])
    specs = [(("embed", "embedding"), (_vpad(m), D), "normal", 0.02)]
    for j in range(pattern.superblock(m)):
        blk = ("stack", "blocks", j)
        specs.append((blk + ("norm1", "scale"), (pattern.stacked(m), D),
                      "one_plus", 0.05))
        specs += [(blk + path, shape, kind, scale) for path, shape, kind,
                  scale in ref.block_leaves(m, j)]
    specs.append((("final_norm", "scale"), (D,), "one_plus", 0.05))
    if not m.get("tie_embeddings", False):
        specs.append((("embed", "lm_head"), (D, _vpad(m)), "normal", 0.02))
    return specs


def make_leaf(seed: int, index: int, shape, kind: str, scale: float,
              device) -> torch.Tensor:
    """Leaf `index` of seed `seed`: one draw on `device`."""
    gen = torch.Generator(device=device)
    gen.manual_seed(leaf_seed(seed, index))
    if kind == "normal":
        return torch.randn(shape, generator=gen, dtype=F32,
                           device=device) * scale
    if kind == "one_plus":
        return 1.0 + scale * torch.randn(shape, generator=gen, dtype=F32,
                                         device=device)
    u = torch.rand(shape, generator=gen, dtype=F32, device=device)
    if kind == "a_log":                     # A = -exp(A_log) in [-16, -1]
        return torch.log(1.0 + 15.0 * u)
    if kind == "dt_bias":
        # softplus(dt_bias) = dt, log-uniform in [1e-3, 1e-1] (Mamba-2's
        # initialisation)
        dt = torch.exp(math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3)))
        return dt + torch.log(-torch.expm1(-dt))
    raise ValueError(kind)


def make_params(seed: int, config: dict, device) -> dict:
    """The whole parameter tree of seed `seed`."""
    return unflat({path: make_leaf(seed, i, shape, kind, scale, device)
                   for i, (path, shape, kind, scale)
                   in enumerate(leaf_specs(config))})


def first_value(seed: int, config: dict, path: tuple, device) -> torch.Tensor:
    """The leaf at `path` as `make_params(seed, config, device)` made
    it."""
    for i, (p, shape, kind, scale) in enumerate(leaf_specs(config)):
        if p == path:
            return make_leaf(seed, i, shape, kind, scale, device)
    raise KeyError(path)
