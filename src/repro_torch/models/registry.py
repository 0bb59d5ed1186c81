"""Uniform model entry points per family: init / cache / prefill / decode,
plus carrying parameters over from the JAX package.

Only the dense decoder family is in this package yet; the encoder-decoder
family raises NotImplementedError.
"""
from __future__ import annotations

import numpy as np
import torch

from ..configs.base import ModelConfig
from ..device import resolve
from . import transformer as TF


def _check_family(cfg: ModelConfig):
    if cfg.family == "encdec":
        raise NotImplementedError(f"{cfg.name}: the encoder-decoder family "
                                  "comes with a later slice")


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device="cuda"):
    _check_family(cfg)
    return TF.init_params(cfg, generator, device)


def make_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype,
               device="cuda"):
    _check_family(cfg)
    return TF.init_cache(cfg, batch, max_seq, dtype, device)


def prefill_fn(params, batch, cache, cfg: ModelConfig):
    _check_family(cfg)
    return TF.forward(params, batch["tokens"], cfg,
                      positions=batch.get("positions"), cache=cache,
                      mode="prefill")


def decode_fn(params, tokens, cache, cfg: ModelConfig):
    """tokens [B,1] -> (logits [B,1,V], cache)."""
    _check_family(cfg)
    return TF.forward(params, tokens, cfg, cache=cache, mode="decode")


def params_from_numpy(tree, device="cuda"):
    """Carry parameters across: the JAX package's params (its nested
    dicts/lists, leaves converted to numpy arrays, superblocks stacked on
    axis 0 under ["stack"]["blocks"][j]) become this package's params, the
    same tree of tensors on `device`."""
    dev = resolve(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [conv(v) for v in t]
        return torch.from_numpy(np.array(t, copy=True)).to(dev)

    return conv(tree)
