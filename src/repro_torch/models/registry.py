"""Uniform model entry points per family: init / loss / cache / prefill /
decode, plus carrying parameters over from the JAX package.

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
                                  "comes with a later slice (ROADMAP A13)")


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device="cuda"):
    _check_family(cfg)
    return TF.init_params(cfg, generator, device)


def cross_entropy(logits, labels, vocab_size=None):
    """logits f32 [B,S,Vpad]; labels int [B,S], -1 = masked. Padding
    logits (>= vocab_size) are set to -1e30, out of the partition
    function. The label's log-prob is a gather, which picks the same value
    as the JAX package's iota-mask sum."""
    if vocab_size is not None and vocab_size < logits.shape[-1]:
        pad = torch.arange(logits.shape[-1], device=logits.device) \
            >= vocab_size
        logits = logits.masked_fill(pad, -1e30)
    labels = labels.long()
    mask = (labels >= 0).to(torch.float32)
    lab = torch.clamp_min(labels, 0)
    logz = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, lab[..., None])[..., 0]
    nll = (logz - ll) * mask
    return nll.sum() / torch.clamp_min(mask.sum(), 1.0)


def loss_fn(params, batch, cfg: ModelConfig, *, remat=False):
    """batch: tokens/labels (+ embeds/positions). Returns (loss, metrics)."""
    _check_family(cfg)
    logits, _ = TF.forward(params, batch["tokens"], cfg,
                           embeds=batch.get("embeds"),
                           positions=batch.get("positions"), mode="train",
                           remat=remat)
    loss = cross_entropy(logits, batch["labels"], cfg.vocab_size)
    return loss, {"loss": loss}


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
