"""Uniform model entry points per family: init / loss / cache / prefill /
decode, plus carrying parameters over from the JAX package.

Every family of `configs/registry.py` is in this package: the decoder
families (dense, MoE, SSM, hybrid, VLM) in `transformer.py`, the
encoder-decoder family in `encdec.py`.
"""
from __future__ import annotations

import numpy as np
import torch

from .. import telemetry as T
from ..configs.base import ModelConfig
from ..device import resolve
from . import encdec as ED, layers as L, moe as MOE, ssm as SSM, \
    transformer as TF


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device="cuda"):
    if cfg.family == "encdec":
        return ED.init_params(cfg, generator, device)
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
    """batch: tokens/labels (+ enc_embeds | embeds/positions). Returns
    (loss, metrics)."""
    if cfg.family == "encdec":
        logits = ED.forward_train(params, batch, cfg, remat=remat)
    else:
        logits, _ = TF.forward(params, batch["tokens"], cfg,
                               embeds=batch.get("embeds"),
                               positions=batch.get("positions"),
                               mode="train", remat=remat)
    with T.span("model.loss"):
        loss = cross_entropy(logits, batch["labels"], cfg.vocab_size)
    return loss, {"loss": loss}


def make_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype,
               device="cuda", *, enc_seq: int = 0):
    """The serving cache; for the encoder-decoder family its cross cache
    holds `enc_seq` frames (0: max_seq)."""
    if cfg.family == "encdec":
        return ED.init_dec_cache(cfg, batch, max_seq, enc_seq or max_seq,
                                 dtype, device)
    return TF.init_cache(cfg, batch, max_seq, dtype, device)


def prefill_fn(params, batch, cache, cfg: ModelConfig):
    """batch: tokens (+ enc_embeds | embeds/positions); the decoder
    families also take "length", the [B] int64 real lengths of
    right-padded tokens, and write the new cache into `cache`
    (`transformer.forward`)."""
    if cfg.family == "encdec":
        enc_out = ED.encode(params, batch["enc_embeds"], cfg)
        return ED.prefill(params, batch["tokens"], enc_out, cache, cfg)
    return TF.forward(params, batch["tokens"], cfg,
                      embeds=batch.get("embeds"),
                      positions=batch.get("positions"), cache=cache,
                      mode="prefill", length=batch.get("length"))


def decode_fn(params, tokens, cache, cfg: ModelConfig, *, cache_out=None):
    """tokens [B,1] -> (logits [B,1,V], cache). cache_out (the decoder
    families): a cache shaped like `cache` that the new cache is written
    into and returned as; `cache` is then only read."""
    if cfg.family == "encdec":
        return ED.decode_step(params, tokens, cache, cfg)
    return TF.forward(params, tokens, cfg, cache=cache, mode="decode",
                      cache_out=cache_out)


def decode_capturable(cfg: ModelConfig) -> bool:
    """Whether `decode_fn`'s work can be captured in CUDA graphs: the same
    work at the same addresses every step, nothing built on or read back
    to the host. The decoder families' attention and mamba mixers, dense
    and MoE layers qualify; not the encoder-decoder's decode step, nor
    M-RoPE (`layers.apply_rope` builds its axis table on the host at every
    call), nor expert parallelism over an active mesh (collectives,
    `transformer.expert_parallel`), read on every call."""
    if cfg.family == "encdec" or cfg.rope_kind == "mrope":
        return False
    if any(cfg.ffn_kind(j) == "moe" for j in range(cfg.superblock)):
        return not TF.expert_parallel(cfg)
    return True


def prefill_capturable(cfg: ModelConfig) -> bool:
    """Whether a right-padded prefill (`prefill_fn` with "length") can be
    captured in CUDA graphs and give each real position what the prompt
    alone gives: `decode_capturable`, and every MoE layer dropless. A
    capacity MoE (`moe.capacity` grows with the tokens) would let padded
    tokens take real tokens' slots."""
    return decode_capturable(cfg) and (cfg.moe_dropless or not any(
        cfg.ffn_kind(j) == "moe" for j in range(cfg.superblock)))


# each module's leaves that its functions use only through a cast to the
# compute type, by the key the module's subtree has in a family's tree
# (`transformer._init_block`, `encdec._init_layer`); a subtree no key names
# here keeps every leaf
CAST_LEAVES = {"embed": L.EMBEDDING_CAST_LEAVES,
               "attn": L.ATTENTION_CAST_LEAVES,
               "xattn": L.ATTENTION_CAST_LEAVES,
               "mlp": L.MLP_CAST_LEAVES, "mlp_shared": L.MLP_CAST_LEAVES,
               "moe": MOE.CAST_LEAVES, "mamba": SSM.CAST_LEAVES}


def serving_params(params, cfg: ModelConfig):
    """The tree serving runs on, built once: `params`' structure, each
    leaf of `CAST_LEAVES` cast to the compute type here, so that the
    model's casts at use return it with no kernel and no copy; every other
    leaf is the same tensor. The model computes the same bits on either
    tree. `params` is left as it is. Where the compute type is float32,
    `params` itself. The keyed record `serve.compute_weights` counts the
    call by (leaves cast, leaves kept, bytes held in the compute type)."""
    dt = L.cdtype(cfg)
    if dt == torch.float32:
        return params
    cast, kept = [], []

    def leaf(t, to_cast):
        if to_cast:
            t = t.to(dt)
        (cast if to_cast else kept).append(t)
        return t

    def walk(t, names):
        if isinstance(t, dict):
            return {k: leaf(v, k in names) if isinstance(v, torch.Tensor)
                    else walk(v, CAST_LEAVES.get(k, ()))
                    for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, names) for v in t)
        return t

    with torch.no_grad():
        tree = walk(params, ())
    T.count("serve.compute_weights", (len(cast), len(kept), sum(
        t.numel() * t.element_size() for t in cast)))
    return tree


def params_from_numpy(tree, device="cuda"):
    """Carry parameters across: the JAX package's params (its nested
    dicts/lists, leaves converted to numpy arrays, superblocks stacked on
    axis 0 under ["stack"]["blocks"][j], or the encoder-decoder's layers
    under ["encoder"] and ["decoder"]) become this package's params, the
    same tree of tensors on `device`."""
    dev = resolve(device)

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [conv(v) for v in t]
        return torch.from_numpy(np.array(t, copy=True)).to(dev)

    return conv(tree)
