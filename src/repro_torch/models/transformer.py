"""Decoder-only stacked-block model (dense family).

Layers are grouped into SUPERBLOCKS (cfg.superblock consecutive layers);
parameters are stacked across superblocks on dim 0, as in the JAX package
(params["stack"]["blocks"][j][name] has n_super rows), and the forward
loops over them with `events.probed_scan`, which tags each superblock's
probe rows with its index.

Probe sites: block (uprobe/uretprobe), attn.out, ffn.out, embed.out,
logits. MoE, SSM and hybrid blocks are not in this package yet.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..core import events as E
from ..core.events import probe_site
from ..device import resolve
from . import layers as L

F32 = torch.float32


def _check_dense(cfg: ModelConfig):
    for j in range(cfg.superblock):
        if cfg.block_kind(j) != "attn" or cfg.ffn_kind(j) != "dense":
            raise NotImplementedError(
                f"{cfg.name}: MoE and SSM blocks come with later slices "
                "(ROADMAP A13)")
    if cfg.rope_kind == "mrope":
        raise NotImplementedError(f"{cfg.name}: M-RoPE comes with the VLM "
                                  "slice (ROADMAP A13)")


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device="cuda") -> dict:
    """Random f32 parameters. `generator` defaults to one on `device`
    seeded with 0; draws happen on the generator's device."""
    _check_dense(cfg)
    assert cfg.num_layers % cfg.superblock == 0, \
        f"{cfg.name}: num_layers % superblock != 0"
    dev = resolve(device)
    gen = generator
    if gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
    n_super = cfg.num_layers // cfg.superblock
    lead = (n_super,)
    blocks = []
    for _ in range(cfg.superblock):
        blocks.append({
            "norm1": L.init_norm(cfg, dev, lead=lead),
            "attn": L.init_attention(gen, cfg, dev, lead=lead),
            "norm2": L.init_norm(cfg, dev, lead=lead),
            "mlp": L.init_mlp(gen, cfg, dev, lead=lead),
        })
    return {
        "embed": L.init_embedding(gen, cfg, dev),
        "stack": {"blocks": blocks},
        "final_norm": L.init_norm(cfg, dev),
    }


# --------------------------------------------------------------------------
# cache
# --------------------------------------------------------------------------

def init_cache(cfg: ModelConfig, batch: int, max_seq: int, dtype,
               device="cuda") -> dict:
    """KV cache, blocks[j]["k"|"v"] of shape [n_super, B, max_seq, KH, hd],
    and the per-row length `pos` (i32[B])."""
    _check_dense(cfg)
    dev = resolve(device)
    n_super = cfg.num_layers // cfg.superblock
    kv_shape = (n_super, batch, max_seq, cfg.num_kv_heads, cfg.hd)
    blocks = [{"k": torch.zeros(kv_shape, dtype=dtype, device=dev),
               "v": torch.zeros(kv_shape, dtype=dtype, device=dev)}
              for _ in range(cfg.superblock)]
    return {"blocks": blocks,
            "pos": torch.zeros(batch, dtype=torch.int32, device=dev)}


# --------------------------------------------------------------------------
# superblock forward
# --------------------------------------------------------------------------

def _superblock_fwd(p_sb, x, cache_sb, positions, cfg: ModelConfig,
                    mode: str, cache_pos):
    new_cache = []
    for j in range(cfg.superblock):
        p = p_sb["blocks"][j]
        x = probe_site("block", x, kind=E.KIND_ENTRY)
        h = L.apply_norm(p["norm1"], x, cfg)
        c = cache_sb["blocks"][j] if cache_sb is not None else None
        if mode == "train":
            out, _ = L.attention_block(p["attn"], h, positions, cfg)
            new_cache.append(None)
        elif mode == "prefill":
            out, (k_new, v_new) = L.attention_block(p["attn"], h, positions,
                                                    cfg)
            start = torch.zeros(x.shape[0], dtype=torch.int64,
                                device=x.device)
            new_cache.append({"k": L._write_cache(c["k"], k_new, start),
                              "v": L._write_cache(c["v"], v_new, start)})
        else:  # decode
            out, kv = L.attention_block(p["attn"], h, positions, cfg,
                                        cache=(c["k"], c["v"]),
                                        cache_pos=cache_pos)
            new_cache.append({"k": kv[0], "v": kv[1]})
        out = probe_site("attn.out", out)
        x = x + out
        h2 = L.apply_norm(p["norm2"], x, cfg)
        f = probe_site("ffn.out", L.apply_mlp(p["mlp"], h2, cfg))
        x = x + f
        x = probe_site("block", x, kind=E.KIND_EXIT)
    return x, new_cache


# --------------------------------------------------------------------------
# full forward
# --------------------------------------------------------------------------

def forward(params, tokens, cfg: ModelConfig, *, embeds=None,
            positions=None, cache=None, mode: str = "train",
            remat: bool = False):
    """tokens: [B, S_text] int; embeds: [B, S_front, D] modality stub
    (prepended); positions: [B, S] (default iota, or the cache length when
    decoding); remat recomputes each superblock's activations in the
    backward pass. Returns (logits f32 [B, S, V], new_cache|None)."""
    x = L.embed(params["embed"], tokens, cfg)
    if embeds is not None:
        x = torch.cat([embeds.to(x.dtype), x], dim=1)
    B, S, _ = x.shape
    if positions is None:
        if mode == "decode" and cache is not None:
            positions = cache["pos"][:, None]                  # [B, 1]
        else:
            positions = torch.arange(S, dtype=torch.int32,
                                     device=x.device).expand(B, S)
    x = probe_site("embed.out", x)

    cache_pos = cache["pos"] if (cache is not None and mode == "decode") \
        else None

    def body(x, xs):
        p_sb, c_sb = xs
        return _superblock_fwd(p_sb, x, c_sb, positions, cfg, mode,
                               cache_pos)

    if cache is None:
        x, _ = E.probed_scan(lambda c, p_sb: (body(c, (p_sb, None))[0], None),
                             x, params["stack"], remat=remat)
        new_cache = None
    else:
        x, new_blocks = E.probed_scan(
            body, x, (params["stack"], {"blocks": cache["blocks"]}),
            remat=remat)
        new_pos = cache["pos"] + (S if mode != "train" else 0)
        new_cache = {"blocks": new_blocks, "pos": new_pos}

    x = L.apply_norm(params["final_norm"], x, cfg)
    logits = L.unembed(params["embed"], x, cfg).to(F32)
    logits = probe_site("logits", logits)
    return logits, new_cache
