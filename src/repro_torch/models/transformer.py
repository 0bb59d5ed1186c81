"""Generic decoder-only stacked-block model.

One implementation covers dense / MoE / SSM (mamba2) / hybrid (jamba) /
VLM via the config's per-layer pattern: layer i = mixer(attn|mamba) + ffn
(dense|moe|none). Layers are grouped into SUPERBLOCKS (cfg.superblock
consecutive layers, the repeating heterogeneous unit); parameters are
stacked across superblocks on dim 0, as in the JAX package
(params["stack"]["blocks"][j][name] has n_super rows), and the forward
loops over them with `events.probed_scan`, which tags each superblock's
probe rows with its index.

Probe sites: block (uprobe/uretprobe), attn.out, ssm.out, ffn.out,
moe.router, moe.load, moe.drops, embed.out, logits.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..core import events as E
from ..core.events import probe_site
from ..device import resolve
from . import layers as L, moe as MOE, ssm as SSM

F32 = torch.float32


# --------------------------------------------------------------------------
# init
# --------------------------------------------------------------------------

def _init_block(gen, cfg: ModelConfig, j: int, dev, lead):
    """Superblock position j, every leaf with the leading dims `lead`."""
    kind, ffn = cfg.block_kind(j), cfg.ffn_kind(j)
    p = {"norm1": L.init_norm(cfg, dev, lead=lead)}
    if kind == "attn":
        p["attn"] = L.init_attention(gen, cfg, dev, lead=lead)
    else:
        p["mamba"] = SSM.init_mamba(gen, cfg, dev, lead=lead)
    if ffn != "none":
        p["norm2"] = L.init_norm(cfg, dev, lead=lead)
        if ffn == "moe":
            p["moe"] = MOE.init_moe(gen, cfg, dev, lead=lead)
            if cfg.moe_shared:
                p["mlp_shared"] = L.init_mlp(gen, cfg, dev, lead=lead,
                                             d_ff=cfg.shared_d_ff)
        else:
            p["mlp"] = L.init_mlp(gen, cfg, dev, lead=lead)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device="cuda") -> dict:
    """Random f32 parameters. `generator` defaults to one on `device`
    seeded with 0; draws happen on the generator's device."""
    assert cfg.num_layers % cfg.superblock == 0, \
        f"{cfg.name}: num_layers % superblock != 0"
    dev = resolve(device)
    gen = generator
    if gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
    lead = (cfg.num_layers // cfg.superblock,)
    # the blocks are drawn before the embedding (the draw order fixes what
    # a seed gives)
    blocks = [_init_block(gen, cfg, j, dev, lead)
              for j in range(cfg.superblock)]
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
    """Per superblock position: the KV cache blocks[j]["k"|"v"] of shape
    [n_super, B, max_seq, KH, hd] for attention, the SSM state
    blocks[j]["conv"|"ssm"] for mamba; and the per-row length `pos`
    (i32[B])."""
    dev = resolve(device)
    n_super = cfg.num_layers // cfg.superblock
    blocks = []
    for j in range(cfg.superblock):
        if cfg.block_kind(j) == "attn":
            kv_shape = (n_super, batch, max_seq, cfg.num_kv_heads, cfg.hd)
            blocks.append({"k": torch.zeros(kv_shape, dtype=dtype,
                                            device=dev),
                           "v": torch.zeros(kv_shape, dtype=dtype,
                                            device=dev)})
        else:
            blocks.append(SSM.init_mamba_cache(cfg, batch, dtype, dev,
                                               lead=(n_super,)))
    return {"blocks": blocks,
            "pos": torch.zeros(batch, dtype=torch.int32, device=dev)}


# --------------------------------------------------------------------------
# superblock forward
# --------------------------------------------------------------------------

def expert_parallel(cfg: ModelConfig) -> bool:
    """Whether the MoE layers run expert parallelism over the mesh's
    'model' axis: REPRO_MOE_EP=1 and an active mesh whose 'model' axis
    divides num_experts, read on every call."""
    import os
    from ..dist.sharding import active_mesh
    mesh = active_mesh()
    return (os.environ.get("REPRO_MOE_EP", "0") == "1" and mesh is not None
            and "model" in mesh.axis_names
            and cfg.num_experts % mesh.shape["model"] == 0)


def _moe_dispatch(p, x, cfg: ModelConfig):
    """`moe.apply_moe`, or `expert_parallel.apply_moe_ep` where
    `expert_parallel(cfg)`."""
    if expert_parallel(cfg):
        from ..dist.expert_parallel import apply_moe_ep
        return apply_moe_ep(p, x, cfg)
    return MOE.apply_moe(p, x, cfg)


def _residual(x, out, cfg: ModelConfig):
    """x plus a sublayer's output, scaled by `residual_multiplier` where
    it is not 1."""
    if cfg.residual_multiplier != 1.0:
        out = out * cfg.residual_multiplier
    return x + out


def _superblock_fwd(p_sb, x, cache_sb, positions, cfg: ModelConfig,
                    mode: str, cache_pos, out_sb=None, length=None):
    """out_sb: the superblock's rows of the cache the new cache is written
    into (the prefill's: the cache it reads); the new cache returned is
    then None. length (prefill): the real lengths of right-padded rows
    (`forward`)."""
    new_cache = []
    for j in range(cfg.superblock):
        kind, ffn = cfg.block_kind(j), cfg.ffn_kind(j)
        p = p_sb["blocks"][j]
        x = probe_site("block", x, kind=E.KIND_ENTRY)
        h = L.apply_norm(p["norm1"], x, cfg)
        c = cache_sb["blocks"][j] if cache_sb is not None else None
        o = out_sb["blocks"][j] if out_sb is not None else None
        if kind == "attn":
            if mode == "train":
                out, _ = L.attention_block(p["attn"], h, positions, cfg)
                new_cache.append(None)
            elif mode == "prefill":
                out, (k_new, v_new) = L.attention_block(p["attn"], h,
                                                        positions, cfg)
                o["k"][:, :x.shape[1]] = k_new
                o["v"][:, :x.shape[1]] = v_new
            else:  # decode
                out, kv = L.attention_block(
                    p["attn"], h, positions, cfg, cache=(c["k"], c["v"]),
                    cache_pos=cache_pos,
                    cache_out=None if o is None else (o["k"], o["v"]))
                new_cache.append({"k": kv[0], "v": kv[1]})
        else:
            if mode == "train":
                out, c = SSM.apply_mamba(p["mamba"], h, cfg)
            elif mode == "prefill":
                out, c = SSM.apply_mamba(p["mamba"], h, cfg,
                                         return_state=True, length=length)
            else:
                out, c = SSM.apply_mamba(p["mamba"], h, cfg, cache=c)
            if o is not None:
                for f in c:
                    o[f].copy_(c[f])
            new_cache.append(c)
        out = probe_site("attn.out" if kind == "attn" else "ssm.out", out)
        x = _residual(x, out, cfg)

        if ffn != "none":
            h2 = L.apply_norm(p["norm2"], x, cfg)
            if ffn == "moe":
                f = _moe_dispatch(p["moe"], h2, cfg)
                if cfg.moe_shared:
                    f = f + L.apply_mlp(p["mlp_shared"], h2, cfg)
            else:
                f = L.apply_mlp(p["mlp"], h2, cfg)
            f = probe_site("ffn.out", f)
            x = _residual(x, f, cfg)
        x = probe_site("block", x, kind=E.KIND_EXIT)
    return x, (new_cache if out_sb is None else None)


# --------------------------------------------------------------------------
# full forward
# --------------------------------------------------------------------------

def forward(params, tokens, cfg: ModelConfig, *, embeds=None,
            positions=None, cache=None, mode: str = "train",
            remat: bool = False, cache_out=None, length=None):
    """tokens: [B, S_text] int; embeds: [B, S_front, D] modality stub
    (prepended); positions: [B, S], or [B, S, 3] for M-RoPE (default iota,
    or the cache length when decoding, on all three axes for M-RoPE);
    remat recomputes each superblock's activations in the backward pass;
    cache_out (decode): a cache shaped like `cache` that the new cache is
    written into and returned as, `cache` only read; the prefill writes
    the new cache into `cache` and returns it (every caller gives it a
    fresh cache, or one whose rows past the prompt are masked by its
    length); length (prefill): [B] int64 real lengths of right-padded
    rows: the
    cache's length grows by them, and a Mamba-2 mixer's state is the one
    at the real length (`ssm.apply_mamba`). Attention is causal, so a real
    row sees no padded one; the padded rows' K/V land at positions the
    new length masks. Returns (logits f32 [B, S, V], new_cache|None)."""
    x = L.embed(params["embed"], tokens, cfg)
    if cfg.embedding_multiplier != 1.0:
        x = x * cfg.embedding_multiplier
    if embeds is not None:
        x = torch.cat([embeds.to(x.dtype), x], dim=1)
    B, S, _ = x.shape
    if positions is None:
        if mode == "decode" and cache is not None:
            positions = cache["pos"][:, None]                  # [B, 1]
        else:
            positions = torch.arange(S, dtype=torch.int32,
                                     device=x.device).expand(B, S)
        if cfg.rope_kind == "mrope":
            positions = positions[..., None].expand(*positions.shape, 3)
    x = probe_site("embed.out", x)

    cache_pos = cache["pos"] if (cache is not None and mode == "decode") \
        else None

    def body(x, xs):
        p_sb, c_sb, *out_sb = xs
        return _superblock_fwd(p_sb, x, c_sb, positions, cfg, mode,
                               cache_pos, *out_sb, length=length)

    if cache is None:
        x, _ = E.probed_scan(lambda c, p_sb: (body(c, (p_sb, None))[0], None),
                             x, params["stack"], remat=remat)
        new_cache = None
    else:
        if mode == "prefill":
            cache_out = cache
        xs = (params["stack"], {"blocks": cache["blocks"]})
        if cache_out is not None:
            xs += ({"blocks": cache_out["blocks"]},)
        x, new_blocks = E.probed_scan(body, x, xs, remat=remat)
        grown = S if length is None else length.to(cache["pos"].dtype)
        new_pos = cache["pos"] + (grown if mode != "train" else 0)
        if cache_out is None:
            new_cache = {"blocks": new_blocks, "pos": new_pos}
        else:
            cache_out["pos"].copy_(new_pos)
            new_cache = cache_out

    x = L.apply_norm(params["final_norm"], x, cfg)
    logits = L.unembed(params["embed"], x, cfg).to(F32)
    if cfg.logits_scaling != 1.0:
        logits = logits / cfg.logits_scaling
    logits = probe_site("logits", logits)
    return logits, new_cache
