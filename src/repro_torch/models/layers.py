"""Core model layers: norms, RoPE/M-RoPE, GQA attention (grouped-head
einsums -- KV is never materialized repeated; a chunked online-softmax
formulation for long sequences; cross attention over an encoder's k and
v), SwiGLU/GeLU MLP, embeddings.

Layouts follow the JAX package at every public function: weights are
[in, out] and used as `x @ w`; q/k/v are [B, S, H, hd]. Parameters are
kept in f32 and cast to the compute dtype at use; serving hands in those
leaves already in the compute type (`registry.serving_params`), where the
cast returns them as they are. Large products are plain `torch.matmul`.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from ..configs.base import ModelConfig
from ..kernels import ops

F32 = torch.float32


def cdtype(cfg: ModelConfig):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def randn(gen: torch.Generator, shape, scale: float, device) -> torch.Tensor:
    """f32 normal(0, scale) drawn from `gen`, moved to `device`."""
    x = torch.randn(shape, generator=gen, dtype=F32, device=gen.device)
    return (x * scale).to(device)


# --------------------------------------------------------------------------
# norms
# --------------------------------------------------------------------------

def init_norm(cfg: ModelConfig, device, lead=()):
    d = cfg.d_model
    p = {"scale": torch.ones(lead + (d,), dtype=F32, device=device)}
    if cfg.norm == "layernorm":
        p["bias"] = torch.zeros(lead + (d,), dtype=F32, device=device)
    return p


def apply_norm(p, x, cfg: ModelConfig):
    xf = x.to(F32)
    if cfg.norm == "layernorm":
        mu = xf.mean(dim=-1, keepdim=True)
        var = (xf - mu).square().mean(dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + cfg.norm_eps)
        y = y * p["scale"] + p["bias"]
    else:
        ms = xf.square().mean(dim=-1, keepdim=True)
        y = xf * torch.rsqrt(ms + cfg.norm_eps) * p["scale"]
    return y.to(x.dtype)


# --------------------------------------------------------------------------
# rotary embeddings
# --------------------------------------------------------------------------

def _rope_freqs(cfg: ModelConfig, device):
    hd = cfg.hd
    exponent = torch.arange(0, hd, 2, dtype=F32, device=device) / hd
    return 1.0 / torch.pow(float(cfg.rope_theta), exponent)


def apply_rope(x, positions, cfg: ModelConfig):
    """x: [..., S, H, hd]; positions: [..., S] integer, or [..., S, 3] for
    M-RoPE (Qwen2-VL): the hd/2 frequency slots split into
    `cfg.mrope_sections` (temporal, height, width), each slot turning by
    its axis' position."""
    freqs = _rope_freqs(cfg, x.device)                   # [hd/2]
    if cfg.rope_kind == "mrope":
        if positions.ndim != x.ndim - 1:
            raise ValueError("M-RoPE needs positions [..., S, 3]")
        axis = torch.cat([torch.full((n,), i) for i, n in
                          enumerate(cfg.mrope_sections)]).to(x.device)
        # the axis' position in f32, then times the frequency (JAX's order)
        ang = positions.to(F32)[..., axis] * freqs      # [..., S, hd/2]
    else:
        ang = positions.to(F32)[..., None] * freqs      # [..., S, hd/2]
    cos = torch.cos(ang)[..., None, :]                  # [..., S, 1, hd/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.to(F32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def mrope_grid_positions(rows: int, cols: int, n_text: int, batch: int = 1,
                         device="cpu"):
    """M-RoPE ids [batch, rows * cols + n_text, 3] (temporal, height,
    width) for a frontend of rows x cols patch embeddings followed by text:
    a patch at (r, c) gets (0, r, c), the i-th text token
    max(rows, cols) + i on all three axes."""
    r = torch.arange(rows).repeat_interleave(cols)
    c = torch.arange(cols).repeat(rows)
    patches = torch.stack([torch.zeros_like(r), r, c], dim=-1)
    text = (max(rows, cols) + torch.arange(n_text))[:, None].expand(-1, 3)
    ids = torch.cat([patches, text]).to(torch.int32)
    return ids.expand(batch, -1, -1).to(device)


# --------------------------------------------------------------------------
# attention (GQA, grouped-head; chunked online softmax for long sequences)
# --------------------------------------------------------------------------

def init_attention(gen, cfg: ModelConfig, device, lead=()):
    D, H, KH, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.hd
    s = 1.0 / math.sqrt(D)
    p = {
        "wq": randn(gen, lead + (D, H * hd), s, device),
        "wk": randn(gen, lead + (D, KH * hd), s, device),
        "wv": randn(gen, lead + (D, KH * hd), s, device),
        "wo": randn(gen, lead + (H * hd, D), s, device),
    }
    if cfg.qkv_bias:
        p["bq"] = torch.zeros(lead + (H * hd,), dtype=F32, device=device)
        p["bk"] = torch.zeros(lead + (KH * hd,), dtype=F32, device=device)
        p["bv"] = torch.zeros(lead + (KH * hd,), dtype=F32, device=device)
    return p


# the leaves each module of this file uses only through a cast to the
# compute type (`registry.serving_params` holds them in it for serving);
# the norms' scale and bias enter f32 arithmetic and are declared nowhere
ATTENTION_CAST_LEAVES = ("wq", "wk", "wv", "wo", "bq", "bk", "bv")


def _qkv(p, x, cfg: ModelConfig):
    B, S, _ = x.shape
    H, KH, hd = cfg.num_heads, cfg.num_kv_heads, cfg.hd
    dt = x.dtype
    q = x @ p["wq"].to(dt)
    k = x @ p["wk"].to(dt)
    v = x @ p["wv"].to(dt)
    if cfg.qkv_bias:
        q = q + p["bq"].to(dt)
        k = k + p["bk"].to(dt)
        v = v + p["bv"].to(dt)
    return (q.reshape(B, S, H, hd), k.reshape(B, S, KH, hd),
            v.reshape(B, S, KH, hd))


def _grouped(q, KH):
    """[B, S, H, hd] -> [B, S, KH, R, hd]"""
    B, S, H, hd = q.shape
    return q.reshape(B, S, KH, H // KH, hd)


def full_attention(q, k, v, *, causal, kv_len=None, scale=None):
    """Small-S / decode path. q: [B,Sq,H,hd]; k,v: [B,Skv,KH,hd].
    kv_len: [B] valid cache length mask (decode). scale: the softmax's
    (None: 1/sqrt(hd))."""
    B, Sq, H, hd = q.shape
    KH = k.shape[2]
    Skv = k.shape[1]
    qg = _grouped(q, KH)
    s = torch.einsum("bqkrh,bskh->bkrqs", qg.to(F32), k.to(F32))
    s = s / math.sqrt(hd) if scale is None else s * scale
    neg = float("-inf")
    if causal:
        qpos = torch.arange(Sq, device=q.device)[:, None]
        kpos = torch.arange(Skv, device=q.device)[None, :]
        s = torch.where(qpos >= kpos, s, neg)
    if kv_len is not None:
        mask = torch.arange(Skv, device=q.device)[None, :] < kv_len[:, None]
        s = torch.where(mask[:, None, None, None, :], s, neg)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkrqs,bskh->bqkrh", p, v.to(F32))
    return o.reshape(B, Sq, H, hd).to(q.dtype)


def flash_attention(q, k, v, *, causal=True, q_chunk=2048, kv_chunk=2048,
                    scale=None):
    """Chunked online-softmax attention: outer loop over q chunks, inner
    loop over kv chunks, f32 accumulators. Never materializes [Sq, Skv].
    scale: the softmax's (None: 1/sqrt(hd))."""
    B, Sq, H, hd = q.shape
    KH = k.shape[2]
    Skv = k.shape[1]
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Skv)
    assert Sq % q_chunk == 0 and Skv % kv_chunk == 0
    nq, nk = Sq // q_chunk, Skv // kv_chunk
    if scale is None:
        scale = 1.0 / math.sqrt(hd)
    R = H // KH
    dev = q.device
    qg = _grouped(q, KH)
    qpos_c = torch.arange(q_chunk, device=dev)
    kpos_c = torch.arange(kv_chunk, device=dev)
    outs = []
    for i in range(nq):
        qi = qg[:, i * q_chunk:(i + 1) * q_chunk].to(F32)
        m = torch.full((B, KH, R, q_chunk), float("-inf"), dtype=F32,
                       device=dev)
        l = torch.zeros((B, KH, R, q_chunk), dtype=F32, device=dev)
        acc = torch.zeros((B, q_chunk, KH, R, hd), dtype=F32, device=dev)
        for j in range(nk):
            kj = k[:, j * kv_chunk:(j + 1) * kv_chunk].to(F32)
            vj = v[:, j * kv_chunk:(j + 1) * kv_chunk].to(F32)
            s = torch.einsum("bqkrh,bskh->bkrqs", qi, kj) * scale
            if causal:
                qp = i * q_chunk + qpos_c[:, None]
                kp = j * kv_chunk + kpos_c[None, :]
                s = torch.where(qp >= kp, s, float("-inf"))
            m_new = torch.maximum(m, s.amax(dim=-1))
            # guard fully-masked rows (exp(-inf - -inf))
            m_safe = torch.where(torch.isneginf(m_new), 0.0, m_new)
            p = torch.exp(s - m_safe[..., None])
            p = torch.where(torch.isneginf(s), 0.0, p)
            corr = torch.exp(torch.where(torch.isneginf(m), m_new, m) - m_safe)
            corr = torch.where(torch.isneginf(m), 0.0, corr)
            l = l * corr + p.sum(dim=-1)
            pv = torch.einsum("bkrqs,bskh->bqkrh", p, vj)
            acc = acc * corr.permute(0, 3, 1, 2)[..., None] + pv
            m = m_new
        l = torch.clamp_min(l, 1e-20)
        outs.append((acc / l.permute(0, 3, 1, 2)[..., None]).to(q.dtype))
    return torch.cat(outs, dim=1).reshape(B, Sq, H, hd)


def _write_cache(c, u, start):
    """Copy of cache c [B, Smax, KH, hd] with u [B, S, KH, hd] written at
    rows start[b] .. start[b] + S - 1. Like the JAX dynamic update, the
    start is clamped so the write stays inside the cache."""
    return _write_rows(c.clone(), u, start)


def _write_rows(out, u, start):
    """u written into the cache `out` in place, as `_write_cache` writes
    its copy; returns out."""
    B, S = u.shape[:2]
    st = start.clamp(0, out.shape[1] - S)
    rows = st[:, None] + torch.arange(S, device=out.device)[None, :]
    out[torch.arange(B, device=out.device)[:, None], rows] = u.to(out.dtype)
    return out


def _scale(cfg: ModelConfig):
    """The softmax scale the config sets (`attention_multiplier`), or None
    for 1/sqrt(hd)."""
    return cfg.attention_multiplier or None


def attention_block(p, x, positions, cfg: ModelConfig, *, cache=None,
                    cache_pos=None, cross_kv=None, cache_out=None):
    """Full attention sublayer. Modes:
      train/prefill: cache=None (prefill returns fresh kv for caching)
      decode: cache=(k,v) [B,Smax,KH,hd], cache_pos [B] current length;
        with cache_out=(k,v) of the same shapes the new cache is written
        there (the given rows copied across, then the new ones) and the
        given cache is only read
      cross: cross_kv=(k,v) [B,Se,KH,hd] precomputed from the encoder (q
        from wq alone: no bias, no rope; new_cache_kv is None)
    Returns (out, new_cache_kv)."""
    B, S, _ = x.shape
    if cross_kv is not None:
        H, hd = cfg.num_heads, cfg.hd
        q = (x @ p["wq"].to(x.dtype)).reshape(B, S, H, hd)
        o = full_attention(q, *cross_kv, causal=False)
        return o.reshape(B, S, H * hd) @ p["wo"].to(x.dtype), None

    q, k, v = _qkv(p, x, cfg)
    if cfg.rope_kind != "none":
        q = apply_rope(q, positions, cfg)
        k = apply_rope(k, positions, cfg)

    if cache is not None:
        ck, cv = cache
        if cache_out is None:
            ck = _write_cache(ck, k, cache_pos)
            cv = _write_cache(cv, v, cache_pos)
        else:
            ck = _write_rows(cache_out[0].copy_(ck), k, cache_pos)
            cv = _write_rows(cache_out[1].copy_(cv), v, cache_pos)
        o = full_attention(q, ck, cv, causal=False, kv_len=cache_pos + S,
                           scale=_scale(cfg))
        out = (o.reshape(B, S, cfg.num_heads * cfg.hd)
               @ p["wo"].to(x.dtype))
        return out, (ck, cv)

    # above 2048 tokens both branches of the JAX code (either side of its
    # FLASH_THRESHOLD, which only sets the chunk size) run the chunked
    # online softmax that its TPU target executes as the Pallas kernel;
    # here that is `ops.flash_attention`, the Hopper kernels on a CUDA
    # tensor. `flash_attention` above stays as the model-level reference.
    if S <= 2048:
        o = full_attention(q, k, v, causal=True, scale=_scale(cfg))
    else:
        o = ops.flash_attention(q, k, v, causal=True, scale=_scale(cfg))
    out = o.reshape(B, S, cfg.num_heads * cfg.hd) @ p["wo"].to(x.dtype)
    return out, (k, v)


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------

def init_mlp(gen, cfg: ModelConfig, device, lead=(), d_ff=None):
    D, Fh = cfg.d_model, (d_ff or cfg.d_ff)
    p = {"wi": randn(gen, lead + (D, Fh), 1.0 / math.sqrt(D), device),
         "wo": randn(gen, lead + (Fh, D), 1.0 / math.sqrt(Fh), device)}
    if cfg.act == "swiglu":
        p["wg"] = randn(gen, lead + (D, Fh), 1.0 / math.sqrt(D), device)
    return p


MLP_CAST_LEAVES = ("wi", "wg", "wo")


def apply_mlp(p, x, cfg: ModelConfig):
    dt = x.dtype
    h = x @ p["wi"].to(dt)
    if cfg.act == "swiglu":
        g = x @ p["wg"].to(dt)
        h = F.silu(g.to(F32)).to(dt) * h
    else:
        # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(h.to(F32), approximate="tanh").to(dt)
    return h @ p["wo"].to(dt)


# --------------------------------------------------------------------------
# embeddings / head
# --------------------------------------------------------------------------

def init_embedding(gen, cfg: ModelConfig, device):
    p = {"embedding": randn(gen, (cfg.padded_vocab, cfg.d_model), 0.02,
                            device)}
    if not cfg.tie_embeddings:
        p["lm_head"] = randn(gen, (cfg.d_model, cfg.padded_vocab), 0.02,
                             device)
    return p


# the gather commutes with the cast, bit for bit
EMBEDDING_CAST_LEAVES = ("embedding", "lm_head")


def embed(p, tokens, cfg: ModelConfig):
    return p["embedding"][tokens].to(cdtype(cfg))


def unembed(p, x, cfg: ModelConfig):
    w = p["embedding"].T if cfg.tie_embeddings else p["lm_head"]
    return x @ w.to(x.dtype)
