"""Core model layers: norms, RoPE, GQA attention (grouped-head einsums --
KV is never materialized repeated; a chunked online-softmax formulation
for long sequences), SwiGLU/GeLU MLP, embeddings.

Layouts follow the JAX package at every public function: weights are
[in, out] and used as `x @ w`; q/k/v are [B, S, H, hd]. Parameters are
kept in f32 and cast to the compute dtype at use. Large products are
plain `torch.matmul`.
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
    """x: [..., S, H, hd]; positions: [..., S] integer."""
    if cfg.rope_kind == "mrope":
        raise NotImplementedError("M-RoPE comes with the VLM slice "
                                  "(ROADMAP A13)")
    freqs = _rope_freqs(cfg, x.device)                   # [hd/2]
    ang = positions.to(F32)[..., None] * freqs          # [..., S, hd/2]
    cos = torch.cos(ang)[..., None, :]                  # [..., S, 1, hd/2]
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.to(F32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


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


def full_attention(q, k, v, *, causal, kv_len=None):
    """Small-S / decode path. q: [B,Sq,H,hd]; k,v: [B,Skv,KH,hd].
    kv_len: [B] valid cache length mask (decode)."""
    B, Sq, H, hd = q.shape
    KH = k.shape[2]
    Skv = k.shape[1]
    qg = _grouped(q, KH)
    s = torch.einsum("bqkrh,bskh->bkrqs", qg.to(F32), k.to(F32))
    s = s / math.sqrt(hd)
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


def flash_attention(q, k, v, *, causal=True, q_chunk=2048, kv_chunk=2048):
    """Chunked online-softmax attention: outer loop over q chunks, inner
    loop over kv chunks, f32 accumulators. Never materializes [Sq, Skv]."""
    B, Sq, H, hd = q.shape
    KH = k.shape[2]
    Skv = k.shape[1]
    q_chunk = min(q_chunk, Sq)
    kv_chunk = min(kv_chunk, Skv)
    assert Sq % q_chunk == 0 and Skv % kv_chunk == 0
    nq, nk = Sq // q_chunk, Skv // kv_chunk
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
    B, S = u.shape[:2]
    st = start.clamp(0, c.shape[1] - S)
    rows = st[:, None] + torch.arange(S, device=c.device)[None, :]
    out = c.clone()
    out[torch.arange(B, device=c.device)[:, None], rows] = u.to(c.dtype)
    return out


def attention_block(p, x, positions, cfg: ModelConfig, *, cache=None,
                    cache_pos=None):
    """Full attention sublayer. Modes:
      train/prefill: cache=None (prefill returns fresh kv for caching)
      decode: cache=(k,v) [B,Smax,KH,hd], cache_pos [B] current length
    Returns (out, new_cache_kv)."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg)
    if cfg.rope_kind != "none":
        q = apply_rope(q, positions, cfg)
        k = apply_rope(k, positions, cfg)

    if cache is not None:
        ck, cv = cache
        ck = _write_cache(ck, k, cache_pos)
        cv = _write_cache(cv, v, cache_pos)
        o = full_attention(q, ck, cv, causal=False, kv_len=cache_pos + S)
        out = (o.reshape(B, S, cfg.num_heads * cfg.hd)
               @ p["wo"].to(x.dtype))
        return out, (ck, cv)

    # above 2048 tokens both branches of the JAX code (either side of its
    # FLASH_THRESHOLD, which only sets the chunk size) run the chunked
    # online softmax that its TPU target executes as the Pallas kernel;
    # here that is `ops.flash_attention`, the Hopper kernels on a CUDA
    # tensor. `flash_attention` above stays as the model-level reference.
    if S <= 2048:
        o = full_attention(q, k, v, causal=True)
    else:
        o = ops.flash_attention(q, k, v, causal=True)
    out = o.reshape(B, S, cfg.num_heads * cfg.hd) @ p["wo"].to(x.dtype)
    return out, (k, v)


# --------------------------------------------------------------------------
# MLP
# --------------------------------------------------------------------------

def init_mlp(gen, cfg: ModelConfig, device, lead=()):
    D, Fh = cfg.d_model, cfg.d_ff
    p = {"wi": randn(gen, lead + (D, Fh), 1.0 / math.sqrt(D), device),
         "wo": randn(gen, lead + (Fh, D), 1.0 / math.sqrt(Fh), device)}
    if cfg.act == "swiglu":
        p["wg"] = randn(gen, lead + (D, Fh), 1.0 / math.sqrt(D), device)
    return p


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


def embed(p, tokens, cfg: ModelConfig):
    return p["embedding"][tokens].to(cdtype(cfg))


def unembed(p, x, cfg: ModelConfig):
    w = p["embedding"].T if cfg.tie_embeddings else p["lm_head"]
    return x @ w.to(x.dtype)
