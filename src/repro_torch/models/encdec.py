"""Encoder-decoder backbone (SeamlessM4T-medium's T2TT/S2TT transformer).

The audio/text modality frontend is a stub, as in the JAX package: encoder
inputs arrive as precomputed frame embeddings [B, S_enc, D]. The encoder
is non-causal self-attention; the decoder is causal self-attention plus
cross attention over the encoder's output. Both stacks keep their layers
on dim 0 of every leaf (the JAX package's vmapped init) and loop over them
with `events.probed_scan`.

Probe sites: enc.in, enc.block (uretprobe); dec.block (uretprobe, the
teacher-forced pass only). The serving decoder has no site.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..core import events as E
from ..core.events import probe_site
from ..device import resolve
from ..kernels import ops
from . import layers as L

F32 = torch.float32


def _init_layer(gen, cfg: ModelConfig, dev, lead, cross: bool):
    p = {"norm1": L.init_norm(cfg, dev, lead=lead),
         "attn": L.init_attention(gen, cfg, dev, lead=lead),
         "norm2": L.init_norm(cfg, dev, lead=lead),
         "mlp": L.init_mlp(gen, cfg, dev, lead=lead)}
    if cross:
        p["norm_x"] = L.init_norm(cfg, dev, lead=lead)
        p["xattn"] = L.init_attention(gen, cfg, dev, lead=lead)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator | None = None,
                device="cuda") -> dict:
    """Random f32 parameters: `encoder` and `decoder` with the layer on dim
    0 of every leaf, `embed`, `enc_norm` and `dec_norm`. `generator`
    defaults to one on `device` seeded with 0."""
    dev = resolve(device)
    gen = generator
    if gen is None:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
    enc = _init_layer(gen, cfg, dev, (cfg.enc_layers,), cross=False)
    dec = _init_layer(gen, cfg, dev, (cfg.dec_layers,), cross=True)
    return {
        "embed": L.init_embedding(gen, cfg, dev),
        "encoder": enc,
        "decoder": dec,
        "enc_norm": L.init_norm(cfg, dev),
        "dec_norm": L.init_norm(cfg, dev),
    }


def _iota(B, S, device):
    return torch.arange(S, dtype=torch.int32, device=device).expand(B, S)


def encode(params, embeds, cfg: ModelConfig, remat: bool = False):
    """embeds: [B, S_enc, D] (the frontend stub's output). Above 2048
    frames the self-attention is `ops.flash_attention` (non-causal): the
    Hopper kernel on a CUDA tensor, where the JAX package runs the chunked
    online softmax its TPU target executes as the Pallas kernel."""
    B, S, _ = embeds.shape
    x = embeds.to(L.cdtype(cfg))
    pos = _iota(B, S, x.device)
    x = probe_site("enc.in", x)

    def body(c, p):
        h = L.apply_norm(p["norm1"], c, cfg)
        q, k, v = L._qkv(p["attn"], h, cfg)
        q = L.apply_rope(q, pos, cfg)
        k = L.apply_rope(k, pos, cfg)
        if S > 2048:
            o = ops.flash_attention(q, k, v, causal=False)
        else:
            o = L.full_attention(q, k, v, causal=False)
        c = c + (o.reshape(B, S, -1) @ p["attn"]["wo"].to(c.dtype))
        h2 = L.apply_norm(p["norm2"], c, cfg)
        c = c + L.apply_mlp(p["mlp"], h2, cfg)
        c = probe_site("enc.block", c, kind=E.KIND_EXIT)
        return c, None

    x, _ = E.probed_scan(body, x, params["encoder"], remat=remat)
    return L.apply_norm(params["enc_norm"], x, cfg)


def _cross_kv(p_layer, enc_out, cfg: ModelConfig):
    B, Se, _ = enc_out.shape
    KH, hd = cfg.num_kv_heads, cfg.hd
    k = enc_out @ p_layer["xattn"]["wk"].to(enc_out.dtype)
    v = enc_out @ p_layer["xattn"]["wv"].to(enc_out.dtype)
    return k.reshape(B, Se, KH, hd), v.reshape(B, Se, KH, hd)


def _dec_tail(p, c, pos, enc_kv, cfg: ModelConfig):
    """The decoder layer after its self-attention: cross attention over
    `enc_kv`, then the MLP, each with its residual."""
    hx = L.apply_norm(p["norm_x"], c, cfg)
    xout, _ = L.attention_block(p["xattn"], hx, pos, cfg, cross_kv=enc_kv)
    c = c + xout
    h2 = L.apply_norm(p["norm2"], c, cfg)
    return c + L.apply_mlp(p["mlp"], h2, cfg)


def decode_train(params, tokens, enc_out, cfg: ModelConfig,
                 remat: bool = False):
    """Teacher-forced decoder pass. tokens: [B, S_dec]. Returns logits
    f32 [B, S_dec, V]."""
    x = L.embed(params["embed"], tokens, cfg)
    B, S, _ = x.shape
    pos = _iota(B, S, x.device)

    def body(c, p):
        h = L.apply_norm(p["norm1"], c, cfg)
        out, _ = L.attention_block(p["attn"], h, pos, cfg)
        c = _dec_tail(p, c + out, pos, _cross_kv(p, enc_out, cfg), cfg)
        c = probe_site("dec.block", c, kind=E.KIND_EXIT)
        return c, None

    x, _ = E.probed_scan(body, x, params["decoder"], remat=remat)
    x = L.apply_norm(params["dec_norm"], x, cfg)
    return L.unembed(params["embed"], x, cfg).to(F32)


def forward_train(params, batch, cfg: ModelConfig, remat: bool = False):
    enc_out = encode(params, batch["enc_embeds"], cfg, remat=remat)
    return decode_train(params, batch["tokens"], enc_out, cfg, remat=remat)


# ------------------------------------------------------------------ serving

def init_dec_cache(cfg: ModelConfig, batch: int, max_seq: int, enc_seq: int,
                   dtype, device="cuda") -> dict:
    """Per decoder layer (dim 0): the self-attention cache k, v [n, B,
    max_seq, KH, hd], the cross-attention cache xk, xv [n, B, enc_seq, KH,
    hd]; and the per-row length `pos` (i32[B])."""
    dev = resolve(device)
    n, KH, hd = cfg.dec_layers, cfg.num_kv_heads, cfg.hd

    def zeros(s):
        return torch.zeros((n, batch, s, KH, hd), dtype=dtype, device=dev)
    return {"k": zeros(max_seq), "v": zeros(max_seq),
            "xk": zeros(enc_seq), "xv": zeros(enc_seq),
            "pos": torch.zeros(batch, dtype=torch.int32, device=dev)}


def prefill(params, tokens, enc_out, cache, cfg: ModelConfig):
    """Teacher-forced prefill of S_dec tokens and the cross k/v. The
    returned cache's xk, xv are the encoder's own length (they replace the
    given ones, as the JAX scan's outputs do)."""
    x = L.embed(params["embed"], tokens, cfg)
    B, S, _ = x.shape
    pos = _iota(B, S, x.device)
    start = torch.zeros(B, dtype=torch.int64, device=x.device)

    def body(c, xs):
        p, ck = xs
        h = L.apply_norm(p["norm1"], c, cfg)
        out, (k, v) = L.attention_block(p["attn"], h, pos, cfg)
        xk, xv = _cross_kv(p, enc_out, cfg)
        c = _dec_tail(p, c + out, pos, (xk, xv), cfg)
        return c, {"k": L._write_cache(ck["k"], k, start),
                   "v": L._write_cache(ck["v"], v, start),
                   "xk": xk.to(ck["xk"].dtype), "xv": xv.to(ck["xv"].dtype)}

    xs = (params["decoder"], {f: cache[f] for f in ("k", "v", "xk", "xv")})
    x, nc = E.probed_scan(body, x, xs)
    x = L.apply_norm(params["dec_norm"], x, cfg)
    logits = L.unembed(params["embed"], x, cfg).to(F32)
    return logits, {**nc, "pos": cache["pos"] + S}


def decode_step(params, tokens, cache, cfg: ModelConfig):
    """tokens: [B, 1]. Returns (logits [B, 1, V], new cache). The cross
    cache is read, never written: the new cache holds the same xk, xv."""
    x = L.embed(params["embed"], tokens, cfg)
    pos = cache["pos"][:, None]

    def body(c, xs):
        p, ck = xs
        h = L.apply_norm(p["norm1"], c, cfg)
        out, (k, v) = L.attention_block(p["attn"], h, pos, cfg,
                                        cache=(ck["k"], ck["v"]),
                                        cache_pos=cache["pos"])
        c = _dec_tail(p, c + out, pos, (ck["xk"], ck["xv"]), cfg)
        return c, {"k": k, "v": v}

    xs = (params["decoder"], {f: cache[f] for f in ("k", "v", "xk", "xv")})
    x, nc = E.probed_scan(body, x, xs)
    x = L.apply_norm(params["dec_norm"], x, cfg)
    logits = L.unembed(params["embed"], x, cfg).to(F32)
    return logits, {**nc, "xk": cache["xk"], "xv": cache["xv"],
                    "pos": cache["pos"] + 1}
