"""Mamba-2 (SSD -- state-space duality, arXiv:2405.21060) block.

Training/prefill uses the chunked dual form: intra-chunk attention-like
einsums plus the inter-chunk state recurrence, a Python loop over the
chunks (the `lax.scan` of the JAX package's `repro/models/ssm.py`).
Decode uses the O(1) recurrent step on a carried (conv, ssm) state cache.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import telemetry as T
from ..configs.base import ModelConfig
from .layers import randn

F32 = torch.float32
F64 = torch.float64


# --------------------------------------------------------------------------
# A_log = log(linspace(1, 16, nh)) in f32, bit for bit as the JAX package
# computes it on the CPU: XLA turns the linspace's division into a product
# by the reciprocal, fuses multiply-adds, and evaluates log as a Cephes
# polynomial. torch.linspace and torch.log differ from it in the last bit
# of some heads. Computed on the CPU, an FMA as one f64 rounding.
# --------------------------------------------------------------------------

def _fma(a, b, c):
    return (a.to(F64) * b.to(F64) + c.to(F64)).to(F32)


def _f32(hexstr: str):
    return torch.tensor(float.fromhex(hexstr), dtype=F64).to(F32)


def _linspace_1_16(n: int):
    it = torch.arange(n - 1, dtype=F32)
    r = torch.ones((), dtype=F32) / (n - 1)
    return torch.cat([_fma(it, 16 * r, 1.0 - it * r),
                      torch.full((1,), 16.0, dtype=F32)])


def _log(x):
    """log of positive normal f32 x."""
    bits = x.view(torch.int32)
    m = ((bits & -2139095041) | 1056964608).view(F32)     # mantissa, [.5, 1)
    e = 1.0 + ((bits >> 23) - 127).to(F32)
    small = m < _f32("0x1.6A09E6p-1")                     # sqrt(1/2)
    x = (m - 1.0) + torch.where(small, m, torch.zeros_like(m))
    e = e - small.to(F32)
    x2 = x * x
    x3 = x2 * x
    a = _fma(x, _f32("0x1.204376p-4"), _f32("-0x1.D7A37p-4"))
    b = _fma(x, _f32("-0x1.FCBA9Ep-4"), _f32("0x1.23D37Ep-3"))
    c = _fma(x, _f32("0x1.999D58p-3"), _f32("-0x1.FFFFF8p-3"))
    a = _fma(a, x, _f32("0x1.DE4A34p-4"))
    b = _fma(b, x, _f32("-0x1.555CAp-3"))
    c = _fma(c, x, _f32("0x1.555554p-2"))
    b = _fma(a, x3, b)
    c = _fma(b, x3, c)
    y = _fma(c, x3, _f32("-0x1.BD0106p-13") * e)
    x = _fma(torch.tensor(-0.5, dtype=F32), x2, x)
    return _fma(_f32("0x1.63p-1"), e, x + y)


def init_mamba(gen, cfg: ModelConfig, device, lead=()):
    """Random in_proj, conv_w and out_proj; the other leaves are the JAX
    package's constants, to the bit."""
    D = cfg.d_model
    di = cfg.d_inner()
    G, N = cfg.ssm_ngroups, cfg.ssm_state
    nh = cfg.ssm_heads()
    K = cfg.ssm_conv
    proj_out = 2 * di + 2 * G * N + nh    # z, x, B, C, dt
    s = 1.0 / math.sqrt(D)

    def const(v):
        return v.to(device).expand(lead + v.shape).clone()

    return {
        "in_proj": randn(gen, lead + (D, proj_out), s, device),
        "conv_w": randn(gen, lead + (K, di + 2 * G * N), 0.1, device),
        "conv_b": const(torch.zeros(di + 2 * G * N, dtype=F32)),
        "A_log": const(_log(_linspace_1_16(nh))),
        "D": const(torch.ones(nh, dtype=F32)),
        "dt_bias": const(torch.full((nh,), math.log(math.e - 1), dtype=F32)),
        "out_proj": randn(gen, lead + (di, D), 1.0 / math.sqrt(di), device),
        "norm_scale": const(torch.ones(di, dtype=F32)),
    }


# the leaves used only through a cast to the compute type
# (`registry.serving_params` holds them in it for serving); A_log, dt_bias
# and norm_scale enter f32 arithmetic
CAST_LEAVES = ("in_proj", "out_proj", "conv_w", "conv_b", "D")


def _split_proj(zxbcdt, cfg):
    di = cfg.d_inner()
    G, N = cfg.ssm_ngroups, cfg.ssm_state
    z = zxbcdt[..., :di]
    xb = zxbcdt[..., di:2 * di]
    Bv = zxbcdt[..., 2 * di:2 * di + G * N]
    Cv = zxbcdt[..., 2 * di + G * N:2 * di + 2 * G * N]
    dt = zxbcdt[..., 2 * di + 2 * G * N:]
    return z, xb, Bv, Cv, dt


def _causal_conv(x, w, b, state=None, length=None):
    """depthwise causal conv. x: [B, S, C]; w: [K, C]. state: [B, K-1, C]
    (decode). length: [B] real lengths of right-padded rows (None: S); the
    new state is the K-1 inputs that end there. Returns (y, new_state)."""
    K = w.shape[0]
    if state is None:
        pad = x.new_zeros((x.shape[0], K - 1, x.shape[2]))
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                        # [B, S+K-1, C]
    y = sum(xp[:, i:i + x.shape[1], :] * w[i].to(x.dtype)
            for i in range(K))
    y = y + b.to(x.dtype)
    if length is None:
        new_state = xp[:, -(K - 1):, :]
    else:
        at = length[:, None] + torch.arange(K - 1, device=x.device)
        new_state = xp.gather(1, at[..., None].expand(-1, -1, xp.shape[2]))
    return F.silu(y.to(F32)).to(x.dtype), new_state


def _segsum(log_a):
    """log_a: [..., L] -> cumulative decay matrix [..., L, L]:
    out[i, j] = sum(log_a[j+1..i]) for j < i, -inf above diagonal."""
    L = log_a.shape[-1]
    cs = torch.cumsum(log_a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]             # sum (j, i]
    ii = torch.arange(L, device=log_a.device)
    mask = ii[:, None] >= ii[None, :]
    return torch.where(mask, diff, float("-inf"))


def ssd_chunked(xh, dt, A, Bv, Cv, cfg: ModelConfig):
    """SSD dual form.
    xh: [B, S, H, P]; dt: [B, S, H] (post-softplus); A: [H] (negative);
    Bv, Cv: [B, S, G, N]. Returns (y [B, S, H, P], final state f32
    [B, H, P, N]). The chunk is min(ssm_chunk, S). Where S is no multiple
    of it, the last chunk is padded with dt 0, so a padded position
    neither decays the state nor feeds it, and its outputs are dropped
    (the JAX package takes whole chunks only)."""
    Bsz, S0, H, P = xh.shape
    G, N = cfg.ssm_ngroups, cfg.ssm_state
    L = min(cfg.ssm_chunk, S0)
    pad = -S0 % L
    if pad:
        xh, dt, Bv, Cv = (F.pad(t, (0, 0) * (t.ndim - 2) + (0, pad))
                          for t in (xh, dt, Bv, Cv))
    S = S0 + pad
    nc = S // L
    rep = H // G

    xc = xh.reshape(Bsz, nc, L, H, P)
    dtc = dt.reshape(Bsz, nc, L, H)
    Bc = Bv.reshape(Bsz, nc, L, G, N)
    Cc = Cv.reshape(Bsz, nc, L, G, N)
    dA = dtc * A                                           # [B, nc, L, H]
    dA_cs = torch.cumsum(dA, dim=2)                        # within chunk

    # ---- intra-chunk (the "attention" quadrant)
    Lmat = torch.exp(_segsum(dA.permute(0, 1, 3, 2)))      # [B,nc,H,L,L]
    CB = torch.einsum("bclgn,bcsgn->bcgls", Cc.to(F32), Bc.to(F32))
    CB = torch.repeat_interleave(CB, rep, dim=2)           # G -> H
    scores = CB * Lmat * dtc.permute(0, 1, 3, 2)[:, :, :, None, :]
    y_diag = torch.einsum("bchls,bcshp->bclhp", scores, xc.to(F32))

    # ---- chunk states: h_c = sum_s exp(dA_cs[L-1] - dA_cs[s]) dt_s B_s x_s
    decay_to_end = torch.exp(dA_cs[:, :, -1:, :] - dA_cs)  # [B,nc,L,H]
    w = (dtc * decay_to_end).to(F32)
    Brep = torch.repeat_interleave(Bc, rep, dim=3)         # [B,nc,L,H,N]
    states = torch.einsum("bclh,bclhn,bclhp->bchpn",
                          w, Brep.to(F32), xc.to(F32))

    # ---- inter-chunk recurrence over nc (sequential)
    chunk_decay = torch.exp(dA_cs[:, :, -1, :])            # [B,nc,H]
    h_prev, h_final = chunk_scan(states, chunk_decay)

    # ---- inter-chunk output: y_off = C_l . (decay_in * h_prev)
    decay_in = torch.exp(dA_cs)                            # [B,nc,L,H]
    Crep = torch.repeat_interleave(Cc, rep, dim=3)         # [B,nc,L,H,N]
    y_off = torch.einsum("bclhn,bchpn,bclh->bclhp",
                         Crep.to(F32), h_prev, decay_in)
    y = (y_diag + y_off).reshape(Bsz, S, H, P)
    if pad:
        y = y[:, :S0]
    return y.to(xh.dtype), h_final


def chunk_scan(states, chunk_decay):
    """The inter-chunk state recurrence, a Python loop over the chunks (the
    JAX package's `lax.scan`): states [B, nc, H, P, N] f32, chunk_decay
    [B, nc, H]. Returns (the state each chunk starts from [B, nc, H, P, N]
    -- the scan emits the PREVIOUS carry -- and the final state)."""
    h = torch.zeros_like(states[:, 0])
    h_prev = []
    for c in range(states.shape[1]):
        h_prev.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    return torch.stack(h_prev, dim=1), h


def apply_mamba(p, x, cfg: ModelConfig, *, cache=None, return_state=False,
                length=None):
    """x: [B, S, D]. cache: None (train/prefill) or dict(conv, ssm) for
    decode (S must be 1). return_state=True (prefill) returns the final
    (conv, ssm) state as the new cache. length (prefill): [B] real lengths
    of right-padded rows; the positions past them take dt 0, so they
    neither decay the state nor feed it, and the conv state ends at the
    real length. Returns (y [B,S,D], new_cache). Inside the span
    `ssm.mixer`."""
    with T.span("ssm.mixer"):
        return _mamba(p, x, cfg, cache, return_state, length)


def _mamba(p, x, cfg: ModelConfig, cache, return_state, length=None):
    Bsz, S, D = x.shape
    dt_ = x.dtype
    di = cfg.d_inner()
    G, N = cfg.ssm_ngroups, cfg.ssm_state
    H, P = cfg.ssm_heads(), cfg.ssm_headdim

    zxbcdt = x @ p["in_proj"].to(dt_)
    z, xb, Bv, Cv, dtr = _split_proj(zxbcdt, cfg)
    conv_in = torch.cat([xb, Bv, Cv], dim=-1)

    A = -torch.exp(p["A_log"])                             # [H], negative
    conv_out, conv_state = _causal_conv(
        conv_in, p["conv_w"], p["conv_b"],
        None if cache is None else cache["conv"], length)
    xb = conv_out[..., :di]
    Bv = conv_out[..., di:di + G * N].reshape(Bsz, S, G, N)
    Cv = conv_out[..., di + G * N:].reshape(Bsz, S, G, N)
    dt = F.softplus(dtr.to(F32) + p["dt_bias"])            # [B,S,H]
    if length is not None:
        real = torch.arange(S, device=x.device)[None, :] < length[:, None]
        dt = torch.where(real[..., None], dt, 0.0)
    xh = xb.reshape(Bsz, S, H, P)
    skip = xh * p["D"].to(dt_)[None, None, :, None]
    if cache is None:
        y, h_final = ssd_chunked(xh, dt, A, Bv, Cv, cfg)
        y = y + skip
        new_cache = ({"conv": conv_state.to(dt_), "ssm": h_final}
                     if return_state else None)
    else:
        # recurrent step (S == 1)
        dA = torch.exp(dt[:, 0] * A)                       # [B,H]
        Brep = torch.repeat_interleave(Bv[:, 0], H // G, dim=1)  # [B,H,N]
        Crep = torch.repeat_interleave(Cv[:, 0], H // G, dim=1)
        h = cache["ssm"]                                   # [B,H,P,N] f32
        upd = (dt[:, 0, :, None, None] * xh[:, 0].to(F32)[..., None]
               * Brep.to(F32)[:, :, None, :])
        h = h * dA[..., None, None] + upd
        y1 = torch.einsum("bhpn,bhn->bhp", h, Crep.to(F32))
        y = y1[:, None].to(dt_) + skip
        new_cache = {"conv": conv_state.to(dt_), "ssm": h}

    # gated RMSNorm (mamba2's norm-before-out_proj)
    yf = y.reshape(Bsz, S, di).to(F32)
    yf = yf * F.silu(z.to(F32))
    ms = yf.square().mean(dim=-1, keepdim=True)
    yf = yf * torch.rsqrt(ms + 1e-5) * p["norm_scale"]
    out = yf.to(dt_) @ p["out_proj"].to(dt_)
    return out, new_cache


def init_mamba_cache(cfg: ModelConfig, batch: int, dtype, device,
                     lead=()):
    di = cfg.d_inner()
    G, N = cfg.ssm_ngroups, cfg.ssm_state
    return {
        "conv": torch.zeros(lead + (batch, cfg.ssm_conv - 1,
                                    di + 2 * G * N), dtype=dtype,
                            device=device),
        "ssm": torch.zeros(lead + (batch, cfg.ssm_heads(), cfg.ssm_headdim,
                                   N), dtype=F32, device=device),
    }
