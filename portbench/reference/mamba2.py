"""Mamba-2 (arXiv:2405.21060) as the published description has it, in
plain float32: token embedding; per layer RMSNorm and the Mamba-2 mixer
(one input projection to z, x, B, C and dt; a depthwise causal
convolution with SiLU over x, B and C; dt = softplus(dt + dt_bias);
the selective state space y_t = C_t h_t + D x_t with
h_t = exp(dt_t A) h_{t-1} + dt_t B_t x_t; y gated by SiLU(z) and
RMS-normalised; the output projection) with a residual add; a final
RMSNorm and the tied embedding as the output head.

`forward` runs the state space as its recurrence, one position after
another. `loss` needs gradients through 4096 positions, where the
recurrence's autograd graph would not fit, so it uses the same map in
its masked quadratic form, y = (L o C B^T) x with
L[t, s] = exp(sum_{r=s+1..t} dt_r A) dt_s for s <= t (the paper's
definition of the SSD), a block of rows at a time."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .lowp import FLOAT32
from .qwen2 import rms_norm

F32 = torch.float32
# sequences the serving check runs through `forward` at once: the whole
# sample, whose recurrence then takes one position of all of them a step
CHECK_BATCH = 0


def _sizes(m):
    D = m["d_model"]
    di = m.get("ssm_expand", 2) * D
    P = m.get("ssm_headdim", 64)
    return D, di, m.get("ssm_ngroups", 1), m["ssm_state"], di // P, P


def block_leaves(m: dict, j: int) -> list:
    """(path in the stacked layer, shape, kind, scale) of a layer's leaves
    after its norm, in the order the weights are drawn: the mixer's.
    Every layer is alike: the superblock position j is not read."""
    D, di, G, N, H, _ = _sizes(m)
    L, K = m["num_layers"] // m.get("superblock", 1), m.get("ssm_conv", 4)
    conv = di + 2 * G * N
    return [
        (("mamba", "in_proj"), (L, D, 2 * di + 2 * G * N + H), "normal",
         1 / math.sqrt(D)),
        (("mamba", "conv_w"), (L, K, conv), "normal", 0.1),
        (("mamba", "conv_b"), (L, conv), "normal", 0.02),
        (("mamba", "A_log"), (L, H), "a_log", 0.0),
        (("mamba", "D"), (L, H), "one_plus", 0.05),
        (("mamba", "dt_bias"), (L, H), "dt_bias", 0.0),
        (("mamba", "out_proj"), (L, di, D), "normal", 1 / math.sqrt(di)),
        (("mamba", "norm_scale"), (L, di), "one_plus", 0.05),
    ]


def _mixer_inputs(h, p, i, m, mm):
    D, di, G, N, H, P = _sizes(m)
    B_, S, _ = h.shape
    zxbcdt = mm(h, p["in_proj"][i])
    z, xbc, dt = (zxbcdt[..., :di], zxbcdt[..., di:2 * di + 2 * G * N],
                  zxbcdt[..., 2 * di + 2 * G * N:])
    w, K = p["conv_w"][i], p["conv_w"].shape[1]
    xp = F.pad(xbc, (0, 0, K - 1, 0))
    xbc = sum(xp[:, j:j + S] * w[j] for j in range(K)) + p["conv_b"][i]
    xbc = F.silu(xbc)
    x = xbc[..., :di].reshape(B_, S, H, P)
    Bm = xbc[..., di:di + G * N].reshape(B_, S, G, N)
    Cm = xbc[..., di + G * N:].reshape(B_, S, G, N)
    dt = F.softplus(dt + p["dt_bias"][i])                 # [B, S, H]
    A = -torch.exp(p["A_log"][i])                         # [H]
    return z, x, Bm, Cm, dt, A


def ssm_recurrent(x, Bm, Cm, dt, A, return_state=False):
    """x [B, S, H, P]; Bm, Cm [B, S, G, N] (head h reads group
    h // (H / G)); dt [B, S, H]; A [H] -> y [B, S, H, P], one position
    after another (and the last state h [B, H, P, N] with
    return_state)."""
    B_, S, H, P = x.shape
    rep = H // Bm.shape[2]
    Bm, Cm = Bm.repeat_interleave(rep, 2), Cm.repeat_interleave(rep, 2)
    h = x.new_zeros(B_, H, P, Bm.shape[-1])
    ys = []
    for t in range(S):
        h = h * torch.exp(dt[:, t] * A)[..., None, None] + \
            (dt[:, t, :, None] * x[:, t])[..., None] * Bm[:, t, :, None, :]
        ys.append(torch.einsum("bhpn,bhn->bhp", h, Cm[:, t]))
    return (torch.stack(ys, 1), h) if return_state else torch.stack(ys, 1)


def ssm_quadratic(x, Bm, Cm, dt, A, mm, rows: int = 512):
    """The same map as ssm_recurrent, as the masked quadratic form, a block
    of `rows` output positions at a time (each attends to the positions
    up to its own). The decay exponents are summed in float64 and taken
    relative to the block's first row before they turn float32."""
    B_, S, H, P = x.shape
    rep = H // Bm.shape[2]
    cum = torch.cumsum(dt.double() * A.double(), 1).transpose(1, 2)
    xt, dtt = x.transpose(1, 2), dt.transpose(1, 2)       # [B,H,S,P] [B,H,S]
    Bt, Ct = Bm.transpose(1, 2), Cm.transpose(1, 2)       # [B, G, S, N]
    ys = []
    for r0 in range(0, S, rows):
        r1 = min(r0 + rows, S)
        off = cum[..., r0:r0 + 1]
        a = (cum[..., r0:r1] - off).to(F32)
        b = (cum[..., :r1] - off).to(F32)
        causal = torch.arange(r0, r1, device=x.device)[:, None] >= \
            torch.arange(r1, device=x.device)[None, :]
        L = torch.exp((a[..., :, None] - b[..., None, :]).masked_fill(
            ~causal, float("-inf"))) * dtt[:, :, None, :r1]
        cb = mm(Ct[:, :, r0:r1], Bt[:, :, :r1].transpose(-1, -2))
        ys.append(mm(L * cb.repeat_interleave(rep, 1), xt[:, :, :r1]))
    return torch.cat(ys, 2).transpose(1, 2)               # [B, S, H, P]


def layer(x, p, i, m, pr, quadratic):
    eps = m.get("norm_eps", 1e-5)
    mm = pr.mm
    mp = p["mamba"]
    h = rms_norm(x, p["norm1"]["scale"][i], eps)
    z, xs, Bm, Cm, dt, A = _mixer_inputs(h, mp, i, m, mm)
    y = ssm_quadratic(xs, Bm, Cm, dt, A, mm) if quadratic else \
        ssm_recurrent(xs, Bm, Cm, dt, A)
    y = y + xs * mp["D"][i][:, None]
    B_, S = x.shape[:2]
    y = y.reshape(B_, S, -1) * F.silu(z)
    y = rms_norm(y, mp["norm_scale"][i], 1e-5)
    return pr.act(x + mm(y, mp["out_proj"][i]))


def forward(params, tokens, m, pr=FLOAT32, quadratic=False, remat=False):
    """tokens [B, S] -> float32 logits [B, S, Vpad]. pr: the arithmetic
    (lowp.py)."""
    emb = params["embed"]["embedding"]
    x = pr.act(emb[tokens])
    p = params["stack"]["blocks"][0]
    for i in range(m["num_layers"]):
        if remat:
            x = checkpoint(layer, x, p, i, m, pr, quadratic,
                           use_reentrant=False)
        else:
            x = layer(x, p, i, m, pr, quadratic)
    x = rms_norm(x, params["final_norm"]["scale"], m.get("norm_eps", 1e-5))
    return pr.mm(x, emb.t())


def loss(params, tokens, labels, m, pr=FLOAT32):
    logits = forward(params, tokens, m, pr, quadratic=True,
                     remat=True)[..., :m["vocab_size"]]
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1))
