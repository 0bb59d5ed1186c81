"""Granite 4.0-H (`granitemoehybrid`, the config.json of
ibm-granite/granite-4.0-h-small) as the published description has it, in
plain float32: the token embedding times `embedding_multiplier`; per
layer an RMSNorm, the layer's mixer, and a residual add of the mixer's
output times `residual_multiplier`; an RMSNorm, the mixture of experts
beside the shared expert, and a residual add of their sum times
`residual_multiplier`; a final RMSNorm and the tied embedding as the
output head, the logits divided by `logits_scaling`.

- The mixer is Mamba-2 (mamba2.py's, with the convolution's bias and no
  projection bias) or, at the positions `layer_types` names "attention",
  grouped-query attention with no positions (NoPE) and no bias, its
  softmax scaled by `attention_multiplier` in place of 1/sqrt(head_dim).
- The experts: the router's logits (no bias), their top
  `num_experts_per_tok`, a softmax over those; each chosen expert is a
  SwiGLU of width `intermediate_size`, silu(h W_gate) * (h W_in) W_out,
  weighted by its gate. Computed expert by expert: the tokens routed to
  expert e are gathered, run through it and added back. Nothing drops.
- The shared expert: a SwiGLU of width `shared_intermediate_size`, on
  every token.

Departures from the published model: the stack holds the configuration's
`num_layers` (one period of ten, the first stage of a four-stage pipeline
of the 40 layers), and the final norm and the tied head follow it so that
logits can be compared; the weights are the benchmark's random draws, each
output projection drawn 4 / residual_multiplier wider (`block_leaves`).

`forward` runs each Mamba-2 state space as its recurrence, one position
after another; `loss` (gradients) uses its masked quadratic form and
recomputes each layer in the backward pass (mamba2.py).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from . import mamba2 as M
from .lowp import FLOAT32
from .qwen2 import rms_norm

# sequences the serving check runs through `forward` at once: one, since a
# sequence's float32 logits over the 100,352-row head are large
CHECK_BATCH = 1


def _attn_at(m: dict, j: int) -> bool:
    return j % m["attn_every"] == m["attn_offset"]


# the leaves that write a sublayer's output onto the residual stream
OUTPUTS = ("wo", "out_proj", "w_out")


def block_leaves(m: dict, j: int) -> list:
    """(path in the stacked layer, shape, kind, scale) of position j's
    leaves after its first norm, in the order the weights are drawn: the
    mixer's (attention's four projections, or mamba2.py's), the second
    norm, the router and the experts, the shared expert.

    Each output projection is drawn 4 / residual_multiplier wider than
    1 / sqrt(fan-in), so that the token's own embedding (x 12) lifts its
    own logit through the tied head by under a standard deviation of the
    others. Drawn at 1 / sqrt(fan-in), the ten layers' updates (x 0.22)
    are no larger than that embedding, and the reference puts the input
    token first at every position, 14 standard deviations ahead of the
    next: no check of served tokens could then tell a fault (at
    1 / residual_multiplier it still comes first at 45 % of positions)."""
    D, n = m["d_model"], m["num_layers"] // m["superblock"]
    E, Fe, Fs = m["num_experts"], m["moe_d_ff"], m["moe_shared_d_ff"]
    s = 1 / math.sqrt(D)
    if _attn_at(m, j):
        H, KH, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
        out = [(("attn", "wq"), (n, D, H * hd), "normal", s),
               (("attn", "wk"), (n, D, KH * hd), "normal", s),
               (("attn", "wv"), (n, D, KH * hd), "normal", s),
               (("attn", "wo"), (n, H * hd, D), "normal", s)]
    else:
        out = M.block_leaves(m, j)
    out += [
        (("norm2", "scale"), (n, D), "one_plus", 0.05),
        (("moe", "router"), (n, D, E), "normal", s),
        (("moe", "w_in"), (n, E, D, Fe), "normal", s),
        (("moe", "w_gate"), (n, E, D, Fe), "normal", s),
        (("moe", "w_out"), (n, E, Fe, D), "normal", 1 / math.sqrt(Fe)),
        (("mlp_shared", "wi"), (n, D, Fs), "normal", s),
        (("mlp_shared", "wg"), (n, D, Fs), "normal", s),
        (("mlp_shared", "wo"), (n, Fs, D), "normal", 1 / math.sqrt(Fs))]
    up = 4 / m["residual_multiplier"]
    return [(path, shape, kind, scale * up if path[-1] in OUTPUTS else scale)
            for path, shape, kind, scale in out]


def _swiglu(h, wi, wg, wo, mm):
    return mm(F.silu(mm(h, wg)) * mm(h, wi), wo)


def _attention(h, p, i, m, pr):
    B, S, _ = h.shape
    H, KH, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    a, mm = p["attn"], pr.mm
    q = mm(h, a["wq"][i]).reshape(B, S, H, hd).transpose(1, 2)
    k, v = (mm(h, a[w][i]).reshape(B, S, KH, hd).transpose(1, 2)
            .repeat_interleave(H // KH, 1) for w in ("wk", "wv"))
    s = mm(q, k.transpose(-1, -2)) * m["attention_multiplier"]
    causal = torch.ones(S, S, dtype=torch.bool, device=h.device).tril()
    o = mm(torch.softmax(s.masked_fill(~causal, float("-inf")), -1), v)
    return mm(o.transpose(1, 2).reshape(B, S, H * hd), a["wo"][i])


def _mamba(h, p, i, m, pr, quadratic):
    mp = p["mamba"]
    z, xs, Bm, Cm, dt, A = M._mixer_inputs(h, mp, i, m, pr.mm)
    y = M.ssm_quadratic(xs, Bm, Cm, dt, A, pr.mm) if quadratic else \
        M.ssm_recurrent(xs, Bm, Cm, dt, A)
    y = y + xs * mp["D"][i][:, None]
    y = y.reshape(h.shape[0], h.shape[1], -1) * F.silu(z)
    y = rms_norm(y, mp["norm_scale"][i], m.get("norm_eps", 1e-5))
    return pr.mm(y, mp["out_proj"][i])


def _experts(h, p, i, m, pr):
    """The routed experts' sum for each token, one expert at a time."""
    e, k = p["moe"], m["experts_per_token"]
    ht = h.reshape(-1, h.shape[-1])
    top, ids = torch.topk(pr.mm(ht, e["router"][i]), k, dim=-1)
    gates = torch.softmax(top, -1)
    out = torch.zeros_like(ht)
    for n in range(e["router"].shape[-1]):
        tok, slot = (ids == n).nonzero(as_tuple=True)
        if tok.numel():
            y = _swiglu(ht[tok], e["w_in"][i, n], e["w_gate"][i, n],
                        e["w_out"][i, n], pr.mm)
            out.index_add_(0, tok, gates[tok, slot, None] * y)
    return out.reshape(h.shape)


def layer(x, p, i, j, m, pr, quadratic=False):
    """Layer j of superblock i (`p`: params["stack"]["blocks"][j])."""
    eps, rm = m.get("norm_eps", 1e-5), m["residual_multiplier"]
    h = rms_norm(x, p["norm1"]["scale"][i], eps)
    mix = _attention(h, p, i, m, pr) if _attn_at(m, j) else \
        _mamba(h, p, i, m, pr, quadratic)
    x = pr.act(x + rm * mix)
    h = rms_norm(x, p["norm2"]["scale"][i], eps)
    s = p["mlp_shared"]
    f = _experts(h, p, i, m, pr) + _swiglu(h, s["wi"][i], s["wg"][i],
                                           s["wo"][i], pr.mm)
    return pr.act(x + rm * f)


def forward(params, tokens, m, pr=FLOAT32, quadratic=False, remat=False):
    """tokens [B, S] -> float32 logits [B, S, Vpad]. pr: the arithmetic
    (lowp.py)."""
    emb = params["embed"]["embedding"]
    x = pr.act(emb[tokens] * m["embedding_multiplier"])
    sb = m["superblock"]
    for i in range(m["num_layers"] // sb):
        for j in range(sb):
            p = params["stack"]["blocks"][j]
            if remat:
                x = checkpoint(layer, x, p, i, j, m, pr, quadratic,
                               use_reentrant=False)
            else:
                x = layer(x, p, i, j, m, pr, quadratic)
    x = rms_norm(x, params["final_norm"]["scale"], m.get("norm_eps", 1e-5))
    return pr.mm(x, emb.t()) / m["logits_scaling"]


def loss(params, tokens, labels, m, pr=FLOAT32):
    """Mean next-token cross-entropy over the real vocabulary."""
    logits = forward(params, tokens, m, pr, quadratic=True,
                     remat=True)[..., :m["vocab_size"]]
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1))
