"""Qwen2 (arXiv:2407.10671) as the published description has it, in plain
float32: token embedding; per layer RMSNorm, grouped-query attention with
biased q/k/v projections and rotary positions (rotate-half form), a
residual add, RMSNorm, a SwiGLU MLP and a residual add; a final RMSNorm
and the tied embedding as the output head. Attention is the plain
softmax over the whole causal score matrix."""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from .lowp import FLOAT32

F32 = torch.float32
# sequences the serving check runs through `forward` at once: one, since a
# sequence's float32 logits over the 151,936-row head are large
CHECK_BATCH = 1


def block_leaves(m: dict, j: int) -> list:
    """(path in the stacked layer, shape, kind, scale) of a layer's leaves
    after its first norm, in the order the weights are drawn: the
    attention projections (and their biases), the second norm, the MLP.
    Every layer is alike: the superblock position j is not read."""
    D, L = m["d_model"], m["num_layers"] // m.get("superblock", 1)
    H, KH = m["num_heads"], m["num_kv_heads"]
    hd = m.get("head_dim") or D // H
    F_ = m["d_ff"]
    s = 1 / math.sqrt(D)
    out = [(("attn", "wq"), (L, D, H * hd), "normal", s),
           (("attn", "wk"), (L, D, KH * hd), "normal", s),
           (("attn", "wv"), (L, D, KH * hd), "normal", s),
           (("attn", "wo"), (L, H * hd, D), "normal", s)]
    if m.get("qkv_bias"):
        out += [(("attn", "bq"), (L, H * hd), "normal", 0.02),
                (("attn", "bk"), (L, KH * hd), "normal", 0.02),
                (("attn", "bv"), (L, KH * hd), "normal", 0.02)]
    return out + [(("norm2", "scale"), (L, D), "one_plus", 0.05),
                  (("mlp", "wi"), (L, D, F_), "normal", s),
                  (("mlp", "wg"), (L, D, F_), "normal", s),
                  (("mlp", "wo"), (L, F_, D), "normal", 1 / math.sqrt(F_))]


def rms_norm(x, scale, eps):
    x = x.to(F32)
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * scale


def rope(x, pos, theta):
    """x [B, S, H, hd]; pos [S]: x rotated by pos * theta^(-2i/hd)."""
    hd = x.shape[-1]
    inv = 1.0 / (theta ** (torch.arange(0, hd, 2, dtype=F32,
                                        device=x.device) / hd))
    ang = pos.to(F32)[:, None] * inv[None, :]              # [S, hd/2]
    cos = torch.cat([ang.cos(), ang.cos()], -1)[None, :, None, :]
    sin = torch.cat([ang.sin(), ang.sin()], -1)[None, :, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return x * cos + torch.cat([-x2, x1], -1) * sin


def layer(x, p, i, m, pr):
    """Layer i of the stacked tree `p` (params["stack"]["blocks"][0])."""
    B, S, D = x.shape
    H, KH = m["num_heads"], m["num_kv_heads"]
    hd = m.get("head_dim") or D // H
    eps = m.get("norm_eps", 1e-6)
    mm = pr.mm
    a = p["attn"]
    h = rms_norm(x, p["norm1"]["scale"][i], eps)
    q = mm(h, a["wq"][i]) + a["bq"][i]
    k = mm(h, a["wk"][i]) + a["bk"][i]
    v = mm(h, a["wv"][i]) + a["bv"][i]
    pos = torch.arange(S, device=x.device)
    q = rope(q.reshape(B, S, H, hd), pos, m["rope_theta"])
    k = rope(k.reshape(B, S, KH, hd), pos, m["rope_theta"])
    v = v.reshape(B, S, KH, hd)
    k = k.repeat_interleave(H // KH, dim=2)
    v = v.repeat_interleave(H // KH, dim=2)
    s = mm(q.transpose(1, 2), k.permute(0, 2, 3, 1)) / math.sqrt(hd)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    s = s.masked_fill(~causal, float("-inf"))
    o = mm(torch.softmax(s, -1), v.transpose(1, 2))        # [B, H, S, hd]
    x = pr.act(x + mm(o.transpose(1, 2).reshape(B, S, H * hd), a["wo"][i]))
    h = rms_norm(x, p["norm2"]["scale"][i], eps)
    f = F.silu(mm(h, p["mlp"]["wg"][i])) * mm(h, p["mlp"]["wi"][i])
    return pr.act(x + mm(f, p["mlp"]["wo"][i]))


def forward(params, tokens, m, pr=FLOAT32, remat=False):
    """tokens [B, S] -> float32 logits [B, S, Vpad] (Vpad: the embedding's
    rows). pr: the arithmetic (lowp.py)."""
    emb = params["embed"]["embedding"]
    x = pr.act(emb[tokens])
    p = params["stack"]["blocks"][0]
    for i in range(m["num_layers"]):
        if remat:
            x = checkpoint(layer, x, p, i, m, pr, use_reentrant=False)
        else:
            x = layer(x, p, i, m, pr)
    x = rms_norm(x, params["final_norm"]["scale"], m.get("norm_eps", 1e-6))
    return pr.mm(x, emb.t())


def loss(params, tokens, labels, m, pr=FLOAT32):
    """Mean next-token cross-entropy over the real vocabulary."""
    logits = forward(params, tokens, m, pr, remat=True)[..., :m["vocab_size"]]
    return F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                           labels.reshape(-1))
