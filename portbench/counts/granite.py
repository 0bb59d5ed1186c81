"""Model FLOPs of a hybrid stack of Mamba-2 and attention layers, each
followed by a mixture of experts beside a shared expert (granite-4.0-h):
2 FLOPs a multiply-add; the active matrices count (a layer's mixer, its
router, the `experts_per_token` experts a token runs, the shared expert)
and the output head, the embedding lookup does not. The state space is
counted as counts/ssm.py counts it, at the Mamba-2 positions; attention's
two products as counts/dense.py counts them, at the positions each token
attends to, at the attention positions."""
from __future__ import annotations

from .. import pattern
from . import dense, ssm


def _layers(m: dict, kind: str) -> int:
    """Layers of mixer `kind` ("attn" or "mamba") in the stack."""
    return pattern.stacked(m) * sum(
        pattern.block_kind(m, j) == kind
        for j in range(pattern.superblock(m)))


def matmul_params(m: dict) -> int:
    """Parameters in the products a token runs through."""
    D, H, KH = m["d_model"], m["num_heads"], m["num_kv_heads"]
    hd = m["head_dim"]
    _, di, G, N, nh, _ = ssm._sizes(m)
    attn = D * H * hd + 2 * D * KH * hd + H * hd * D
    mamba = D * (2 * di + 2 * G * N + nh) + di * D
    ffn = (D * m["num_experts"]
           + 3 * D * m["moe_d_ff"] * m["experts_per_token"]
           + 3 * D * m["moe_shared_d_ff"])
    return (_layers(m, "attn") * attn + _layers(m, "mamba") * mamba
            + m["num_layers"] * ffn + D * m["vocab_size"])


def _mamba(m: dict) -> dict:
    return {**m, "num_layers": _layers(m, "mamba")}


def _attn(m: dict) -> dict:
    return {**m, "num_layers": _layers(m, "attn")}


def forward_flops(m: dict, positions, *, decode: bool = False,
                  prompt_len: int = 0) -> int:
    """Forward FLOPs of tokens at `positions` (0-based): decode steps (one
    token each, the recurrence) or one prefill of `prompt_len` tokens (the
    chunked form, chunk min(L, prompt))."""
    positions = list(positions)
    ssd = ssm.ssd_flops_step(_mamba(m)) if decode else \
        ssm.ssd_flops_chunked(_mamba(m), min(m.get("ssm_chunk", 256),
                                             max(prompt_len, 1)))
    return len(positions) * (2 * matmul_params(m) + ssd) + sum(
        dense.attention_flops(_attn(m), p + 1) for p in positions)


def serve_flops(m: dict, prefills, decode_positions) -> int:
    """Forward FLOPs of serving: prefills of the given prompt lengths, and
    decode steps, each a list of the positions its tokens decoded at."""
    return sum(forward_flops(m, range(n), prompt_len=n) for n in prefills) \
        + sum(forward_flops(m, pos, decode=True) for pos in decode_positions)


def train_flops_per_token(m: dict, seq: int) -> float:
    """Forward and backward (3x the forward) a token of a causal sequence
    of `seq`, averaged over its positions; recompute not counted."""
    chunk = min(m.get("ssm_chunk", 256), seq)
    return (6 * matmul_params(m)
            + 3 * ssm.ssd_flops_chunked(_mamba(m), chunk)
            + 3 * dense.attention_flops(_attn(m), 1) * (seq + 1) / 2)
