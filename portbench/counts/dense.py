"""Model FLOPs of a dense decoder with grouped-query attention and a
SwiGLU MLP (qwen2): 2 FLOPs a multiply-add; the output head counts, the
embedding lookup does not; attention's two products (q k^T and p v) at
the positions each token attends to."""
from __future__ import annotations


def _hd(m):
    return m.get("head_dim") or m["d_model"] // m["num_heads"]


def matmul_params(m: dict) -> int:
    D, H, KH, F = m["d_model"], m["num_heads"], m["num_kv_heads"], m["d_ff"]
    hd = _hd(m)
    layer = D * H * hd + 2 * D * KH * hd + H * hd * D + 3 * D * F
    return m["num_layers"] * layer + D * m["vocab_size"]


def attention_flops(m: dict, context: int) -> int:
    """Forward FLOPs of attention for one token that attends to `context`
    positions, over all layers."""
    return 4 * m["num_heads"] * _hd(m) * context * m["num_layers"]


def forward_flops(m: dict, positions) -> int:
    """Forward FLOPs of tokens at `positions` (0-based) of their
    sequences: each attends to position + 1 positions."""
    positions = list(positions)
    return 2 * matmul_params(m) * len(positions) + sum(
        attention_flops(m, p + 1) for p in positions)


def serve_flops(m: dict, prefills, decode_positions) -> int:
    """Forward FLOPs of serving: prefills of the given prompt lengths, and
    decode steps, each a list of the positions its tokens decoded at."""
    return sum(forward_flops(m, range(n)) for n in prefills) + sum(
        forward_flops(m, pos) for pos in decode_positions)


def train_flops_per_token(m: dict, seq: int) -> float:
    """Forward and backward (3x the forward) a token of a causal sequence
    of `seq`, averaged over its positions; recompute not counted."""
    return 6 * matmul_params(m) + 3 * attention_flops(m, 1) * (seq + 1) / 2
