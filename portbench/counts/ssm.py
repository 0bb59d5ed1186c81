"""Model FLOPs of a Mamba-2 stack: 2 FLOPs a multiply-add; the input and
output projections and the output head count, the embedding lookup, the
convolution and the elementwise work do not. The state space at chunk L
(the dual form the port trains and prefills with) costs a token, per
layer: C B^T over half a chunk (2 G N L / 2), its product with x
(2 H P L / 2), the chunk state (2 H P N) and the state's read-out
(2 H P N). A decode step's recurrence: the update and the read-out,
2 H P N each."""
from __future__ import annotations


def _sizes(m):
    D = m["d_model"]
    di = m.get("ssm_expand", 2) * D
    P = m.get("ssm_headdim", 64)
    return D, di, m.get("ssm_ngroups", 1), m["ssm_state"], di // P, P


def matmul_params(m: dict) -> int:
    D, di, G, N, H, _ = _sizes(m)
    layer = D * (2 * di + 2 * G * N + H) + di * D
    return m["num_layers"] * layer + D * m["vocab_size"]


def ssd_flops_chunked(m: dict, chunk: int) -> int:
    """Forward FLOPs of the state space a token, all layers, at `chunk`."""
    _, _, G, N, H, P = _sizes(m)
    return m["num_layers"] * (G * N * chunk + H * P * chunk + 4 * H * P * N)


def ssd_flops_step(m: dict) -> int:
    _, _, _, N, H, P = _sizes(m)
    return m["num_layers"] * 4 * H * P * N


def forward_flops(m: dict, positions, *, decode: bool = False,
                  prompt_len: int = 0) -> int:
    """Forward FLOPs of tokens at `positions`: decode steps (one token
    each) or one prefill of `prompt_len` tokens (chunk min(L, prompt))."""
    n = len(list(positions))
    ssd = ssd_flops_step(m) if decode else ssd_flops_chunked(
        m, min(m.get("ssm_chunk", 256), max(prompt_len, 1)))
    return n * (2 * matmul_params(m) + ssd)


def serve_flops(m: dict, prefills, decode_positions) -> int:
    """Forward FLOPs of serving: prefills of the given prompt lengths (the
    chunked form), and decode steps (the recurrence), each a list of the
    positions its tokens decoded at."""
    return sum(forward_flops(m, range(n), prompt_len=n) for n in prefills) \
        + sum(forward_flops(m, pos, decode=True) for pos in decode_positions)


def train_flops_per_token(m: dict, seq: int) -> float:
    chunk = min(m.get("ssm_chunk", 256), seq)
    return 6 * matmul_params(m) + 3 * ssd_flops_chunked(m, chunk)
