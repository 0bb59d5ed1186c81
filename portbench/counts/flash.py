"""Operations and bytes of the flash attention kernels, and the least
time the chip could take for them.

Forward: q k^T and p v over the attended pairs, 2 FLOPs a multiply-add:
4 hd pairs per head. Backward: the least work is five products (q k^T
recomputed, do v^T, p^T do, ds^T q, ds k), 2.5 times the forward.
Bytes: q, k, v (and for the backward o, do, the log-sum-exp) read once,
o (dq, dk, dv) written once, in bfloat16."""
from __future__ import annotations


def pairs(S: int, causal: bool) -> int:
    return S * (S + 1) // 2 if causal else S * S


def fwd_flops(BH: int, S: int, hd: int, causal: bool) -> float:
    return 4.0 * hd * pairs(S, causal) * BH


def bwd_flops(BH: int, S: int, hd: int, causal: bool) -> float:
    return 2.5 * fwd_flops(BH, S, hd, causal)


def fwd_bytes(BH: int, BKH: int, S: int, hd: int) -> float:
    return 2.0 * (2 * BH + 2 * BKH) * S * hd + 4.0 * BH * S


def bwd_bytes(BH: int, BKH: int, S: int, hd: int) -> float:
    reads = 2.0 * (3 * BH + 2 * BKH) * S * hd + 4.0 * BH * S
    writes = 2.0 * (BH + 2 * BKH) * S * hd
    return reads + writes


def bound_s(flops: float, nbytes: float, peak_flops: float,
            peak_bytes: float) -> float:
    return max(flops / peak_flops, nbytes / peak_bytes)
