"""Unsigned 64-bit semantics over int64 tensors.

eBPF registers are 64-bit words that some instructions read as unsigned
(DIV, MOD, LSH, RSH, JGT/JGE/JLT/JLE/JSET) and the hash map's home slot is
a u64 product. PyTorch's CPU build refuses uint64 for `//`, `%`, `>>` and
`>`, so every value stays int64 (the same 64 bits) and the unsigned reading
is written out here:

  * compare   -- flip the sign bit, then compare signed;
  * shift     -- logical right shift = arithmetic shift + mask of the high
                 bits; left shift and multiply wrap in int64 exactly as in
                 uint64;
  * divide    -- unsigned divmod from one signed division of (a >>> 1).

Shift amounts must already be masked to [0, 63] (the ISA does so).
"""
from __future__ import annotations

import torch

I64 = torch.int64
SIGN = -(1 << 63)                      # int64 view of 0x8000_0000_0000_0000
U64_FULL = (1 << 64) - 1
HASH_MULT = 0x9E3779B97F4A7C15         # splitmix64 golden-ratio constant


def s64(v: int) -> int:
    """Python int -> the signed value with the same low 64 bits."""
    v &= U64_FULL
    return v - (1 << 64) if v >> 63 else v


HASH_MULT_S = s64(HASH_MULT)


def _flip(x):
    return x ^ SIGN


def ult(a, b):
    return _flip(a) < _flip(b)


def ule(a, b):
    return _flip(a) <= _flip(b)


def ugt(a, b):
    return _flip(a) > _flip(b)


def uge(a, b):
    return _flip(a) >= _flip(b)


def lshr(x, s):
    """Logical right shift of int64 `x` by `s` in [0, 63] (int or tensor)."""
    if isinstance(s, int):
        return (x >> s) & s64((1 << (64 - s)) - 1)
    # mask = ~(-1 << (64 - s)), built as two shifts so no shift reaches 64
    ones = torch.full(torch.broadcast_shapes(x.shape, s.shape), -1,
                      dtype=I64, device=x.device)
    return (x >> s) & ~((ones << (63 - s)) << 1)


def shl(x, s):
    """Left shift by `s` in [0, 63]; bits shifted past bit 63 are lost."""
    return x << s


def udivmod(a, b):
    """(a // b, a % b) reading both as u64. `b` must be non-zero."""
    big = b < 0                                   # b >= 2**63 as unsigned
    bb = torch.where(big, torch.ones_like(b), b)
    q = torch.div(lshr(a, 1), bb, rounding_mode="floor") << 1
    r = a - q * bb
    fix = uge(r, bb)
    q = q + fix.to(I64)
    r = torch.where(fix, r - bb, r)
    q_big = uge(a, b).to(I64)
    r_big = torch.where(q_big.bool(), a - b, a)
    return torch.where(big, q_big, q), torch.where(big, r_big, r)


def hash_home(keys, n: int):
    """Home slot ((k * 0x9E3779B97F4A7C15) >> 33) mod n, u64 arithmetic."""
    h = keys * HASH_MULT_S                        # wraps like u64 multiply
    return lshr(h, 33) % n
