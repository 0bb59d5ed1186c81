"""Causal GQA flash attention, forward and backward -- the attention of
every layer on the training path (sequences longer than 2048).

Replaces the Pallas kernels of `src/repro/kernels/flash_attention.py`:
`_fwd_kernel` (:35, through `flash_fwd` :79) becomes `repro_flash_fwd`;
`_dkv_kernel` (:130) and `_dq_kernel` (:172), through `flash_bwd` (:212),
become `repro_flash_bwd`; the custom VJP `flash_attention_pallas` (:280)
becomes `FlashAttention`, a `torch.autograd.Function`. The CUDA source is
`csrc/flash_attention.cu`; the plain versions are `ref.flash_fwd` and
`ref.flash_bwd`.

Bound on an H100: operations (60 GFLOP forward and at least 150 GFLOP
backward per layer at B 2, S 4096, 14 heads, hd 64, on 19 MB). Design: a
first, simple version -- 64-row tiles in shared memory as f32, f32 FMAs on
the CUDA cores, online softmax in registers; the dkv kernel sums the rep
q heads of a kv head in registers and no kernel uses atomics, so the
gradients are bit-identical from run to run. bf16 inputs are products in
f32, as in the Pallas kernels; the rep-group sum of dk and dv is taken in
f32 and rounded once, where the Pallas version rounds each q head's share
to the input type first.

Layout: q [B*H, Sq, hd], k and v [B*KH, Skv, hd], with q head bh reading
kv head bh // rep (rep = H // KH).
"""
from __future__ import annotations

import ctypes

import torch

from . import build, ref

FWD_LAUNCHES = 0              # one per forward launch
BWD_LAUNCHES = 0              # one per backward (delta + dkv + dq) launch
HEAD_DIMS = (16, 32, 64, 128)
_FNS: dict = {}


def _fn(symbol: str):
    if symbol not in _FNS:
        p, i = ctypes.c_void_p, ctypes.c_int
        args = {"repro_flash_fwd": [p] * 5 + [i] * 7 + [p],
                "repro_flash_bwd": [p] * 10 + [i] * 7 + [p]}[symbol]
        _FNS[symbol] = build.function("flash_attention", symbol, args)
    return _FNS[symbol]


def _check(q, k, v):
    """(BH, BKH, Sq, Skv, hd, bf16) of kernel-layout inputs; raises on
    anything the kernels do not take."""
    if q.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"flash attention: expected f32 or bf16, got "
                        f"{q.dtype}")
    for name, t in (("q", q), ("k", k), ("v", v)):
        build.require(t, f"flash attention {name}", q.dtype, 3, q.device)
    BH, Sq, hd = q.shape
    BKH, Skv, hdk = k.shape
    if tuple(v.shape) != (BKH, Skv, hdk) or hdk != hd:
        raise ValueError(f"flash attention: q {tuple(q.shape)}, k "
                         f"{tuple(k.shape)}, v {tuple(v.shape)} disagree")
    if hd not in HEAD_DIMS:
        raise ValueError(f"flash attention: head dim {hd} not in "
                         f"{HEAD_DIMS}")
    if BKH == 0 or BH % BKH:
        raise ValueError(f"flash attention: {BH} q heads do not group over "
                         f"{BKH} kv heads")
    return BH, BKH, Sq, Skv, hd, int(q.dtype == torch.bfloat16)


def flash_fwd_cuda(q, k, v, causal: bool = True):
    """Launch the forward kernel. Returns (o like q, lse f32 [BH, Sq])."""
    global FWD_LAUNCHES
    BH, BKH, Sq, Skv, hd, bf16 = _check(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((BH, Sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = _fn("repro_flash_fwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), bf16, BH, BKH, Sq, Skv, hd, int(causal),
            build.stream_ptr(q.device))
    build.check(rc, "flash_fwd")
    FWD_LAUNCHES += 1
    return o, lse


def flash_bwd_cuda(q, k, v, o, lse, do, causal: bool = True):
    """Launch the backward kernels (delta, dkv, dq). Returns (dq, dk, dv)
    in the inputs' type."""
    global BWD_LAUNCHES
    BH, BKH, Sq, Skv, hd, bf16 = _check(q, k, v)
    build.require(o, "flash attention o", q.dtype, 3, q.device)
    build.require(do, "flash attention do", q.dtype, 3, q.device)
    build.require(lse, "flash attention lse", torch.float32, 2, q.device)
    if o.shape != q.shape or do.shape != q.shape or \
            tuple(lse.shape) != (BH, Sq):
        raise ValueError("flash attention: o, do or lse do not match q")
    delta = torch.empty((BH, Sq), dtype=torch.float32, device=q.device)
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), \
        torch.empty_like(v)
    with torch.cuda.device(q.device):
        rc = _fn("repro_flash_bwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), do.data_ptr(), delta.data_ptr(), dq.data_ptr(),
            dk.data_ptr(), dv.data_ptr(), bf16, BH, BKH, Sq, Skv, hd,
            int(causal), build.stream_ptr(q.device))
    build.check(rc, "flash_bwd")
    BWD_LAUNCHES += 1
    return dq, dk, dv


class FlashAttention(torch.autograd.Function):
    """o = attention(q, k, v) in the kernel layout, differentiable. Saves
    q, k, v, o and lse; the backward returns dq, dk, dv in the inputs'
    types, as `_fa_fwd`/`_fa_bwd` do. A CUDA tensor launches the kernels,
    a CPU tensor runs the plain versions."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool = True):
        if build.on_card(q, "flash attention"):
            o, lse = flash_fwd_cuda(q, k, v, causal)
        else:
            o, lse = ref.flash_fwd(q, k, v, causal, q.shape[0] // k.shape[0])
        ctx.causal = causal
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        if build.on_card(q, "flash attention"):
            dq, dk, dv = flash_bwd_cuda(q, k, v, o, lse, do, ctx.causal)
        else:
            dq, dk, dv = ref.flash_bwd(q, k, v, o, lse, do, ctx.causal,
                                       q.shape[0] // k.shape[0])
        return dq, dk, dv, None
