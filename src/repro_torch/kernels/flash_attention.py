"""GQA flash attention, causal or not, forward and backward -- the
attention of every layer on the training path and of the prefills above
2048 positions (causal), and of the encoder-decoder family's encoder above
2048 frames (non-causal).

Replaces the Pallas kernels of `src/repro/kernels/flash_attention.py`:
`_fwd_kernel` (:35, through `flash_fwd` :79) becomes `repro_flash_fwd`;
`_dkv_kernel` (:130) and `_dq_kernel` (:172), through `flash_bwd` (:212),
become `repro_flash_bwd`; the custom VJP `flash_attention_pallas` (:280)
becomes `FlashAttention`, a `torch.autograd.Function`. The CUDA sources are
`csrc/flash_attention.cu` (the C entry points and the f32 kernels) and
`csrc/flash_attention_sm90.cuh` (the bf16 kernels); the plain versions are
`ref.flash_fwd` and `ref.flash_bwd`.

Bound on an H100: operations (60 GFLOP forward and at least 150 GFLOP
backward per layer at B 2, S 4096, 14 heads, hd 64, on 19 MB; 0.061 and
0.152 ms at the bf16 tensor-core rate). The C entry points dispatch by
type (`route`):
- bf16, the training path's type: Hopper kernels -- 64-row bf16 tiles in
  swizzled shared memory filled by cp.async rings, every product a
  `wgmma` on the tensor cores with f32 accumulators, the softmax on the
  accumulator fragments in registers; a dkv grid balanced by pairing kv
  tile ki with nk - 1 - ki. P and dS enter the tensor cores as two bf16
  terms, hi = bf16(x) and lo = bf16(x - hi), about 16 significant bits;
  the Pallas kernels and the plain versions keep them in f32. One bf16
  term, as SDPA rounds P, would put o outside `TOL_BF16_O`
  (tests/test_torch_flash.py).
- f32: the first kernels of the port, f32 FMAs on the CUDA cores, which
  hold test_flash_kernel.py's f32 tolerances (TF32 would not).
Neither is a fallback for the other. No kernel uses atomics and the dkv
kernels sum the rep q heads of a kv head in f32 in a fixed order, so the
gradients are bit-identical from run to run; that sum is rounded once,
where the Pallas version rounds each q head's share to the input type
first.

Layout: q [B*H, Sq, hd], k and v [B*KH, Skv, hd], with q head bh reading
kv head bh // rep (rep = H // KH).
"""
from __future__ import annotations

import ctypes

import torch

from .. import telemetry
from ..device import tracing
from . import build, ref

FWD_LAUNCHES = 0              # one per forward launch
BWD_LAUNCHES = 0              # one per backward (delta + dkv + dq) launch
HEAD_DIMS = (16, 32, 64, 128)
# the kernels against their plain versions, as (rtol, atol): f32 within
# test_flash_kernel.py's tolerances (forward 2e-4, gradients 5e-4); bf16
# o one bf16 rounding apart, lse (f32 on both sides) within 1e-4 absolute,
# gradients with atol scaled by their largest magnitude (at least 1), and
# within TOL_BF16_NORM in relative 2-norm per output
TOL_F32 = (2e-4, 5e-4)
TOL_BF16_O = (2e-2, 2e-3)
TOL_LSE = (0.0, 1e-4)
TOL_BF16_GRAD = (2e-2, 2e-3)
TOL_BF16_NORM = 1e-2
# input type -> the kernels the C entry points launch for it
ROUTES = {torch.bfloat16: "sm90_wgmma", torch.float32: "fma_f32"}
_FNS: dict = {}


def route(dtype) -> str:
    """The kernel family the C entry points launch for inputs of `dtype`
    (their `bf16` flag is `route(dtype) == "sm90_wgmma"`); raises for a
    type no kernel takes."""
    if dtype not in ROUTES:
        raise TypeError(f"flash attention: expected f32 or bf16, got "
                        f"{dtype}")
    return ROUTES[dtype]


def _fn(symbol: str):
    if symbol not in _FNS:
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        args = {"repro_flash_fwd": [p] * 5 + [i] * 7 + [f, p],
                "repro_flash_bwd": [p] * 10 + [i] * 7 + [f, p]}[symbol]
        _FNS[symbol] = build.function("flash_attention", symbol, args)
    return _FNS[symbol]


def _check(q, k, v):
    """(BH, BKH, Sq, Skv, hd, bf16) of kernel-layout inputs; raises on
    anything the kernels do not take."""
    bf16 = int(route(q.dtype) == "sm90_wgmma")
    for name, t in (("q", q), ("k", k), ("v", v)):
        build.require(t, f"flash attention {name}", q.dtype, 3, q.device)
        if bf16:
            _require_aligned(t, name)
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
    return BH, BKH, Sq, Skv, hd, bf16


def _require_aligned(t, name: str) -> None:
    """The bf16 kernels copy 16-byte chunks: a tensor must start on a
    16-byte boundary (a view into the middle of a row may not)."""
    if t.data_ptr() % 16:
        raise ValueError(f"flash attention {name}: data must start on a "
                         "16-byte boundary")


def flash_fwd_cuda(q, k, v, causal: bool = True, scale: float = 0.0):
    """Launch the forward kernel; scale is the softmax's (0: 1/sqrt(hd)).
    Returns (o like q, lse f32 [BH, Sq])."""
    global FWD_LAUNCHES
    BH, BKH, Sq, Skv, hd, bf16 = _check(q, k, v)
    o = torch.empty_like(q)
    lse = torch.empty((BH, Sq), dtype=torch.float32, device=q.device)
    with torch.cuda.device(q.device):
        rc = _fn("repro_flash_fwd")(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            lse.data_ptr(), bf16, BH, BKH, Sq, Skv, hd, int(causal),
            float(scale), build.stream_ptr(q.device))
    build.check(rc, "flash_fwd")
    FWD_LAUNCHES += 1
    if telemetry.on():
        telemetry.count("flash.fwd", (BH, BKH, Sq, hd, bool(causal)))
    return o, lse


def flash_bwd_cuda(q, k, v, o, lse, do, causal: bool = True,
                   scale: float = 0.0):
    """Launch the backward kernels (delta, dkv, dq) for the forward at
    `scale`. Returns (dq, dk, dv) in the inputs' type."""
    global BWD_LAUNCHES
    BH, BKH, Sq, Skv, hd, bf16 = _check(q, k, v)
    build.require(o, "flash attention o", q.dtype, 3, q.device)
    build.require(do, "flash attention do", q.dtype, 3, q.device)
    if bf16:
        _require_aligned(o, "o")
        _require_aligned(do, "do")
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
            int(causal), float(scale), build.stream_ptr(q.device))
    build.check(rc, "flash_bwd")
    BWD_LAUNCHES += 1
    if telemetry.on():
        telemetry.count("flash.bwd", (BH, BKH, Sq, hd, bool(causal)))
    return dq, dk, dv


# The launchers are called with a scale only where it is not the default:
# the benchmark's training cell wraps `flash_fwd_cuda(q, k, v, causal)` and
# `flash_bwd_cuda(q, k, v, o, lse, do, causal)` to count their launches.
def _flash_fwd(q, k, v, causal: bool, scale: float = 0.0):
    if build.on_card(q, "flash attention"):
        return flash_fwd_cuda(q, k, v, causal, *((scale,) if scale else ()))
    return ref.flash_fwd(q, k, v, causal, q.shape[0] // k.shape[0], scale)


def _flash_bwd(q, k, v, o, lse, do, causal: bool, scale: float = 0.0):
    if build.on_card(q, "flash attention"):
        return flash_bwd_cuda(q, k, v, o, lse, do, causal,
                              *((scale,) if scale else ()))
    return ref.flash_bwd(q, k, v, o, lse, do, causal,
                         q.shape[0] // k.shape[0], scale)


# ---- the custom operators: the same functions behind the dispatcher, with
# fake implementations, taken only while a step is traced (device.tracing)
Tensor = torch.Tensor


@torch.library.custom_op("repro_torch::flash_fwd", mutates_args=(),
                         device_types=("cpu", "cuda"))
def _flash_fwd_op(q: Tensor, k: Tensor, v: Tensor, causal: bool,
                  scale: float = 0.0) -> tuple[Tensor, Tensor]:
    return tuple(_flash_fwd(q, k, v, causal, scale))


@_flash_fwd_op.register_fake
def _(q, k, v, causal, scale=0.0):
    return torch.empty_like(q), q.new_empty(q.shape[:2], dtype=torch.float32)


@torch.library.custom_op("repro_torch::flash_bwd", mutates_args=(),
                         device_types=("cpu", "cuda"))
def _flash_bwd_op(q: Tensor, k: Tensor, v: Tensor, o: Tensor, lse: Tensor,
                  do: Tensor, causal: bool,
                  scale: float = 0.0) -> tuple[Tensor, Tensor, Tensor]:
    return tuple(_flash_bwd(q, k, v, o, lse, do, causal, scale))


@_flash_bwd_op.register_fake
def _(q, k, v, o, lse, do, causal, scale=0.0):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


class FlashAttention(torch.autograd.Function):
    """o = attention(q, k, v) in the kernel layout, differentiable, at the
    softmax scale `scale` (0: 1/sqrt(hd)). Saves q, k, v, o and lse; the
    backward returns dq, dk, dv in the inputs' types, as `_fa_fwd`/`_fa_bwd`
    do. A CUDA tensor launches the kernels, a CPU tensor runs the plain
    versions; while tracing, both go through
    `torch.ops.repro_torch.flash_fwd`/`flash_bwd`."""

    @staticmethod
    def forward(ctx, q, k, v, causal: bool = True, scale: float = 0.0):
        if tracing():
            o, lse = torch.ops.repro_torch.flash_fwd(q, k, v, causal, scale)
        else:
            o, lse = _flash_fwd(q, k, v, causal, scale)
        ctx.causal, ctx.scale = causal, scale
        ctx.save_for_backward(q, k, v, o, lse)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        do = do.to(q.dtype).contiguous()
        if tracing():
            dq, dk, dv = torch.ops.repro_torch.flash_bwd(q, k, v, o, lse, do,
                                                         ctx.causal, ctx.scale)
        else:
            dq, dk, dv = _flash_bwd(q, k, v, o, lse, do, ctx.causal,
                                    ctx.scale)
        return dq, dk, dv, None, None
