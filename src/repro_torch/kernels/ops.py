"""Public entry points of the kernels, dispatched by the tensor's device.

A CUDA tensor goes to the Hopper kernel; a CPU tensor to the plain PyTorch
version in `ref.py`. Any other device raises. There is no switch and no
fallback: a CUDA tensor launches its kernel or raises.

The three probe kernels are also custom operators,
`torch.ops.repro_torch.{hash_fetch_add_batch, ringbuf_emit_batch,
tensor_stats_row}`: the CUDA implementation is the kernel's launch, the CPU
one its plain version, and a fake implementation gives the output shapes,
so `torch.export` can trace a step through them (`core/runtime.aot_step`)
and the exported program launches the same kernels, and the dry run
(`launch/op_cost.py`) can count a step on fake tensors. An eager call
skips the dispatcher, which costs a host-bound step more than the launch
(PERF.md); the operators are taken only while tracing
(`device.tracing`). Flash attention's operators are in
`flash_attention.py`.
"""
from __future__ import annotations

import torch

from . import (flash_attention as fa, hash_update, ref, ringbuf_emit,
               table_interp as ti, tensor_stats as ts)
from ..device import tracing
from .build import on_card

# kernel name -> (module, name of its launch counter)
KERNELS = {"tensor_stats": (ts, "LAUNCHES"),
           "hash_fetch_add_batch": (hash_update, "LAUNCHES"),
           "ringbuf_emit_batch": (ringbuf_emit, "LAUNCHES"),
           "table_interp": (ti, "LAUNCHES"),
           "flash_fwd": (fa, "FWD_LAUNCHES"),
           "flash_bwd": (fa, "BWD_LAUNCHES")}


def _kernel_input(x):
    """x as the tensor_stats kernel takes it: contiguous f32 or bf16."""
    if x.dtype not in (torch.float32, torch.bfloat16):
        x = x.to(torch.float32)
    return x.contiguous()


def tensor_stats(x) -> dict:
    if on_card(x, "tensor_stats"):
        return ts.tensor_stats_cuda(_kernel_input(x))
    return ref.tensor_stats(x)


def _tensor_stats_row(x, site_id: int, kind: int, layer: int):
    if on_card(x, "tensor_stats"):
        return ts.tensor_stats_row_cuda(_kernel_input(x), site_id, kind,
                                        layer)
    return ref.tensor_stats_row(x, site_id, kind, layer)


def _hash_fetch_add_batch(keys_tbl, used_tbl, vals_tbl, keys, deltas, valid):
    if on_card(keys_tbl, "hash_fetch_add_batch"):
        return hash_update.hash_fetch_add_batch_cuda(
            keys_tbl, used_tbl, vals_tbl, keys.contiguous(),
            deltas.contiguous(), valid.contiguous())
    return ref.hash_fetch_add_batch(keys_tbl, used_tbl, vals_tbl, keys,
                                    deltas, valid)


def _ringbuf_emit_batch(data, head, dropped, rows, valid):
    if on_card(data, "ringbuf_emit_batch"):
        return ringbuf_emit.ringbuf_emit_batch_cuda(
            data, head, dropped, rows.contiguous(), valid.contiguous())
    return ref.ringbuf_emit_batch(data, head, dropped, rows, valid)


# ---- the custom operators: the same functions behind the dispatcher
Tensor = torch.Tensor


@torch.library.custom_op("repro_torch::tensor_stats_row", mutates_args=(),
                         device_types=("cpu", "cuda"))
def _tensor_stats_row_op(x: Tensor, site_id: int, kind: int,
                         layer: int) -> Tensor:
    return _tensor_stats_row(x, site_id, kind, layer)


@_tensor_stats_row_op.register_fake
def _(x, site_id, kind, layer):
    return x.new_empty(ref.EVENT_WIDTH, dtype=torch.int64)


@torch.library.custom_op("repro_torch::hash_fetch_add_batch",
                         mutates_args=(), device_types=("cpu", "cuda"))
def _hash_fetch_add_batch_op(keys_tbl: Tensor, used_tbl: Tensor,
                             vals_tbl: Tensor, keys: Tensor, deltas: Tensor,
                             valid: Tensor) -> tuple[Tensor, Tensor, Tensor]:
    return tuple(_hash_fetch_add_batch(keys_tbl, used_tbl, vals_tbl, keys,
                                       deltas, valid))


@_hash_fetch_add_batch_op.register_fake
def _(keys_tbl, used_tbl, vals_tbl, keys, deltas, valid):
    return (torch.empty_like(keys_tbl), torch.empty_like(used_tbl),
            torch.empty_like(vals_tbl))


@torch.library.custom_op("repro_torch::ringbuf_emit_batch", mutates_args=(),
                         device_types=("cpu", "cuda"))
def _ringbuf_emit_batch_op(data: Tensor, head: Tensor, dropped: Tensor,
                           rows: Tensor, valid: Tensor
                           ) -> tuple[Tensor, Tensor, Tensor]:
    return tuple(_ringbuf_emit_batch(data, head, dropped, rows, valid))


@_ringbuf_emit_batch_op.register_fake
def _(data, head, dropped, rows, valid):
    return (torch.empty_like(data), torch.empty_like(head),
            torch.empty_like(dropped))


def tensor_stats_row(x, site_id: int, kind: int, layer: int):
    """The collector's i64[16] event row of `x`: one kernel launch for a
    CUDA tensor, `ref.tensor_stats_row` for a CPU tensor."""
    if tracing():
        return torch.ops.repro_torch.tensor_stats_row(x, site_id, kind,
                                                      layer)
    return _tensor_stats_row(x, site_id, kind, layer)


def hash_fetch_add_batch(keys_tbl, used_tbl, vals_tbl, keys, deltas, valid):
    if tracing():
        return torch.ops.repro_torch.hash_fetch_add_batch(
            keys_tbl, used_tbl, vals_tbl, keys, deltas, valid)
    return _hash_fetch_add_batch(keys_tbl, used_tbl, vals_tbl, keys, deltas,
                                 valid)


def ringbuf_emit_batch(data, head, dropped, rows, valid):
    """The RINGBUF apply: (data, head, dropped) after appending the valid
    rows, in one kernel launch for a CUDA ring."""
    if tracing():
        return torch.ops.repro_torch.ringbuf_emit_batch(data, head, dropped,
                                                        rows, valid)
    return _ringbuf_emit_batch(data, head, dropped, rows, valid)


def log2_histogram(x, n_bins: int = 64):
    """bcc-style log2 histogram of |x| in Q47.16, i64[n_bins]. Plain
    PyTorch on any device: the JAX package has no Pallas kernel for it
    either."""
    return ref.log2_histogram(x, n_bins)


def table_interp_run(spec_key, table, rows, maps, aux, *,
                     match_all: bool = False, want_r0: bool = False):
    """The live lane's interpreter over one tape i64[E, ctx_words]: one
    kernel launch for a CUDA tape, the plain `core.table_interp.run_plain`
    for a CPU tape. table: `LiveTable.device_state` (its "packed"
    buffer); maps: the states of the maps in `spec_key`, in any order.
    Returns new (maps, aux, r0 i64[P, E] or None); the inputs are not
    written."""
    if on_card(rows, "table_interp"):
        return ti.table_interp_cuda(spec_key, table, rows.contiguous(), maps,
                                    aux, match_all=match_all,
                                    want_r0=want_r0)
    from ..core.table_interp import run_plain
    return run_plain(spec_key, table, rows, maps, aux, match_all=match_all,
                     want_r0=want_r0)


def flash_attention(q, k, v, causal: bool = True, scale=None):
    """GQA attention, causal or not, at the softmax scale `scale` (None:
    1/sqrt(hd)), on q [B, S, H, hd], k and v [B, S, KH, hd]; returns o
    [B, S, H, hd] in q's type, differentiable. The inputs go to the kernel
    layout (q head b*H + h reads kv head b*KH + h // (H // KH),
    the grouping of `models.layers._grouped`) and through
    `FlashAttention`: the kernels for a CUDA tensor, the plain versions for
    a CPU tensor."""
    B, Sq, H, hd = q.shape
    KH, Skv = k.shape[2], k.shape[1]
    qf = q.permute(0, 2, 1, 3).reshape(B * H, Sq, hd).contiguous()
    kf = k.permute(0, 2, 1, 3).reshape(B * KH, Skv, hd).contiguous()
    vf = v.permute(0, 2, 1, 3).reshape(B * KH, Skv, hd).contiguous()
    o = fa.FlashAttention.apply(qf, kf, vf, causal, scale or 0.0)
    return o.reshape(B, H, Sq, hd).permute(0, 2, 1, 3)


def launch_counts() -> dict[str, int]:
    return {name: getattr(mod, attr) for name, (mod, attr) in KERNELS.items()}


def reset_launch_counts() -> None:
    for mod, attr in KERNELS.values():
        setattr(mod, attr, 0)
