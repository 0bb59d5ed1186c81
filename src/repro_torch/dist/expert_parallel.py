"""Explicit expert parallelism over the mesh's 'model' axis.

The baseline MoE (`models.moe.apply_moe`) runs every expert's FFN on every
rank. Here each rank of the 'model' group runs only its num_experts / m
experts: it routes its tokens with the same `moe.route` (tokens are
replicated across 'model'), takes its experts' slice of the dispatch
[E, C, D] and of `w_in`/`w_gate`/`w_out` (a DTensor's local shard, or a
slice of a full tensor), runs `moe.experts` on it, and one
`all_gather_into_tensor` over the 'model' group puts the expert outputs
back together along E before `moe.combine`. In the backward the output
gather hands each rank its slice of the gradient, and the slices of the
replicated dispatch and full weights are gathered back, so every rank
holds the whole gradient of x and of the weights, as `apply_moe` gives.

This is the counterpart of the JAX package's `shard_map`
(`src/repro/dist/expert_parallel.py`). With tokens replicated across
'model', as in every forward of the port, one gather is exactly what that
`shard_map` computes; the all_to_all pair its docstring names appears
only when tokens are data-sharded, which no single-process forward of the
port does.

Opt-in via REPRO_MOE_EP=1 (`models.transformer._moe_dispatch`); without an
active mesh whose 'model' axis divides num_experts it is `apply_moe`.
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig
from ..models import moe as MOE
from . import sharding as SH

GATHERS = 0          # expert-output gathers (forward), one per MoE layer


def _gather(local, group, m: int):
    """[n, ...] on each of the group's m ranks -> [m * n, ...], rank-major:
    one all_gather_into_tensor (all_gather_single in later torch)."""
    import torch.distributed as dist
    local = local.contiguous()
    out = local.new_empty((m * local.shape[0],) + tuple(local.shape[1:]))
    gather = getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor
    gather(out, local, group=group)
    return out


class _GatherExperts(torch.autograd.Function):
    """[E/m, C, D] on each rank -> [E, C, D]. Every rank computes the same
    loss from the gathered outputs, so the gradient of this rank's slice is
    its slice of the incoming gradient; a gather whose backward sums over
    the ranks (`torch.distributed.nn`'s) would scale it by m."""

    @staticmethod
    def forward(ctx, local, group, rank: int, m: int):
        global GATHERS
        out = _gather(local, group, m)
        GATHERS += 1
        ctx.rows = (rank * local.shape[0], (rank + 1) * local.shape[0])
        return out

    @staticmethod
    def backward(ctx, grad):
        lo, hi = ctx.rows
        return grad[lo:hi], None, None, None


class _SliceExperts(torch.autograd.Function):
    """This rank's n experts of a tensor replicated across 'model' (the
    dispatch, or a full expert weight). Its gradient is nonzero only in
    each rank's own slice, so the backward gathers the slices: every rank
    then holds the whole gradient, as for a replicated tensor."""

    @staticmethod
    def forward(ctx, full, group, rank: int, n: int):
        ctx.group, ctx.m = group, full.shape[0] // n
        return full[rank * n:(rank + 1) * n]

    @staticmethod
    def backward(ctx, grad):
        return _gather(grad, ctx.group, ctx.m), None, None, None


def _local_experts(w, mesh, group, rank: int, n: int):
    """This rank's n experts of an expert-stacked weight [E, ...]: the
    local shard of a DTensor (after a redistribute to experts over
    'model', replicated elsewhere, when it is laid out otherwise), or a
    slice of a full tensor."""
    from torch.distributed.tensor import DTensor
    if isinstance(w, DTensor):
        want = SH.placements(SH.P("model"), mesh)
        if tuple(w.placements) != want:
            w = w.redistribute(w.device_mesh, want)
        return w.to_local()
    return _SliceExperts.apply(w, group, rank, n)


def apply_moe_ep(p, x, cfg: ModelConfig):
    """x: [B, S, D] -> [B, S, D]; the same function as `apply_moe`."""
    mesh = SH.active_mesh()
    if (mesh is None or "model" not in mesh.axis_names
            or cfg.num_experts % int(mesh.shape["model"])):
        return MOE.apply_moe(p, x, cfg)
    B, S, D = x.shape
    m = int(mesh.shape["model"])
    n = cfg.num_experts // m
    rank = mesh.local_rank("model")
    group = mesh.group("model")
    disp, info = MOE.route(p, x, cfg)
    local = {k: _local_experts(p[k], mesh, group, rank, n)
             for k in ("w_in", "w_gate", "w_out")}
    out_l = MOE.experts(local, _SliceExperts.apply(disp, group, rank, n))
    out_e = _GatherExperts.apply(out_l, group, rank, m)
    out = MOE.combine(out_e, info)
    MOE.router_probes(info, cfg)
    return out.reshape(B, S, D)
