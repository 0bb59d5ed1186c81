"""Mixture-of-Experts layer: top-k routing with sort-based capacity dispatch.

The GSPMD formulation of the JAX package (`repro/models/moe.py`): one
global scatter into [E, C, D], the expert FFN as three einsums over the
stacked expert weights, and a weighted scatter-add back to the tokens.
The expert-parallel path (each rank of a mesh's 'model' axis runs its
share of the experts, REPRO_MOE_EP=1) is `dist/expert_parallel.py`.

Router probe sites make this the flagship bpftime use case: per-expert load
and overflow-drop counters via eBPF maps (`launch/serve.py` MOE_PROBES).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .. import telemetry as T
from ..configs.base import ModelConfig
from ..core import events as E
from .layers import randn

F32 = torch.float32


def init_moe(gen, cfg: ModelConfig, device, lead=()):
    D, Fh, Ex = cfg.d_model, cfg.moe_d_ff, cfg.num_experts
    s = 1.0 / math.sqrt(D)
    return {
        "router": randn(gen, lead + (D, Ex), s, device),
        "w_in": randn(gen, lead + (Ex, D, Fh), s, device),
        "w_gate": randn(gen, lead + (Ex, D, Fh), s, device),
        "w_out": randn(gen, lead + (Ex, Fh, D), 1.0 / math.sqrt(Fh), device),
    }


# the leaves used only through a cast to the compute type
# (`registry.serving_params` holds them in it for serving)
CAST_LEAVES = ("router", "w_in", "w_gate", "w_out")


def capacity(cfg: ModelConfig, tokens: int) -> int:
    """Slots an expert takes. Dropless (`moe_dropless`): every token, since
    a token assigns an expert once at most, so nothing drops and the shapes
    stay fixed."""
    if cfg.moe_dropless:
        return tokens
    c = int(cfg.capacity_factor * tokens * cfg.experts_per_token
            / cfg.num_experts)
    return max(8, -(-c // 8) * 8)   # pad to 8 for layout friendliness


def gates_of(p, xt):
    """Router softmax of the tokens xt [T, D] -> f32 [T, E]; the
    `moe.router` site sees the logits."""
    logits = (xt @ p["router"].to(xt.dtype)).to(F32)
    logits = E.probe_site("moe.router", logits)
    return torch.softmax(logits, dim=-1)


def top_k(gates, k: int):
    """The k largest gates of each row, lower expert id first on ties (as
    `jax.lax.top_k`; `torch.topk` promises no order): a stable descending
    sort. Returns (gvals normalised to sum 1, gids i64)."""
    gvals, gids = torch.sort(gates, dim=-1, descending=True, stable=True)
    gvals, gids = gvals[:, :k], gids[:, :k]
    gvals = gvals / torch.clamp_min(gvals.sum(-1, keepdim=True), 1e-9)
    return gvals, gids


def dispatch_plan(gids, C: int):
    """Where each of the T*k assignments goes: the assignments sorted by
    expert id (stable, so token order within an expert), the position in
    its expert's run, and slot C (the trash slot) past the capacity.
    Returns (sort_idx, sorted_eids, pos_c, keep)."""
    flat_ids = gids.reshape(-1)
    sort_idx = torch.argsort(flat_ids, stable=True)
    sorted_eids = flat_ids[sort_idx]
    first_idx = torch.searchsorted(sorted_eids, sorted_eids, side="left")
    pos = torch.arange(flat_ids.shape[0], device=gids.device) - first_idx
    keep = pos < C
    pos_c = torch.where(keep, pos, C)
    return sort_idx, sorted_eids, pos_c, keep


def route(p, x, cfg: ModelConfig):
    """Top-k routing + sort-based capacity dispatch.
    x: [B, S, D] -> (disp [E, C, D], info)."""
    B, S, D = x.shape
    T = B * S
    k = cfg.experts_per_token
    xt = x.reshape(T, D)
    gvals, gids = top_k(gates_of(p, xt), k)
    C = capacity(cfg, T)
    sort_idx, sorted_eids, pos_c, keep = dispatch_plan(gids, C)
    tok_idx = sort_idx // k
    # several assignments land in trash slot C; it is sliced off, so which
    # write wins there does not matter
    disp = x.new_zeros((cfg.num_experts, C + 1, D))
    disp[sorted_eids, pos_c] = xt[tok_idx]
    info = dict(sorted_eids=sorted_eids, pos_c=pos_c, tok_idx=tok_idx,
                sort_idx=sort_idx, gvals=gvals, gids=gids, keep=keep, T=T)
    return disp[:, :C, :], info


def combine(out_e, info):
    """Gather expert outputs back to tokens, weighted by gate values. Each
    token's k contributions are added one after another from zero, in the
    outputs' type, in the order of the sorted assignments (ascending expert
    id): the JAX package's scatter-add order, the same on every run and
    under graph replay (index_add_ on CUDA adds in any order)."""
    Ex, _, D = out_e.shape
    out_e = torch.cat([out_e, out_e.new_zeros((Ex, 1, D))], dim=1)  # trash
    contrib = out_e[info["sorted_eids"], info["pos_c"]]          # [TK, D]
    sort_idx = info["sort_idx"]
    TK = sort_idx.shape[0]
    w = (info["gvals"].reshape(TK)[sort_idx]
         * info["keep"]).to(out_e.dtype)
    contrib = contrib * w[:, None]
    # each token's k places in the sorted order, ascending
    at = torch.empty_like(sort_idx).scatter_(
        0, sort_idx, torch.arange(TK, device=sort_idx.device))
    at = at.reshape(info["T"], -1).sort(dim=1).values
    parts = contrib[at]                                         # [T, k, D]
    out = out_e.new_zeros((info["T"], D))
    for r in range(parts.shape[1]):
        out = out + parts[:, r]
    return out


def expert_load(gids, num_experts: int):
    """Assignments per expert, f32 [E]. A scatter-add of ones (integer, so
    exact in any order); `torch.bincount` would read the largest id back
    to the host on CUDA, a sync inside the step."""
    ids = gids.reshape(-1)
    return torch.zeros(num_experts, dtype=torch.int64, device=ids.device) \
        .scatter_add_(0, ids, torch.ones_like(ids)).to(F32)


def router_probes(info, cfg: ModelConfig):
    """Router health stats for probe sites: per-expert load + drops. With
    no collector active (an unprobed step) nothing is computed."""
    if E.Collector.active() is None:
        return
    E.probe_site("moe.load", expert_load(info["gids"], cfg.num_experts))
    drops = (~info["keep"]).sum().to(F32)
    E.probe_site("moe.drops", drops.reshape(1))


def experts(p, disp):
    """The expert FFN (swiglu) over each expert's slots: disp [E, C, D] ->
    [E, C, D]."""
    dt = disp.dtype
    h = torch.einsum("ecd,edf->ecf", disp, p["w_in"].to(dt))
    g = torch.einsum("ecd,edf->ecf", disp, p["w_gate"].to(dt))
    h = F.silu(g.to(F32)).to(dt) * h
    return torch.einsum("ecf,efd->ecd", h, p["w_out"].to(dt))


def apply_moe(p, x, cfg: ModelConfig):
    """x: [B, S, D] -> [B, S, D]. Sort-based dispatch (dropping, or
    dropless at `moe_dropless`). The span `moe.routed` holds the router,
    the dispatch, the experts and the combine; the keyed record
    `moe.routed` counts each call by (experts held, k, D, expert width,
    tokens, element size)."""
    B, S, D = x.shape
    T.count("moe.routed", (p["w_in"].shape[-3], cfg.experts_per_token, D,
                           p["w_in"].shape[-1], B * S, x.element_size()))
    with T.span("moe.routed"):
        disp, info = route(p, x, cfg)
        out = combine(experts(p, disp), info)
    router_probes(info, cfg)
    return out.reshape(B, S, D)


def aux_load_balance_loss(p, x, cfg: ModelConfig):
    """Switch-style load-balance auxiliary loss (optional, used in train)."""
    B, S, D = x.shape
    xt = x.reshape(B * S, D)
    logits = (xt @ p["router"].to(x.dtype)).to(F32)
    gates = torch.softmax(logits, dim=-1)
    ids = torch.argmax(gates, dim=-1)                # first maximum, as JAX
    me = gates.mean(dim=0)
    ce = F.one_hot(ids, cfg.num_experts).to(F32).mean(dim=0)
    return cfg.num_experts * torch.sum(me * ce)
