"""Optimizers: AdamW and Adafactor, on trees of tensors (nested dicts and
lists with tensor leaves, as the parameters are).

Every function is pure, as in the JAX package: it returns new trees and
writes none of its inputs, so a caller can keep the old state (the
training step's veto does). Scalars that the JAX code computes in f32
(`b1 ** t`, the cosine schedule) are f32 tensors here too. Leaves are
visited in the JAX package's order (dict keys sorted), so sums over
leaves are taken in the same order.

Adafactor (factored second moment, no momentum) is the JAX package's
choice for the >=100B MoE configs.
"""
from __future__ import annotations

import math

import torch

F32 = torch.float32


# --------------------------------------------------------------- trees

def tree_leaves(tree) -> list:
    """Tensor leaves in the JAX package's order: dict keys sorted."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in tree_leaves(t)]
    return [tree]


def tree_paths(tree, prefix: str = "") -> list:
    """Names ("/key/index/...") of the tensor leaves, in tree_leaves'
    order."""
    if isinstance(tree, dict):
        return [n for k in sorted(tree)
                for n in tree_paths(tree[k], f"{prefix}/{k}")]
    if isinstance(tree, (list, tuple)):
        return [n for i, t in enumerate(tree)
                for n in tree_paths(t, f"{prefix}/{i}")]
    return [prefix]


def tree_map(fn, tree, *rest):
    """fn over the tensor leaves of `tree`; `rest` are trees whose
    structure continues `tree`'s (at a leaf of `tree` they may hold any
    value, such as an optimizer state dict)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, t, *(r[i] for r in rest))
                          for i, t in enumerate(tree))
    return fn(tree, *rest)


def _unzip(out, n: int) -> list:
    """A tree of n-tuples -> n trees."""
    return [_pick(out, j) for j in range(n)]


def _pick(tree, j):
    if isinstance(tree, dict):
        return {k: _pick(v, j) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_pick(v, j) for v in tree]
    return tree[j]


# ------------------------------------------------- norms and schedules

def global_norm(tree):
    total = None
    for g in tree_leaves(tree):
        s = torch.sum(torch.square(g.to(F32)))
        total = s if total is None else total + s
    return torch.sqrt(total)


def clip_by_global_norm(grads, max_norm):
    """(grads scaled so their global norm is at most max_norm, norm)."""
    n = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp_min(n, 1e-9), max=1.0)
    return tree_map(lambda g: (g.to(F32) * scale).to(g.dtype), grads), n


def warmup_cosine(step, *, lr, warmup, total):
    """f32 learning rate at `step` (a tensor): linear warmup, then a
    cosine decay to 0 at `total`."""
    step = torch.as_tensor(step).to(F32)
    warm = lr * step / max(warmup, 1)
    t = torch.clamp((step - warmup) / max(total - warmup, 1), 0.0, 1.0)
    cos = lr * 0.5 * (1.0 + torch.cos(math.pi * t))
    return torch.where(step < warmup, warm, cos)


# ----------------------------------------------------------------- AdamW

def adamw_init(params):
    return {"m": tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                                device=p.device), params),
            "v": tree_map(lambda p: torch.zeros(p.shape, dtype=F32,
                                                device=p.device), params)}


def adamw_update(params, grads, opt, lr, *, b1=0.9, b2=0.95, eps=1e-8,
                 weight_decay=0.1, step=None):
    t = (torch.as_tensor(step) + 1).to(F32)
    bc1 = 1.0 - torch.pow(b1, t)
    bc2 = 1.0 - torch.pow(b2, t)

    def upd(p, g, m, v):
        gf = g.to(F32)
        m2 = b1 * m + (1 - b1) * gf
        v2 = b2 * v + (1 - b2) * gf * gf
        mh = m2 / bc1
        vh = v2 / bc2
        delta = mh / (torch.sqrt(vh) + eps) + weight_decay * p.to(F32)
        return (p.to(F32) - lr * delta).to(p.dtype), m2, v2

    new_p, new_m, new_v = _unzip(
        tree_map(upd, params, grads, opt["m"], opt["v"]), 3)
    return new_p, {"m": new_m, "v": new_v}


# --------------------------------------------------------------- Adafactor

def _factored(shape) -> bool:
    return len(shape) >= 2


def adafactor_init(params):
    def init(p):
        if _factored(p.shape):
            return {"vr": torch.zeros(p.shape[:-1], dtype=F32,
                                      device=p.device),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:],
                                      dtype=F32, device=p.device)}
        return {"v": torch.zeros(p.shape, dtype=F32, device=p.device)}
    return {"f": tree_map(init, params)}


def _rsqrt(x):
    return torch.rsqrt(torch.clamp_min(x, 1e-30))


def adafactor_update(params, grads, opt, lr, *, decay=0.8, eps=1e-30,
                     weight_decay=0.0, clip_thresh=1.0, step=None):
    t = (torch.as_tensor(step) + 1).to(F32)
    beta = 1.0 - torch.pow(t, -decay)

    def upd(p, g, st):
        gf = g.to(F32)
        g2 = gf * gf + eps
        if _factored(p.shape):
            vr = beta * st["vr"] + (1 - beta) * torch.mean(g2, dim=-1)
            vc = beta * st["vc"] + (1 - beta) * torch.mean(g2, dim=-2)
            rfac = _rsqrt(vr / torch.clamp_min(
                torch.mean(vr, dim=-1, keepdim=True), eps))
            cfac = _rsqrt(vc)
            u = gf * rfac[..., None] * cfac[..., None, :]
            new_st = {"vr": vr, "vc": vc}
        else:
            v = beta * st["v"] + (1 - beta) * g2
            u = gf * _rsqrt(v)
            new_st = {"v": v}
        # update clipping (RMS <= clip_thresh)
        rms = torch.sqrt(torch.mean(torch.square(u)) + 1e-12)
        u = u / torch.clamp_min(rms / clip_thresh, 1.0)
        delta = u + weight_decay * p.to(F32)
        return (p.to(F32) - lr * delta).to(p.dtype), new_st

    new_p, new_f = _unzip(tree_map(upd, params, grads, opt["f"]), 2)
    return new_p, {"f": new_f}


def adafactor_move_bound(before, after, lr, dtype, *, weight_decay=0.0,
                         clip_thresh=1.0) -> tuple[float, float]:
    """The bound adafactor_update's step puts on a leaf's move, whatever
    its gradient: the update u is clipped to RMS <= clip_thresh, then
    p' = p - lr (u + weight_decay p) in f32, rounded to the parameter's
    `dtype`. So the RMS over the leaf of p' - p + lr weight_decay p is at
    most lr clip_thresh, plus the RMS of half an ulp of p' for the
    rounding. `before` and `after` are the leaf before and after the step
    (any float type). Returns (that RMS, the bound)."""
    p, q = before.double(), after.double()
    move = q - p + lr * weight_decay * p
    half_ulp = q.abs() * (torch.finfo(dtype).eps / 2)
    return (float(move.square().mean().sqrt()),
            lr * clip_thresh + float(half_ulp.square().mean().sqrt()))


# ----------------------------------------------------------------- factory

def make_optimizer(name: str):
    if name == "adamw":
        return adamw_init, adamw_update
    if name == "adafactor":
        return adafactor_init, adafactor_update
    raise KeyError(name)
