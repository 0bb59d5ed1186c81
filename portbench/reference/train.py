"""The reference's training steps: gradients of the mean loss over the
batch (one sequence at a time, summed), clipped by their global norm,
then AdamW with decoupled weight decay and a linear warm-up into a cosine
schedule, all in float32. It follows the program's first steps from the
same weights and batches and reports what the check compares: each
microbatch's loss, each leaf's gradient norm at step 1 (after the clip,
as the optimizer takes it), each leaf's change after the last step."""
from __future__ import annotations

import math

import torch

from . import exact_float32, model
from .lowp import PRECISIONS

F32 = torch.float32


def flat(tree, prefix=()) -> dict:
    """{path tuple: tensor} of a tree of dicts and lists."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(flat(tree[k], prefix + (k,)))
        return out
    if isinstance(tree, (list, tuple)):
        out = {}
        for i, t in enumerate(tree):
            out.update(flat(t, prefix + (i,)))
        return out
    return {prefix: tree}


def unflat(leaves: dict):
    tree: dict = {}
    for path, t in leaves.items():
        node = tree
        for k, nxt in zip(path[:-1], path[1:]):
            if isinstance(nxt, int):
                node = node.setdefault(k, [])
                while len(node) <= nxt:
                    node.append({})
            elif isinstance(node, list):
                node = node[k]
            else:
                node = node.setdefault(k, {})
        node[path[-1]] = t
    return tree


def lr_at(step: int, t: dict) -> float:
    """Linear warm-up to t["lr"] over t["warmup"] steps, then a cosine
    decay to 0 at t["total_steps"] (step counts from 0)."""
    lr, warm, total = t["lr"], t["warmup"], t["total_steps"]
    if step < warm:
        return lr * step / max(warm, 1)
    frac = min(max((step - warm) / max(total - warm, 1), 0.0), 1.0)
    return lr * 0.5 * (1.0 + math.cos(math.pi * frac))


def train_readings(params, batches, cfg: dict, steps: int,
                   precision: str = "float32") -> dict:
    """Run `steps` reference steps from `params` (not written) on
    batches[s] = (tokens, labels), each [microbatches, micro, S].
    Returns {"losses": [[loss of each microbatch] per step],
    "grad_norms": {path: float} at step 1, "change_norms": {path: float}
    after the last step}."""
    m, t = cfg["model"], cfg["train"]
    ref = model(cfg["reference"])
    pr = PRECISIONS[precision]
    b1, b2, eps = 0.9, 0.95, 1e-8
    with exact_float32():
        p0 = flat(params)
        cur = {k: v.detach().to(F32).clone() for k, v in p0.items()}
        mom = {k: torch.zeros_like(v) for k, v in cur.items()}
        vel = {k: torch.zeros_like(v) for k, v in cur.items()}
        out = {"losses": []}
        for s in range(steps):
            toks, labels = batches[s]
            n_mb, micro = toks.shape[:2]
            leaves = {k: v.requires_grad_(True) for k, v in cur.items()}
            tree = unflat(leaves)
            grads = {k: torch.zeros_like(v) for k, v in cur.items()}
            mb_losses = []
            for i in range(n_mb):
                total = 0.0
                for j in range(micro):
                    lo = ref.loss(tree, toks[i, j:j + 1], labels[i, j:j + 1],
                                  m, pr)
                    g = torch.autograd.grad(lo, list(leaves.values()))
                    for k, gk in zip(leaves, g):
                        grads[k] += gk / (micro * n_mb)
                    total += float(lo.detach())
                mb_losses.append(total / micro)
            out["losses"].append(mb_losses)
            gnorm = math.sqrt(sum(float(g.double().square().sum())
                                  for g in grads.values()))
            scale = min(t["clip_norm"] / max(gnorm, 1e-9), 1.0)
            grads = {k: g * scale for k, g in grads.items()}
            if s == 0:
                out["grad_norms"] = {k: float(g.norm()) for k, g in
                                     grads.items()}
            lr = lr_at(s, t)
            bc1, bc2 = 1 - b1 ** (s + 1), 1 - b2 ** (s + 1)
            with torch.no_grad():
                for k in cur:
                    g = grads[k]
                    mom[k] = b1 * mom[k] + (1 - b1) * g
                    vel[k] = b2 * vel[k] + (1 - b2) * g * g
                    upd = (mom[k] / bc1) / ((vel[k] / bc2).sqrt() + eps) \
                        + t["weight_decay"] * cur[k]
                    cur[k] = (cur[k] - lr * upd).detach()
            del grads
        out["change_norms"] = {k: float((cur[k] - p0[k].to(F32)).norm())
                               for k in cur}
    return out
