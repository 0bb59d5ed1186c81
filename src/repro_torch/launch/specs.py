"""Input stand-ins and shardings for every (arch x shape x mode) cell: the
port's twin of `src/repro/launch/specs.py`.

A stand-in is an empty tensor with the cell's shape and dtype on
`device`: "meta" by default (no memory), or any device inside an active
`FakeTensorMode`, where it is a fake tensor (the dry run builds them so).
Shardings are `dist.sharding.PartitionSpec`s (`dist.sharding.placements`
gives a spec's DTensor placements on a live mesh).
"""
from __future__ import annotations

import torch

from ..configs.base import ModelConfig, ShapeConfig, TrainConfig
from ..dist import sharding as SH
from ..dist.sharding import PartitionSpec as P
from ..models import registry as MR
from ..optim import tree_map


def _dtype(cfg: ModelConfig):
    return torch.bfloat16 if cfg.dtype == "bfloat16" else torch.float32


def _sds(shape, dtype, device):
    return torch.empty(tuple(shape), dtype=dtype, device=device)


def _tok(shape, device):
    return _sds(shape, torch.int32, device)


def train_batch_specs(cfg: ModelConfig, shape: ShapeConfig,
                      tcfg: TrainConfig, device="meta"):
    B, S = shape.global_batch, shape.seq_len
    Ft = cfg.frontend_tokens
    m = tcfg.microbatch or 0
    dt = _dtype(cfg)

    def mb(x):  # wrap leading microbatch dims
        if m and B % m == 0 and B // m > 1:
            return (B // m, m) + x
        return (B,) + x

    batch = {}
    if cfg.family == "encdec":
        batch["enc_embeds"] = _sds(mb((S, cfg.d_model)), dt, device)
        batch["tokens"] = _tok(mb((S,)), device)
        batch["labels"] = _tok(mb((S,)), device)
    elif cfg.frontend != "none":
        batch["embeds"] = _sds(mb((Ft, cfg.d_model)), dt, device)
        batch["tokens"] = _tok(mb((S - Ft,)), device)
        batch["labels"] = _tok(mb((S,)), device)
        if cfg.rope_kind == "mrope":
            batch["positions"] = _tok(mb((S, 3)), device)
    else:
        batch["tokens"] = _tok(mb((S,)), device)
        batch["labels"] = _tok(mb((S,)), device)
    return batch


def batch_shardings(batch_specs, mesh, cfg: ModelConfig,
                    shape: ShapeConfig, tcfg: TrainConfig):
    micro = bool(tcfg and tcfg.microbatch and
                 shape.global_batch // max(tcfg.microbatch, 1) > 1)

    def shard_one(leaf):
        nd = len(leaf.shape)
        # batch dim position: 1 if microbatched (dim0 = microbatch count)
        bpos = 1 if micro else 0
        bsz = leaf.shape[bpos]
        spec = SH.batch_spec(mesh, bsz, extra_dims=nd - bpos - 1)
        if micro:
            spec = P(None, *spec)
        return SH.fit_spec(spec, leaf.shape, mesh)

    return {k: shard_one(v) for k, v in batch_specs.items()}


def decode_specs(cfg: ModelConfig, shape: ShapeConfig, param_dtype,
                 device="meta"):
    """(tokens, cache, step) stand-ins for serve decode."""
    B, S = shape.global_batch, shape.seq_len
    cdt = _dtype(cfg)
    enc = {"enc_seq": 4096} if cfg.family == "encdec" else {}
    return {
        "tokens": _tok((B, 1), device),
        "cache": MR.make_cache(cfg, B, S, cdt, device, **enc),
        "step": _sds((), torch.int32, device),
    }


def leaf_paths(tree, path=()):
    """[(keys, leaf)] in tree_leaves order (dict keys sorted); a
    PartitionSpec is a leaf."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in leaf_paths(tree[k], path + (k,))]
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return [x for i, t in enumerate(tree)
                for x in leaf_paths(t, path + (str(i),))]
    return [(path, tree)]


def _map_paths(fn, tree, path=()):
    if isinstance(tree, dict):
        return {k: _map_paths(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)) and not isinstance(tree, P):
        return type(tree)(_map_paths(fn, t, path + (str(i),))
                          for i, t in enumerate(tree))
    return fn(path, tree)


def cache_shardings(cache_specs, mesh, cfg: ModelConfig,
                    shape: ShapeConfig):
    B = shape.global_batch

    def one(keys, leaf):
        nd = len(leaf.shape)
        if keys and keys[-1] in ("k", "v", "xk", "xv") and nd == 5:
            return SH.kv_cache_spec(mesh, B, leaf.shape[3])
        if keys and keys[-1] == "pos":
            return P()
        # mamba states [n, B, ...]: batch over fsdp if divisible
        fs = SH.fsdp_axes(mesh)
        size = SH._axis_size(mesh, fs)
        if nd >= 2 and leaf.shape[1] == B and B % size == 0:
            return P(None, fs if len(fs) > 1 else fs[0],
                     *([None] * (nd - 2)))
        return P()

    return _map_paths(one, cache_specs)


def prefill_batch_specs(cfg: ModelConfig, shape: ShapeConfig,
                        device="meta"):
    B, S = shape.global_batch, shape.seq_len
    dt = _dtype(cfg)
    Ft = cfg.frontend_tokens
    batch = {}
    if cfg.family == "encdec":
        batch["enc_embeds"] = _sds((B, 4096, cfg.d_model), dt, device)
        batch["tokens"] = _tok((B, S), device)
    elif cfg.frontend != "none":
        batch["embeds"] = _sds((B, Ft, cfg.d_model), dt, device)
        batch["tokens"] = _tok((B, S - Ft), device)
        if cfg.rope_kind == "mrope":
            batch["positions"] = _tok((B, S, 3), device)
    else:
        batch["tokens"] = _tok((B, S), device)
    return batch


def abstract_params(cfg: ModelConfig, param_dtype: str, device="meta"):
    """The parameter tree's shapes and dtypes as stand-ins on `device`.
    The initialiser runs on fake tensors: the port draws parameters from a
    torch.Generator on their device, which needs none here."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    with FakeTensorMode():
        shapes = MR.init_params(cfg, torch.Generator(), "cpu")
    to = torch.bfloat16 if param_dtype == "bfloat16" else None
    return tree_map(lambda s: _sds(s.shape, to or s.dtype, device), shapes)


def state_shardings(state, mesh):
    """`spec_for` of every leaf of a parameter or train-state tree, by its
    path of dict keys and list indices."""
    return _map_paths(lambda keys, leaf: SH.spec_for(keys, leaf.shape, mesh),
                      state)

