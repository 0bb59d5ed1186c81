"""The train step: loss -> grads (with microbatch accumulation and remat)
-> clip -> int8 round trip (grad_compression="int8") -> probe-execution
stage -> optimizer.

bpftime integration points:
  * model probe sites fire during the forward (uprobe analogue), once per
    step each: the remat recompute runs with the collector suspended;
  * step-level sites: 'loss' (once per microbatch), 'grad.norm',
    'optimizer.update';
  * the probe stage runs ONCE per step over the whole event tape, on the
    device (the paper's no-context-switch property);
  * a 'filter'-style program that calls override_return on any device
    event makes the step SKIP the optimizer update (guard-rail semantics,
    e.g. NaN-loss batches): params and optimizer state stay bit-identical
    while `step` advances.

The probe stage reads only the tape, which the update cannot change, so
it runs before the update here (the JAX step runs it after, inside one
jit); the veto is then read on the host and the update is skipped rather
than computed and thrown away.

State:  {params, opt, step (i32 0-dim tensor), maps}
Batch:  numpy arrays or tensors, [microbatches, micro_bs, seq] when
        accumulating, else [B, S]; integer arrays become int64 on the
        parameters' device.
"""
from __future__ import annotations

import contextlib

import torch

from .. import telemetry as T
from ..configs.base import ModelConfig, TrainConfig
from ..core import events as E, jit as J
from ..device import resolve
from ..dist.compression import int8_roundtrip
from ..models import registry as MR
from ..optim import (clip_by_global_norm, make_optimizer, tree_leaves,
                     tree_map, warmup_cosine)

F32 = torch.float32


def init_train_state(cfg: ModelConfig, tcfg: TrainConfig, runtime=None,
                     generator: torch.Generator | None = None,
                     device="cuda", params=None) -> dict:
    """Random parameters from `generator` (or the given `params`, e.g.
    carried over from the JAX package), a zeroed optimizer state, step 0
    and the runtime's zeroed maps, all on `device`."""
    dev = resolve(device)
    if params is None:
        params = MR.init_params(cfg, generator, dev)
    if tcfg.param_dtype == "bfloat16":
        params = tree_map(lambda p: p.to(torch.bfloat16), params)
    opt_init, _ = make_optimizer(tcfg.optimizer)
    return {
        "params": params,
        "opt": opt_init(params),
        "step": torch.zeros((), dtype=torch.int32, device=dev),
        "maps": runtime.init_device_maps(dev) if runtime is not None else {},
    }


def abstract_train_state(cfg: ModelConfig, tcfg: TrainConfig, runtime=None,
                         device="meta") -> dict:
    """The train state's shapes and dtypes as stand-ins on `device`, with
    nothing drawn: "meta" (no memory), or any device inside an active
    FakeTensorMode (the dry run). The twin of JAX's `jax.eval_shape` of
    `init_train_state`."""
    from ..launch.specs import abstract_params
    params = abstract_params(cfg, tcfg.param_dtype, device)
    opt_init, _ = make_optimizer(tcfg.optimizer)
    return {
        "params": params,
        "opt": opt_init(params),
        "step": torch.zeros((), dtype=torch.int32, device=device),
        "maps": runtime.init_device_maps(device) if runtime is not None
        else {},
    }


def _to_device(batch: dict, dev) -> dict:
    out = {}
    for k, v in batch.items():
        t = torch.as_tensor(v)
        if not t.is_floating_point():
            t = t.to(torch.int64)          # token ids index the embedding
        out[k] = t.to(dev)
    return out


def _with_leaves(tree, leaves: list):
    """`tree` with its tensor leaves (in tree_leaves order) replaced."""
    it = iter(leaves)
    order = {id(x): next(it) for x in tree_leaves(tree)}
    return tree_map(lambda p: order[id(p)], tree)


def make_train_step(cfg: ModelConfig, tcfg: TrainConfig, runtime=None,
                    probe_mode: str | None = None):
    _, opt_update = make_optimizer(tcfg.optimizer)
    wanted = runtime.wanted_sites() if runtime else set()

    def loss_and_grads(params, mb, col):
        leaves = [p.detach().requires_grad_(True)
                  for p in tree_leaves(params)]
        with torch.enable_grad():
            with T.span("train.forward"):
                loss, _ = MR.loss_fn(_with_leaves(params, leaves), mb, cfg,
                                     remat=tcfg.remat)
            if col is not None:
                E.probe_site("loss", loss.reshape(1))
            with T.span("train.backward"):
                grads = torch.autograd.grad(loss, leaves)
        return loss.detach(), _with_leaves(params, list(grads))

    def train_step(state, batch):
        with T.span("train.step"):
            return _train_step(state, batch)

    def _train_step(state, batch):
        params = state["params"]
        dev = tree_leaves(params)[0].device
        batch = _to_device(batch, dev)
        col = E.Collector(wanted) if runtime else None
        with col if col is not None else contextlib.nullcontext():
            if tcfg.microbatch and batch["tokens"].dim() == 3:
                nmb = batch["tokens"].shape[0]
                acc, losses = None, []
                for i in range(nmb):
                    loss, g = loss_and_grads(
                        params, {k: v[i] for k, v in batch.items()}, col)
                    losses.append(loss)
                    with T.span("train.accumulate"):
                        acc = tree_map(lambda a: a.to(F32), g) \
                            if acc is None \
                            else tree_map(lambda a, b: a + b.to(F32), acc, g)
                    del g
                with T.span("train.accumulate"):
                    grads = tree_map(lambda a: a / nmb, acc)
                    loss = torch.stack(losses).mean()
            else:
                loss, grads = loss_and_grads(params, batch, col)

            with T.span("train.clip"):
                grads, gnorm = clip_by_global_norm(grads, tcfg.clip_norm)
                if tcfg.grad_compression == "int8":
                    # after the clip, as JAX: 'grad.norm' sees the norm
                    # from before compression
                    grads = int8_roundtrip(grads)
            if col is not None:
                E.probe_site("grad.norm", gnorm.reshape(1))
                E.probe_site("optimizer.update", loss.reshape(1))
                rows = col.take_all_rows(dev)

        step = state["step"]
        lr = warmup_cosine(step, lr=tcfg.lr, warmup=tcfg.warmup,
                           total=tcfg.total_steps)
        maps = state["maps"]
        aux = J.make_aux(time_ns=step, device=dev)
        veto = False
        if runtime is not None and rows.shape[0] > 0:
            rows[:, 3] = step.to(torch.int64)
            with T.span("probe.stage"):
                maps, aux = runtime.probe_stage(rows, maps, aux,
                                                mode=probe_mode)
            # filter semantics: an override vetoes this step's update
            with T.span("train.veto_read"):
                veto = bool(aux["override_set"] != 0)
        if veto:
            new_params, new_opt = params, state["opt"]
        else:
            with T.span("train.optimizer"):
                new_params, new_opt = opt_update(
                    params, grads, state["opt"], lr,
                    weight_decay=tcfg.weight_decay, step=step)
        train_step.last_tape = rows if runtime is not None else None
        new_state = {"params": new_params, "opt": new_opt, "step": step + 1,
                     "maps": maps}
        metrics = {"loss": loss, "grad_norm": gnorm, "lr": lr,
                   "vetoed": aux["override_set"] if runtime is not None
                   else torch.zeros((), dtype=torch.int64, device=dev)}
        return new_state, metrics

    train_step.last_tape = None
    return train_step
