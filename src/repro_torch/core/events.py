"""Probe sites + event collection -- the binary-rewriting analogue.

Model/framework code is annotated with zero-cost markers:

    x = probe_site("attn.out", x)            # free-standing site
    @traceable("mlp")                        # uprobe (entry) + uretprobe (exit)
    def mlp(params, x): ...

With no collector active, a site is a Python `if` that immediately returns
-- the "5-byte nop". When a program is attached to a site, an active
`Collector` reduces the tensor to a 16-lane i64 stat row (on a CUDA tensor
one launch of the Hopper `tensor_stats` kernel writes the whole row) and
appends it to the step's event tape, on the device. One probe-execution
stage per step then runs the attached eBPF programs over the tape (see
runtime.py) -- events never cross the device/host boundary.

Event row layout (i64 lanes; stats in saturating Q47.16 fixed point):
    0 site_id   1 kind    2 layer     3 step
    4 numel     5 mean    6 rms       7 min
    8 max       9 absmax  10 nan_cnt  11 inf_cnt
    12..15 user/spare (zero)
"""
from __future__ import annotations

import contextlib
import functools
import threading

import torch
from torch.utils.checkpoint import checkpoint

from .. import telemetry as T
from ..kernels import ops
from ..kernels.ref import (EVENT_WIDTH, FX_ONE, FX_SHIFT,  # noqa: F401
                           STAT_KEYS, to_fx)

KIND_ENTRY = 0    # uprobe
KIND_EXIT = 1     # uretprobe
KIND_TRACEPOINT = 2

I64 = torch.int64


def from_fx(v):
    return torch.as_tensor(v).to(torch.float32) / float(FX_ONE)


# --------------------------------------------------------------------------
# site registry (stable name -> id, registration order)
# --------------------------------------------------------------------------

class SiteRegistry:
    def __init__(self):
        self._ids: dict[str, int] = {}
        self._names: list[str] = []
        self._lock = threading.Lock()

    def get_or_create(self, name: str) -> int:
        with self._lock:
            if name not in self._ids:
                self._ids[name] = len(self._names)
                self._names.append(name)
            return self._ids[name]

    def name_of(self, site_id: int) -> str:
        return self._names[site_id]

    def known(self) -> dict[str, int]:
        return dict(self._ids)


SITES = SiteRegistry()
_HEADERS: dict = {}     # (site, kind, layer, numel, device) -> i64[5],
                        # the stats_fn route's headers


# --------------------------------------------------------------------------
# collector (ambient while a probed step runs)
# --------------------------------------------------------------------------

class Collector:
    """Active while a step runs with >=1 device probe attached. `wanted` is
    the set of (site_id, kind) pairs with attached programs -- unattached
    sites stay nops even while a collector is active."""

    _tls = threading.local()

    def __init__(self, wanted: set[tuple[int, int]], stats_fn=None):
        self.wanted = wanted
        self.rows: list = []
        self.layer_ctx = 0
        # tensor -> dict of stats. None: the row route, ops.tensor_stats_row
        # (one kernel launch writes the row of a CUDA tensor, the plain
        # version makes it for a CPU tensor)
        self.stats_fn = stats_fn

    # ---- ambient management
    @classmethod
    def active(cls) -> "Collector | None":
        return getattr(cls._tls, "collector", None)

    def __enter__(self):
        if Collector.active() is not None:
            raise RuntimeError("nested Collector activation")
        Collector._tls.collector = self
        return self

    def __exit__(self, *exc):
        Collector._tls.collector = None
        return False

    @staticmethod
    @contextlib.contextmanager
    def suspended():
        """No collector on this thread inside the block (the remat
        recompute runs the probed forward again; its sites stay nops)."""
        old = Collector.active()
        Collector._tls.collector = None
        try:
            yield
        finally:
            Collector._tls.collector = old

    # ---- emission
    def wants(self, site_id: int, kind: int) -> bool:
        return (site_id, kind) in self.wanted

    def emit_row(self, row):
        assert row.shape == (EVENT_WIDTH,)
        self.rows.append(row)

    def _header(self, site_id, kind, numel, device):
        """Lanes 0-4 of a row as a device tensor for the `stats_fn` route,
        made once per distinct (site, kind, layer, numel, device) and kept,
        so a steady step copies nothing from the host."""
        key = (site_id, kind, int(self.layer_ctx), numel, device)
        h = _HEADERS.get(key)
        if h is None:
            h = torch.tensor([site_id, kind, int(self.layer_ctx), 0, numel],
                             dtype=I64, device=device)
            _HEADERS[key] = h
        return h

    @torch.no_grad()
    def emit_tensor_event(self, site_id: int, kind: int, tensor):
        """Stats of `tensor.detach()`: no probe enters the autograd graph,
        and a probed tensor that carries gradients saves nothing for the
        backward pass. With the default stats this is one kernel launch on
        a CUDA tensor and no other device operation."""
        with T.span("probe.emit"):
            tensor = tensor.detach()
            if self.stats_fn is None:
                self.emit_row(ops.tensor_stats_row(tensor, site_id, kind,
                                                   int(self.layer_ctx)))
                return
            st = self.stats_fn(tensor)
            fx = to_fx(torch.stack([st[k] for k in STAT_KEYS]))
            cnt = torch.stack([st["nan_cnt"], st["inf_cnt"]]).to(I64)
            row = torch.cat([self._header(site_id, kind, tensor.numel(),
                                          tensor.device),
                             fx, cnt, torch.zeros_like(fx[:4])])
            self.emit_row(row)

    def take_all_rows(self, device=None):
        """The tape: every row emitted so far, i64[N, 16], in emission
        order; the collector starts empty again."""
        rows, self.rows = self.rows, []
        if not rows:
            return torch.zeros((0, EVENT_WIDTH), dtype=I64, device=device)
        return torch.stack(rows)


# --------------------------------------------------------------------------
# site markers used by model/framework code
# --------------------------------------------------------------------------

def probe_site(name: str, tensor, kind: int = KIND_TRACEPOINT):
    """Zero-cost marker. Returns `tensor` unchanged."""
    col = Collector.active()
    if col is None:
        return tensor
    sid = SITES.get_or_create(name)
    if col.wants(sid, kind):
        col.emit_tensor_event(sid, kind, tensor)
    return tensor


def _first_tensor(tree):
    if isinstance(tree, torch.Tensor):
        return tree if tree.numel() > 0 else None
    if isinstance(tree, dict):
        tree = [tree[k] for k in sorted(tree)]
    if isinstance(tree, (list, tuple)):
        for t in tree:
            leaf = _first_tensor(t)
            if leaf is not None:
                return leaf
    return None


def traceable(name: str):
    """uprobe/uretprobe pair on a function: entry summarizes the first tensor
    argument leaf, exit summarizes the first output leaf."""
    sid = SITES.get_or_create(name)

    def deco(fn):
        @functools.wraps(fn)
        def wrapper(*args, **kwargs):
            col = Collector.active()
            if col is not None and col.wants(sid, KIND_ENTRY):
                leaf = _first_tensor((args, kwargs))
                if leaf is not None:
                    col.emit_tensor_event(sid, KIND_ENTRY, leaf)
            out = fn(*args, **kwargs)
            if col is not None and col.wants(sid, KIND_EXIT):
                leaf = _first_tensor(out)
                if leaf is not None:
                    col.emit_tensor_event(sid, KIND_EXIT, leaf)
            return out
        return wrapper
    return deco


# --------------------------------------------------------------------------
# layer loop with layer ids
# --------------------------------------------------------------------------

def probed_scan(body, carry, xs, *, length=None, remat=False,
                layer_ids=True):
    """The loop over stacked layers: `xs` is a (nested) structure of
    tensors with the layers on dim 0; body(carry, x_i) -> (carry, y_i).
    Returns (carry, ys) with the y_i stacked on dim 0 (None when every y_i
    is None). While a collector is active each iteration sets `layer_ctx`
    to its index, so its rows carry the layer id; rows land on the tape in
    layer order, the order the JAX scan emits them.

    remat=True wraps each iteration in `torch.utils.checkpoint` (the
    `jax.checkpoint` of the JAX scan): its activations are recomputed in
    the backward pass. The recompute runs with the collector suspended, so
    every site fires once per step, as the JAX scan's rows are primal
    outputs inside the remat boundary."""
    n = length if length is not None else _tree_leaves(xs)[0].shape[0]
    col = Collector.active() if layer_ids else None
    ys = []
    for i in range(n):
        x = _tree_map(lambda a: a[i], xs)
        step = functools.partial(_layer_step, body, col, i)
        if remat:
            carry, y = checkpoint(_once_probed(step), carry, x,
                                  use_reentrant=False)
        else:
            carry, y = step(carry, x)
        ys.append(y)
    return carry, _tree_stack(ys)


def _layer_step(body, col, i, carry, x):
    if col is None:
        return body(carry, x)
    old = col.layer_ctx
    col.layer_ctx = i
    try:
        return body(carry, x)
    finally:
        col.layer_ctx = old


def _once_probed(fn):
    """fn, with every call after the first (the remat recompute) run with
    the collector suspended."""
    calls = [0]

    def run(*args):
        calls[0] += 1
        if calls[0] == 1:
            return fn(*args)
        with Collector.suspended():
            return fn(*args)
    return run


def _tree_leaves(tree) -> list:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _tree_leaves(tree[k])]
    if isinstance(tree, (list, tuple)):
        return [x for t in tree for x in _tree_leaves(t)]
    return []


def _tree_map(fn, tree):
    if isinstance(tree, torch.Tensor):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_tree_map(fn, v) for v in tree)
    return tree


def _tree_stack(ys: list):
    y0 = ys[0] if ys else None
    if y0 is None:
        return None
    if isinstance(y0, torch.Tensor):
        return torch.stack(ys)
    if isinstance(y0, dict):
        return {k: _tree_stack([y[k] for y in ys]) for k in y0}
    if isinstance(y0, (list, tuple)):
        return type(y0)(_tree_stack([y[j] for y in ys])
                        for j in range(len(y0)))
    raise TypeError(f"cannot stack {type(y0)}")
