"""Flops, HBM bytes and collective bytes of one step, counted over its
ATen operations on fake tensors.

The port's counterpart of `src/repro/launch/hlo_cost.py`, which reads the
optimised HLO with its loop trip counts. Eager PyTorch has no HLO: here
the step runs once under `FakeTensorMode` (no memory, no card) inside a
`TorchDispatchMode` that sees every ATen operation the step dispatches,
loops unrolled as they run, so no trip count is needed.

Counting rules:
  flops        `torch.utils.flop_counter`'s formula of each operation
               (matmuls, convolutions, attention); the flash kernels'
               operators 4*hd (forward) and 10*hd (backward) per (query,
               key) pair a head computes, causal pairs only when causal
  bytes        operand + result bytes of every operation except views and
               metadata operations (the counterpart of hlo_cost's
               `_SKIP_OPS`; eager PyTorch has no fusions to look inside)
  collectives  count, result bytes and wire bytes by type, for every
               `c10d` and `_c10d_functional` operation
  bytes_flash_interior
               the score-matrix bytes each flash call would move if
               attention were unfused, from its shapes: forward S (f32)
               and P (input type) each written and read once, 8 + 2e bytes
               a pair; backward P read twice, dP (f32) written and read,
               dS (input type) written once and read twice, 8 + 5e bytes.
               The kernels keep them on chip, as JAX's "fused" memory term
               assumes; `bytes` includes them, `bytes_fused` does not.

A host read of a device value (`.item()`, `bool(t)`) reads 0 under the
count: the dry run assumes no program vetoes the step and no branch on a
device value is taken.

The counts are global: the step runs once on global shapes. The roofline
divides them by the number of cards (`analysis.roofline_from_cost`).
"""
from __future__ import annotations

from dataclasses import dataclass, field

import torch

_COLLECTIVES = (("all_reduce", "all-reduce"), ("allreduce", "all-reduce"),
                ("all_gather", "all-gather"), ("allgather", "all-gather"),
                ("reduce_scatter", "reduce-scatter"),
                ("all_to_all", "all-to-all"), ("alltoall", "all-to-all"),
                ("broadcast", "broadcast"), ("send", "collective-permute"),
                ("recv", "collective-permute"))
_WIRE = {"all-reduce": 2.0}
# operations (without their overload) that move no data
_SKIP = {"aten::detach", "aten::alias", "aten::lift_fresh",
         "aten::empty", "aten::empty_like", "aten::empty_strided",
         "aten::new_empty", "aten::new_empty_strided", "aten::sym_size",
         "aten::sym_stride", "aten::sym_numel", "aten::sym_storage_offset",
         "aten::is_same_size", "_c10d_functional::wait_tensor"}


@dataclass
class OpCost:
    flops: float = 0.0
    bytes: float = 0.0
    bytes_flash_interior: float = 0.0
    collective_counts: dict = field(default_factory=dict)
    collective_bytes: dict = field(default_factory=dict)
    ops: int = 0                       # operations dispatched
    op_counts: dict = field(default_factory=dict)
    dtypes: set = field(default_factory=set)     # of every result

    @property
    def bytes_fused(self) -> float:
        return self.bytes - self.bytes_flash_interior

    @property
    def coll_wire(self) -> float:
        return sum(v * _WIRE.get(k, 1.0)
                   for k, v in self.collective_bytes.items())


def _tensors(tree):
    from torch.utils._pytree import tree_leaves
    return [t for t in tree_leaves(tree) if isinstance(t, torch.Tensor)]


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _pairs(sq: int, skv: int, causal: bool) -> int:
    """(query, key) pairs one head computes: query i sees keys j <= i when
    causal (`ref._scores`)."""
    if not causal:
        return sq * skv
    m = min(sq, skv)
    return m * (m + 1) // 2 + (sq - m) * skv


def _flash(name: str, args) -> tuple[float, float]:
    """(flops, unfused score-matrix bytes) of one flash operator call."""
    q, k = args[0], args[1]
    causal = bool(args[-1])
    bh, sq, hd = q.shape
    pairs = bh * _pairs(sq, k.shape[1], causal)
    e = q.element_size()
    if name == "repro_torch::flash_fwd":
        return 4.0 * hd * pairs, float((8 + 2 * e) * pairs)
    return 10.0 * hd * pairs, float((8 + 5 * e) * pairs)


def _collective(name: str):
    ns, _, op = name.partition("::")
    if ns not in ("c10d", "_c10d_functional"):
        return None
    return next((kind for key, kind in _COLLECTIVES if key in op), None)


def _counter(cost: OpCost):
    from torch.utils._python_dispatch import TorchDispatchMode
    from torch.utils.flop_counter import flop_registry

    class Count(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            kwargs = kwargs or {}
            name = func.name()
            if name == "aten::_local_scalar_dense":
                return 0
            out = func(*args, **kwargs)
            if name.startswith("prim::"):          # metadata: x.device
                return out
            cost.ops += 1
            cost.op_counts[name] = cost.op_counts.get(name, 0) + 1
            packet = func._overloadpacket
            if packet in flop_registry:
                cost.flops += float(flop_registry[packet](
                    *args, **kwargs, out_val=out))
            elif name in ("repro_torch::flash_fwd", "repro_torch::flash_bwd"):
                fl, interior = _flash(name, args)
                cost.flops += fl
                cost.bytes += interior
                cost.bytes_flash_interior += interior
            kind = _collective(name)
            if kind is not None:
                nb = _nbytes(_tensors(out))
                cost.collective_counts[kind] = \
                    cost.collective_counts.get(kind, 0) + 1
                cost.collective_bytes[kind] = \
                    cost.collective_bytes.get(kind, 0.0) + nb
            outs = _tensors(out)
            cost.dtypes.update(t.dtype for t in outs)
            if name.split(".")[0] not in _SKIP and not func.is_view:
                cost.bytes += _nbytes(_tensors((args, kwargs)))
                cost.bytes += _nbytes(outs)
            return out

    return Count()


def analyze(fn, *args, **kwargs) -> OpCost:
    """Run fn(*args, **kwargs) once on fake tensors and count it. Fake
    arguments keep their mode; real tensors are faked first. The kernels
    are reached through their custom operators (`device.tracing`)."""
    from torch._guards import detect_fake_mode
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils._pytree import tree_map
    from .. import device
    mode = detect_fake_mode((args, kwargs)) or FakeTensorMode()

    def fake(x):
        if isinstance(x, torch.Tensor) and \
                not isinstance(x, torch._subclasses.FakeTensor):
            return mode.from_tensor(x)
        return x
    args, kwargs = tree_map(fake, (args, kwargs))
    cost = OpCost()
    prev, device.TRACING = device.TRACING, True
    try:
        with mode, _counter(cost):
            fn(*args, **kwargs)
    finally:
        device.TRACING = prev
    return cost
