"""Sharding rules for params/optimizer state/batches on the production
meshes (("data", "model") single-pod, ("pod", "data", "model") multi-pod).

The rules are the JAX package's (`src/repro/dist/sharding.py`) with no
change of logic:
  * `spec_for(path_keys, shape, mesh)` — name-pattern rules (embedding,
    MoE expert weights) with a generic [in, out] -> ("data", "model")
    default; Adafactor factored moments (`vr`/`vc`) inherit the parent
    param's rule with the reduced dim dropped; stacked leading dims are
    replicated (padded with None).
  * `fit_spec` — divisibility fallback: any dim a mesh axis does not evenly
    divide falls back to replicated on that dim.
  * `use_mesh` / `active_mesh` / `constrain` — the ambient mesh; everything
    is a no-op without a mesh, so single-device code runs unchanged.

The rules read only `mesh.axis_names` and `mesh.shape[name]`, so any
object with those two works; `Mesh` gives them to a
`torch.distributed.device_mesh.DeviceMesh`. A spec is this module's
`PartitionSpec` (a tuple of entries: None, an axis name, or a tuple of
axis names); `placements` turns it into DTensor placements.

The port's model code has no `constrain` call sites: in JAX they are
layout hints to GSPMD that change no value, and eager PyTorch has no
partitioner to read them (ROADMAP, deliberate differences).
"""
from __future__ import annotations

import contextlib
import math
import threading

_tls = threading.local()


class PartitionSpec(tuple):
    """A sharding spec: one entry per tensor dim, each None (replicated),
    a mesh axis name, or a tuple of axis names (major to minor). Equal to
    any tuple with the same entries, as JAX's `PartitionSpec` is."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


P = PartitionSpec


class Mesh:
    """A `DeviceMesh` seen as the rules see a mesh: `axis_names` and
    `shape[name]`, plus the process group of an axis."""

    def __init__(self, device_mesh):
        self.device_mesh = device_mesh
        self.axis_names = tuple(device_mesh.mesh_dim_names)
        self.shape = {a: int(device_mesh.size(i))
                      for i, a in enumerate(self.axis_names)}
        self.device_type = device_mesh.device_type
        self._groups: dict = {}       # a decode step asks once per layer
        self._ranks: dict = {}

    @property
    def devices_shape(self) -> tuple:
        return tuple(self.shape[a] for a in self.axis_names)

    def group(self, axis: str):
        if axis not in self._groups:
            self._groups[axis] = self.device_mesh.get_group(axis)
        return self._groups[axis]

    def local_rank(self, axis: str) -> int:
        if axis not in self._ranks:
            self._ranks[axis] = int(self.device_mesh.get_local_rank(axis))
        return self._ranks[axis]

    def __repr__(self):
        return f"Mesh({self.shape}, {self.device_type!r})"


# --------------------------------------------------------------------------
# ambient mesh
# --------------------------------------------------------------------------

def active_mesh():
    stack = getattr(_tls, "meshes", None)
    return stack[-1] if stack else None


@contextlib.contextmanager
def use_mesh(mesh):
    stack = getattr(_tls, "meshes", None)
    if stack is None:
        stack = _tls.meshes = []
    stack.append(mesh)
    try:
        yield mesh
    finally:
        stack.pop()


# --------------------------------------------------------------------------
# helpers
# --------------------------------------------------------------------------

def fsdp_axes(mesh) -> tuple:
    """Axes batches/fsdp shard over: every axis except tensor-parallel
    'model' (so ('data',) or ('pod', 'data'))."""
    return tuple(a for a in mesh.axis_names if a != "model")


def _axis_size(mesh, entry) -> int:
    if entry is None:
        return 1
    if isinstance(entry, (tuple, list)):
        return math.prod(_axis_size(mesh, a) for a in entry)
    return int(mesh.shape[entry])


def fit_spec(spec: P, shape, mesh) -> P:
    """Drop spec entries whose mesh-axis product does not divide the dim."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    entries = entries[:len(shape)]
    out = []
    for dim, entry in zip(shape, entries):
        size = _axis_size(mesh, entry)
        out.append(entry if entry is not None and dim % size == 0 else None)
    return P(*out)


def device_mesh_of(mesh):
    """The `DeviceMesh` under a `Mesh` (a DeviceMesh is its own)."""
    return getattr(mesh, "device_mesh", mesh)


def placements(spec, mesh) -> tuple:
    """DTensor placements of `spec` on `mesh`, one per mesh axis: Shard(d)
    where tensor dim d's entry names the axis (alone or in a tuple), else
    Replicate(). A tuple entry shards its dim over its axes in mesh order,
    which is the order the rules write them."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for axis in mesh.axis_names:
        dim = next((d for d, e in enumerate(spec)
                    if e == axis or (isinstance(e, (tuple, list))
                                     and axis in e)), None)
        out.append(Replicate() if dim is None else Shard(dim))
    return tuple(out)


def replicated(mesh) -> tuple:
    """Placements that replicate on every axis of `mesh`."""
    return placements(P(), mesh)


# --------------------------------------------------------------------------
# parameter rules
# --------------------------------------------------------------------------

# name -> base spec over the param's trailing dims. Entries are mesh axis
# names; the generic fallback is ("data", "model") = [in-features sharded
# over fsdp, out-features over tensor-parallel].
_RULES: dict[str, tuple] = {
    "embedding": ("model", "data"),       # [V, D]: vocab over TP
    "w_in": ("model", "data", None),      # MoE [E, D, F]: experts over TP
    "w_gate": ("model", "data", None),
    "w_out": ("model", None, "data"),     # MoE [E, F, D]
}


def spec_for(keys, shape, mesh) -> P:
    """Sharding spec for a param (or optimizer-moment) tree leaf.

    keys: path of dict keys from the tree root (strings); shape: leaf
    shape. Factored-moment leaves (`vr` drops the last dim, `vc` the
    second-to-last) inherit the parent param's rule minus that dim."""
    keys = [str(k) for k in keys]
    moment = keys[-1] if keys and keys[-1] in ("vr", "vc") else None
    base_keys = keys[:-1] if moment else keys
    name = next((k for k in reversed(base_keys) if k in _RULES), None)
    param_rank = len(shape) + (1 if moment else 0)
    if name is not None:
        base = list(_RULES[name])
    elif param_rank >= 2:
        base = ["data", "model"]
    else:
        base = []
    if moment == "vr" and base:
        base = base[:-1]
    elif moment == "vc" and len(base) >= 2:
        base = base[:-2] + base[-1:]
    if len(base) < len(shape):           # stacked leading dims: replicate
        base = [None] * (len(shape) - len(base)) + base
    elif len(base) > len(shape):
        base = base[-len(shape):]
    return fit_spec(P(*base), shape, mesh)


# --------------------------------------------------------------------------
# batch / cache rules
# --------------------------------------------------------------------------

def _batch_entry(mesh, dim):
    fs = fsdp_axes(mesh)
    if not fs or dim % _axis_size(mesh, fs):
        return None
    return fs if len(fs) > 1 else fs[0]


def batch_spec(mesh, bsz: int, extra_dims: int = 0) -> P:
    """Leading batch dim over the fsdp axes (when divisible), rest
    replicated."""
    return P(_batch_entry(mesh, bsz), *([None] * extra_dims))


def kv_cache_spec(mesh, batch: int, kv_heads: int) -> P:
    """KV cache leaves [n_layers, B, S, KH, hd]: batch over fsdp, heads
    over 'model' when they divide."""
    m = None
    if "model" in mesh.axis_names and kv_heads % int(mesh.shape["model"]) == 0:
        m = "model"
    return P(None, _batch_entry(mesh, batch), None, m, None)


# --------------------------------------------------------------------------
# constraints
# --------------------------------------------------------------------------

def constrain(x, *axes):
    """`x` redistributed to the spec `axes` resolve to under the ambient
    mesh; `x` itself without a mesh or when it is not a DTensor. Axis
    entries: None, a mesh axis name, or the logical name 'batch' (resolves
    to the fsdp axes). Unknown axes and non-dividing dims fall back to
    replicated on that dim."""
    mesh = active_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    entries = []
    for a in axes:
        if a == "batch":
            fs = fsdp_axes(mesh)
            entries.append(fs if len(fs) > 1 else (fs[0] if fs else None))
        elif a is None or a in mesh.axis_names:
            entries.append(a)
        else:
            entries.append(None)
    spec = fit_spec(P(*entries), x.shape, mesh)
    return x.redistribute(device_mesh_of(mesh), placements(spec, mesh))
