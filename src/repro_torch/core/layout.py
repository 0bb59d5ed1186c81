"""BTF-lite layout schema — the CO-RE vocabulary (DESIGN.md §13).

The paper's compatibility pillar is CO-RE: a probe binary carries symbolic
references (field names, map names) plus the layout it was compiled
against, and a loader relocates it onto whatever concrete layout the
target process actually has.  This module is our BTF: it names the two
abstract surfaces a program can reference —

  * :class:`CtxLayout` — the event-row schema (field name -> i64 word
    index).  Programs written as ``ldxdw r6, [r1+ctx:layer]`` are
    assembled against ONE CtxLayout and re-offset onto any other at load
    time (core/reloc.py), exactly how CO-RE rewrites field offsets from
    the compile-time BTF to the running kernel's.
  * :class:`MapLayout` — the declared shape of one map (kind + dims) a
    program references by ``lddw rX, map:NAME``.  Verification proves
    helper/kind compatibility against the DECLARATION; relocation binds
    the name to a concrete registry fd and re-checks only the cheap
    structural facts (kind equality, record width).

It also owns the canonical **layout fingerprint** — the cache key of the
fleet-wide AOT artifact cache (core/artifact_cache.py).  DESIGN.md §9
proves the live-table step's compiled graph depends only on (map
registry, ctx width, table dims); §12 adds the static attach signature
for the fused lane.  ``layout_fingerprint`` hashes exactly that basis and
nothing else, so two workers with bit-identical trace inputs derive the
same key and the Nth worker joining the fleet reuses the first worker's
executable instead of retracing.
"""
from __future__ import annotations

import hashlib
from dataclasses import dataclass

from .maps import MapKind, MapSpec

FINGERPRINT_VERSION = "bpftime-layout-v1"


class LayoutError(ValueError):
    pass


# --------------------------------------------------------------------------
# ctx layout (the event-row "struct")
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class CtxLayout:
    """Named i64-word layout of a probe context row.

    ``fields`` is a sorted tuple of (name, word_index); ``words`` is the
    row width a program verified against this layout may assume.  The
    byte offset of a field is ``8 * word`` — the event tape is a flat
    i64 vector, so there is no padding or nesting to model (BTF-lite)."""
    name: str
    fields: tuple[tuple[str, int], ...]
    words: int

    def __post_init__(self):
        seen: dict[str, int] = {}
        for f, w in self.fields:
            if f in seen:
                raise LayoutError(f"duplicate ctx field {f!r}")
            if not 0 <= w < self.words:
                raise LayoutError(
                    f"ctx field {f!r} at word {w} outside layout "
                    f"({self.words} words)")
            seen[f] = w

    @staticmethod
    def from_btf(name: str, table: dict[str, int],
                 words: int = 16) -> "CtxLayout":
        return CtxLayout(name=name,
                         fields=tuple(sorted(table.items())),
                         words=words)

    def table(self) -> dict[str, int]:
        return dict(self.fields)

    def word_of(self, field: str) -> int:
        for f, w in self.fields:
            if f == field:
                return w
        raise LayoutError(f"unknown ctx field {field!r} in layout "
                          f"{self.name!r}")

    def byte_of(self, field: str) -> int:
        return 8 * self.word_of(field)

    def has(self, field: str) -> bool:
        return any(f == field for f, _ in self.fields)

    def fingerprint_basis(self) -> tuple:
        return ("ctx", self.name, self.fields, self.words)


# canonical BTF tables (single source of truth; loader re-exports them).
# Event row layout: DESIGN.md §3 / events.EVENT_WIDTH.
EVENT_BTF = {
    "site_id": 0, "kind": 1, "layer": 2, "step": 3,
    "numel": 4, "mean": 5, "rms": 6, "min": 7, "max": 8, "absmax": 9,
    "nan_cnt": 10, "inf_cnt": 11,
}
SYSCALL_BTF = {"sys_id": 0, "arg0": 1, "arg1": 2, "arg2": 3, "arg3": 4,
               "arg4": 5, "ret": 6}

EVENT_LAYOUT = CtxLayout.from_btf("event", EVENT_BTF, words=16)
SYSCALL_LAYOUT = CtxLayout.from_btf("syscall", SYSCALL_BTF, words=16)


def layout_for(prog_type: str, btf: dict | None = None,
               words: int = 16) -> CtxLayout:
    """The CtxLayout a program of this type is assembled/verified against."""
    if btf is not None:
        return CtxLayout.from_btf("custom", dict(btf), words=words)
    if prog_type in ("tracepoint", "filter"):
        return SYSCALL_LAYOUT if words == 16 else \
            CtxLayout.from_btf("syscall", SYSCALL_BTF, words=words)
    return EVENT_LAYOUT if words == 16 else \
        CtxLayout.from_btf("event", EVENT_BTF, words=words)


# --------------------------------------------------------------------------
# map layout (the declared shape a program verifies against)
# --------------------------------------------------------------------------

@dataclass(frozen=True)
class MapLayout:
    """Abstract declaration of one referenced map.

    This is the per-program view: verification proves helper calls are
    legal for ``kind`` and (for ringbufs) sized within ``rec_width``;
    relocation binds ``name`` to a concrete registry fd whose spec must
    be :meth:`compatible` — kind equality plus a record width at least
    as wide as declared (lookups/folds never index past the concrete
    map's own dims: the j_* twins clamp/probe within their state)."""
    name: str
    kind: MapKind
    max_entries: int = 64
    rec_width: int = 4
    num_shards: int = 1

    @staticmethod
    def from_spec(spec: MapSpec) -> "MapLayout":
        return MapLayout(name=spec.name, kind=spec.kind,
                         max_entries=spec.max_entries,
                         rec_width=spec.rec_width,
                         num_shards=spec.num_shards)

    def to_spec(self) -> MapSpec:
        return MapSpec(name=self.name, kind=self.kind,
                       max_entries=self.max_entries,
                       rec_width=self.rec_width,
                       num_shards=self.num_shards)

    def compatible(self, spec: MapSpec) -> str | None:
        """None if a program verified against this layout may run against
        ``spec``; else a human-readable reason."""
        if spec.kind != self.kind:
            return (f"map {self.name!r}: declared kind {self.kind.value}, "
                    f"registry has {spec.kind.value}")
        if spec.kind == MapKind.RINGBUF and spec.rec_width < self.rec_width:
            return (f"ringbuf {self.name!r}: declared rec_width "
                    f"{self.rec_width}, registry has {spec.rec_width}")
        return None


# --------------------------------------------------------------------------
# fingerprints (the artifact-cache key basis)
# --------------------------------------------------------------------------

def registry_basis(map_specs) -> tuple:
    """Canonical identity of a map registry IN FD ORDER — the trace of
    every lane indexes maps positionally, so fd order is part of the
    compiled graph (same set of maps in a different order is a different
    world).  Flags are advisory and excluded (cf. table_interp._spec_key).
    """
    return tuple((s.name, s.kind.value, s.max_entries, s.rec_width,
                  s.num_shards) for s in map_specs)


def layout_fingerprint(map_specs, ctx_words: int,
                       table_dims: tuple | None = None,
                       attach_sig: tuple | None = None,
                       extra: tuple = ()) -> str:
    """The canonical cache key: sha256 over exactly the trace-stability
    basis (DESIGN.md §9/§13) —

        (map registry shape/kinds in fd order, ctx words,
         live-table dims, static attach signature, caller extras)

    Two processes whose steps trace bit-identical graphs derive the same
    key; ANY divergence in the basis (a new map, a wider table, a
    different attach set) derives a different key, which is the whole
    invalidation rule: artifacts are never invalidated in place, they are
    simply keyed away from."""
    basis = (FINGERPRINT_VERSION, registry_basis(map_specs),
             int(ctx_words), tuple(table_dims or ()),
             tuple(attach_sig or ()), tuple(extra))
    return hashlib.sha256(repr(basis).encode()).hexdigest()[:24]


def program_digest(insns_blob: bytes) -> str:
    """Content address of one encoded program (table-image cache keys)."""
    return hashlib.sha256(insns_blob).hexdigest()[:16]
