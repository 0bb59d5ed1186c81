"""The serving decode step's model work, replayed from CUDA graphs.

`ServeEngine`'s decode step (`steps.make_decode_step(..., graphs=True)`)
replays the work `registry.decode_fn` launches from graphs captured once,
wherever `engages` holds. The rest of the step stays eager: each probe
event's statistics launch, the tape, the `decode.logits` site, sampling and
the probe stage. So every launch, record and span of the probe path runs
per step as in the eager step.

Segments. The work is captured as a sequence of graphs cut at the probe
sites the step's collector wants: a wanted site ends the graph being
captured and the next one begins. The capture keeps each site's id, kind
and layer, and the tensor the site saw, which lives in the graphs' memory
pool and is written anew by every replay. A replay runs segment 0, emits
the first site's event from its tensor, runs segment 1, and so on, so the
events land on the tape in the eager step's order.

The cache. A graph reads and writes fixed addresses, so the step owns two
caches, A and B, shaped like the first cache it is given. Given A it reads
A and writes the next cache into B: each layer's rows are copied across
and the new row is written at `pos`. Given B it does the reverse, with a
second set of graphs; both sets share one memory pool. Any other cache is
first copied into A. The step never writes the cache it was given. While
the caller passes back the cache the step returned, that cache stays valid
until the step after next, and the returned logits until the next call. A
caller may write the returned cache in place (`ServeEngine`'s refills do),
and the next step reads those writes.

A set of graphs is captured at the first call in its direction, and again
after the parameters object or the token batch's shape changes. The keyed
record `decode.graph` counts each call as "capture" or "replay"; the
decode step counts its eager calls as "eager".

Spans and records. A replay runs none of the model's Python, so the spans
it would open and the records it would count (`telemetry.py`) are noted
while each segment is captured. A replay runs a segment inside a span of
the one name the segment opened (none where it opened two or more, or
none), and counts the segment's records again. Cut at the probe sites, a
segment holds one layer's mixer or its experts: the `ssm.mixer` and
`moe.routed` spans of a probed step come back at each replay.
"""
from __future__ import annotations

import contextlib

import torch

from .. import telemetry as T
from ..configs.base import ModelConfig
from ..core import events as E
from ..device import tracing
from ..models import registry as MR
from .graph_capture import Capture, capture, replay, settle


def engages(cfg: ModelConfig, cache) -> bool:
    """Whether the graphed path runs: the cache is on a CUDA device, the
    config's decode is capturable (`registry.decode_capturable`), and the
    step is not being traced for export or counting."""
    return (cache["pos"].is_cuda and not tracing()
            and MR.decode_capturable(cfg))


class DecodeGraphs:
    """The graphed model work of one decode step (see the module's
    docstring). `wanted`: the (site id, kind) pairs the step's collector
    wants; `probed`: whether the step runs a collector at all."""

    def __init__(self, cfg: ModelConfig, wanted, probed: bool):
        self.cfg, self.wanted, self.probed = cfg, wanted, probed
        self.bufs = None             # [A, B]
        self.leaves = None           # each buffer's tensors
        self.sets: dict = {}         # source buffer -> (segments, logits)
        self.params = self.tokens = self.stream = self.pool = None

    def __call__(self, params, tokens, cache, col):
        """(logits, new cache) of `registry.decode_fn(params, tokens,
        cache)`; the events go to `col` (None: unprobed)."""
        src = self._source(cache)
        if (params is not self.params or self.tokens is None
                or tokens.shape != self.tokens.shape
                or tokens.dtype != self.tokens.dtype):
            self.params, self.tokens = params, torch.empty_like(tokens)
            self.sets.clear()
        self.tokens.copy_(tokens)
        if src in self.sets:
            T.count("decode.graph", "replay")
        else:
            T.count("decode.graph", "capture")
            self.sets[src] = self._capture(src)
        segments, logits = self.sets[src]
        layer = col.layer_ctx if col is not None else 0
        for graph, site, name, records in segments:
            replay(graph, name, records)
            if site is not None:
                sid, kind, at, t = site
                col.layer_ctx = at
                col.emit_tensor_event(sid, kind, t)
        if col is not None:
            col.layer_ctx = layer
        return logits, self.bufs[1 - src]

    def _source(self, cache) -> int:
        """The index of the owned buffer the step reads: the given cache's
        own, or A with the given cache copied into it."""
        given = E._tree_leaves(cache)
        if self.bufs is not None:
            for i, own in enumerate(self.leaves):
                if len(own) == len(given) and all(
                        a is b for a, b in zip(own, given)):
                    return i
        if self.bufs is None or [(t.shape, t.dtype) for t in given] != [
                (t.shape, t.dtype) for t in self.leaves[0]]:
            self.bufs = [E._tree_map(torch.empty_like, cache)
                         for _ in range(2)]
            self.leaves = [E._tree_leaves(b) for b in self.bufs]
            self.sets.clear()
        for a, b in zip(self.leaves[0], given):
            a.copy_(b)
        return 0

    def _capture(self, src: int):
        """Capture the work that reads buffer `src` and writes the other:
        one eager warm pass on a side stream, then the capture on it.
        Returns (segments, the logits tensor they leave)."""
        dev = self.tokens.device
        if self.stream is None:
            self.stream = torch.cuda.Stream(dev)
        if not self.sets:
            self.pool = torch.cuda.graph_pool_handle()
        cap = Capture(self.pool, self.wanted)

        def run():
            # the step's own collector is active around this call
            with E.Collector.suspended(), \
                    cap if self.probed else contextlib.nullcontext():
                return MR.decode_fn(self.params, self.tokens,
                                    self.bufs[src], self.cfg,
                                    cache_out=self.bufs[1 - src])[0]

        self.stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(self.stream), torch.no_grad():
            run()
            settle(dev)
            logits = capture(cap, run)
        torch.cuda.current_stream(dev).wait_stream(self.stream)
        return cap.segments, logits
