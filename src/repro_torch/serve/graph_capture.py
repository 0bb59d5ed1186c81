"""Capturing model work into a sequence of CUDA graphs, and replaying it.

Both graphed paths of the serving loop use these pieces: the decode step
(`serve/decode_graph.py`), whose capture is cut at the probe sites its
collector wants, and the batch-1 prefill (`serve/prefill_graph.py`), whose
capture is cut where a `moe.routed` or `ssm.mixer` span opens and closes
(`telemetry.cut_at`).

A segment is one graph with the span it opened and the records it counted
(`telemetry.notes_begin`): a replay runs none of the model's Python, so
`replay` opens that span around the graph and counts the records again.
"""
from __future__ import annotations

import contextlib
import gc
import warnings

import torch

from .. import telemetry as T
from ..core import events as E


class Capture(E.Collector):
    """The segments of one capture, all in one memory pool. `cut()` ends the
    graph being captured and begins the next. Entered as the collector of
    the captured work, a wanted probe site cuts too, keeping (site id, kind,
    layer, tensor) beside the graph it ends; outside a capture (a warm
    pass) a site does nothing."""

    def __init__(self, pool, wanted=frozenset()):
        super().__init__(wanted)
        self.pool = pool
        self.graph = None
        # (graph, site or None, span name or None, records)
        self.segments: list = []

    def begin(self):
        self.graph = torch.cuda.CUDAGraph()
        T.notes_begin()
        self.graph.capture_begin(pool=self.pool,
                                 capture_error_mode="thread_local")

    def end(self, site=None):
        graph, self.graph = self.graph, None
        with warnings.catch_warnings():
            # a segment with only views in it (between one layer's exit
            # site and the next one's entry site, or after the `logits`
            # site) captures no work: a valid graph whose replay does nothing
            warnings.filterwarnings("ignore", "The CUDA Graph is empty")
            graph.capture_end()
        notes = T.notes_end()
        spans = {n[1] for n in notes if n[0] == "span"}
        self.segments.append((graph, site,
                              spans.pop() if len(spans) == 1 else None,
                              [n[1:] for n in notes if n[0] == "count"]))

    def cut(self):
        """End the graph being captured here and begin the next."""
        self.end()
        self.begin()

    def emit_tensor_event(self, site_id: int, kind: int, tensor):
        if self.graph is not None:
            self.end((site_id, kind, int(self.layer_ctx), tensor.detach()))
            self.begin()


def settle(dev):
    """Before a capture on a side stream: wait for the device, collect
    garbage, as `torch.cuda.graph` does (graphs freed by a collection
    inside the capture would invalidate it), and hand back the memory the
    side stream's warm pass left cached, where nothing else would reuse
    it."""
    torch.cuda.synchronize(dev)
    gc.collect()
    torch.cuda.empty_cache()


def capture(cap: Capture, run):
    """run() captured into cap's segments on the current stream; returns
    what run returns. On an error the graph being captured is ended and
    the notes dropped."""
    cap.begin()
    try:
        out = run()
    except BaseException:
        if cap.graph is not None:
            with contextlib.suppress(RuntimeError):
                cap.graph.capture_end()
            T.notes_end()
        raise
    cap.end()
    return out


def replay(graph, name, records):
    """One segment: its graph replayed inside a span of its name, then its
    records counted again."""
    with T.span(name) if name else T.OFF:
        graph.replay()
    for rec in records:
        T.count(*rec)
