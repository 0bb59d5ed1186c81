"""The serving loop's batch-1 prefill, replayed from CUDA graphs.

`ServeEngine._prefill_slot` replays the model work of a prefill from a
graph captured once for each bucket of right-padded prompt lengths,
wherever `engages` holds and the prompt fits the largest bucket. The rest
of the call stays eager: its spans, the prompt's token count, the write
of its slot, the read of its first token.

Buckets. A fixed ladder, `LADDER`, cut at the engine's max_seq and at
2048 tokens (above it the prefill takes the flash path), with the cut as
the last bucket: a prompt of 16 tokens or more is padded by at most half
its length. A prompt of n tokens is right-padded with id 0 to the least
bucket b >= n and prefilled with its real length (`registry.prefill_fn`'s
"length"): attention is causal, a Mamba-2 mixer gives the padded
positions dt 0 and takes its conv state at the real length, and a
dropless MoE routes each token alone, so each real position gets what
the prompt alone gives, up to the rounding the shapes set (the GEMMs',
the SSD chunk of min(ssm_chunk, b)). A capacity MoE is not captured
(`registry.prefill_capturable`).

Buffers. The graphs read one token buffer and the real length, written
from the host before each replay, and write one 1 x max_seq staging cache
and one logits row, the real last position's, gathered in the graph after
the full unembed. The staging cache's rows past the real length hold what
an earlier prefill left there: the decode masks them by the slot's length
and overwrites them. All buckets' graphs share one memory pool of their
own, and each is replayed whole before another runs.

Capture. `capture_all` runs the largest bucket once eagerly on a side
stream, which makes what the first launches there make (the cuBLAS
handle and workspace), then captures every bucket, the largest first, so
that the smaller ones reuse the pool's memory. The engine builds its
`PrefillGraphs` and captures every bucket at its first `submit_all`,
before the first request is served; a call only replays. The keyed
record `serve.prefill_graph` counts each capture ("capture", bucket) and
each prefill ("replay", bucket); the engine counts its eager prefills
("eager", 0).

Spans and records. The capture is cut where a `moe.routed` or `ssm.mixer`
span opens and where it closes (`telemetry.cut_at`). Each segment is
replayed inside a span of the name it opened, and its records are counted
again (`graph_capture.replay`), so the readers of every such span and
record see the prefill's work as the eager prefill shows it. A replayed
`moe.routed` record counts the bucket's tokens: the work the card does.
"""
from __future__ import annotations

import torch

from .. import telemetry as T
from ..configs.base import ModelConfig
from ..core import events as E
from ..device import tracing
from ..models import registry as MR
from . import graph_capture as GC

LADDER = (16, 24, 32, 48, 64, 96, 128, 192, 256, 384, 512, 768, 1024,
          1536, 2048)
CUT_SPANS = ("moe.routed", "ssm.mixer")


def buckets(max_seq: int) -> tuple:
    """The padded lengths captured for an engine of `max_seq` positions."""
    top = min(max_seq, LADDER[-1])
    return tuple(b for b in LADDER if b < top) + (top,)


def bucket(n: int, max_seq: int) -> int | None:
    """The least bucket of `buckets(max_seq)` that holds n tokens; None past
    the largest."""
    return next((b for b in buckets(max_seq) if b >= n), None)


def engages(cfg: ModelConfig, cache) -> bool:
    """Whether the graphed prefill runs: the engine's cache is on a CUDA
    device, the config's padded prefill is capturable
    (`registry.prefill_capturable`), and nothing is being traced for
    export or counting."""
    return (cache["pos"].is_cuda and not tracing()
            and MR.prefill_capturable(cfg))


class PrefillGraphs:
    """The graphed batch-1 prefills of one engine over `params` (see the
    module's docstring): the static buffers are made here, every bucket
    is captured by `capture_all`, and a call replays."""

    def __init__(self, cfg: ModelConfig, max_seq: int, params, device):
        self.cfg, self.max_seq, self.params = cfg, max_seq, params
        self.device = device
        self.buckets = buckets(max_seq)
        self.graphs: dict = {}       # bucket -> [(graph, span, records)]
        # the tokens (one bucket's worth read by its graph), then the length
        self.inp = torch.zeros(self.buckets[-1] + 1, dtype=torch.int64,
                               device=device)
        self.staging = MR.make_cache(cfg, 1, max_seq, torch.float32, device)
        self.row = torch.empty(1, cfg.padded_vocab, dtype=torch.float32,
                               device=device)

    def bucket(self, n: int) -> int | None:
        return bucket(n, self.max_seq)

    def __call__(self, prompt: list):
        """(the logits row f32 [1, padded vocab] at the prompt's last
        position, the staging cache holding its prefill with its length);
        both are overwritten by the next call. The prompt fits a bucket,
        which `capture_all` has captured."""
        b = self.bucket(len(prompt))
        segments = self.graphs[b]
        T.count("serve.prefill_graph", ("replay", b))
        self.load(prompt)
        for segment in segments:
            GC.replay(*segment)
        return self.row, self.staging

    def load(self, prompt: list):
        """The prompt, right-padded with id 0, and its length into the
        token buffer, in one copy from the host."""
        n = len(prompt)
        self.inp.copy_(torch.tensor(prompt + [0] * (len(self.inp) - 1 - n)
                                    + [n]))

    def _work(self, b: int):
        """The prefill of bucket b over the static buffers (`load`): what
        its graph holds."""
        length = self.inp[-1:]
        self.staging["pos"].zero_()
        with E.Collector.suspended():
            logits, _ = MR.prefill_fn(
                self.params, {"tokens": self.inp[None, :b], "length": length},
                self.staging, self.cfg)
        self.row.copy_(logits[0].index_select(0, (length - 1).clamp_min(0)))

    def capture_all(self):
        """One eager warm pass of the largest bucket on a side stream, then
        every bucket's capture there, the largest first."""
        dev = self.device
        pool = torch.cuda.graph_pool_handle()
        stream = torch.cuda.Stream(dev)
        stream.wait_stream(torch.cuda.current_stream(dev))
        with torch.cuda.stream(stream), torch.no_grad():
            self.inp[-1] = 1                 # a length for the warm pass
            self._work(self.buckets[-1])
            GC.settle(dev)
            for b in reversed(self.buckets):
                T.count("serve.prefill_graph", ("capture", b))
                cap = GC.Capture(pool)
                with T.cut_at(CUT_SPANS, cap.cut):
                    GC.capture(cap, lambda: self._work(b))
                self.graphs[b] = [(graph, name, records) for
                                  graph, _, name, records in cap.segments]
        torch.cuda.current_stream(dev).wait_stream(stream)
