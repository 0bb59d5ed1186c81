"""Serving steps with the probe stage inside (instrumented serving --
per-request latency/step histograms via eBPF maps without leaving the
device)."""
from __future__ import annotations

import contextlib

import torch

from .. import telemetry as T
from ..configs.base import ModelConfig
from ..core import events as E, jit as J
from ..models import registry as MR
from . import decode_graph as DG


def make_decode_step(cfg: ModelConfig, runtime=None, probe_mode=None, *,
                     graphs: bool = False):
    """The decode step. It keeps the last step's event tape and the map
    state it started from on `decode_step.last` (rows, maps_in, step,
    table_gen), so a caller can replay the tape through another probe mode.
    table_gen is the generation of the live table the step ran (None
    without the live lane): a later `sync_live_table` writes the table in
    maps_in in place, and `runtime.live_table_at(table_gen, device)` gives
    back the one the step ran.

    graphs=True is for a caller that passes back the cache the step
    returned (`ServeEngine`): where `decode_graph.engages`, the model's
    work is replayed from CUDA graphs over two caches the step owns, and
    the step never writes the cache it is given (`serve/decode_graph.py`).
    The keyed record `decode.graph` counts each call as "capture",
    "replay" or "eager"."""
    wanted = runtime.wanted_sites() if runtime else set()
    graphed = DG.DecodeGraphs(cfg, wanted, runtime is not None) \
        if graphs else None

    def decode_step(params, tokens, cache, maps, step: int):
        """tokens [B,1] int; returns (next_token [B], logits, cache, maps)."""
        with T.span("decode.step"):
            col = E.Collector(wanted) if runtime else None
            with T.span("decode.model"), \
                    col if col is not None else contextlib.nullcontext():
                if graphed is not None and DG.engages(cfg, cache):
                    logits, cache = graphed(params, tokens, cache, col)
                else:
                    T.count("decode.graph", "eager")
                    logits, cache = MR.decode_fn(params, tokens, cache,
                                                 cfg)
                if col is not None:
                    E.probe_site("decode.logits", logits)
                    rows = col.take_all_rows(tokens.device)
            with T.span("decode.sample"):
                # mask vocab padding before argmax (argmax takes the first
                # maximum)
                if cfg.padded_vocab > cfg.vocab_size:
                    logits = logits.clone()
                    logits[..., cfg.vocab_size:] = float("-inf")
                nxt = torch.argmax(logits[:, -1], dim=-1).to(torch.int32)
            decode_step.last = None
            if runtime is not None and rows.shape[0] > 0:
                aux = J.make_aux(time_ns=step, device=tokens.device)
                rows[:, 3] = step
                decode_step.last = (rows, maps, step,
                                    runtime.table_generation)
                with T.span("probe.stage"):
                    maps, aux = runtime.probe_stage(rows, maps, aux,
                                                    mode=probe_mode)
        return nxt, logits, cache, maps

    decode_step.last = None
    return decode_step


def make_prefill_step(cfg: ModelConfig, runtime=None):
    """The prefill step: `registry.prefill_fn` under the runtime's
    collector, then the probe stage over its events (the encoder's sites
    fire only here). Like the decode step it keeps its last event tape
    and the map state it started from on `prefill_step.last` (rows,
    maps_in, step 0, table_gen)."""
    wanted = runtime.wanted_sites() if runtime else set()

    def prefill_step(params, batch, cache, maps):
        """batch: tokens (+ enc_embeds | embeds/positions); returns
        (logits, cache, maps)."""
        col = E.Collector(wanted) if runtime else None
        with col if col is not None else contextlib.nullcontext():
            logits, cache = MR.prefill_fn(params, batch, cache, cfg)
            if col is not None:
                rows = col.take_all_rows(batch["tokens"].device)
        prefill_step.last = None
        if runtime is not None and rows.shape[0] > 0:
            aux = J.make_aux(device=rows.device)
            prefill_step.last = (rows, maps, 0, runtime.table_generation)
            maps, aux = runtime.probe_stage(rows, maps, aux)
        return logits, cache, maps

    prefill_step.last = None
    return prefill_step
