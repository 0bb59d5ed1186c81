"""A serving cell: the port's ServeEngine with the family's serving probes
on the fused lane and the admission filter, kept full by a closed loop,
timed from the outside.

The engine's decode callable is wrapped: each call is one engine
iteration (refills with their prefills, then the batched decode, its
probe stage and the engine's own sync), so the host's timestamps give
every token's emission time: a prefill's first token when the prefill
returns (it ends in its own sync), a decode token when its iteration's
device work has ended. The window opens at the end of iteration
`warm_iterations` and closes at the first iteration that would start
after `--seconds`: the wrapper raises, and only tokens emitted inside the
window count.

Then the check: a sample of finished requests, drawn from the seed with
the longest among them, goes through the plain reference, and every
served token's logit is held against the reference's best at its
position; the probe maps are held against what the programs must have
counted; admission must have let every request in."""
from __future__ import annotations

import contextlib
import math

import numpy as np
import torch

from . import cell as C, pattern as P, traffic as TR, weights as W


class WindowClosed(Exception):
    pass


class _Decode:
    """The engine's decode callable, timed. Attribute reads (the engine
    reads `.last`) go to the wrapped function."""

    def __init__(self, rec, fn):
        self._rec, self._fn = rec, fn

    def __getattr__(self, name):
        return getattr(self._fn, name)

    def __call__(self, *args):
        return self._rec.decode(self._fn, *args)


class Recorder:
    def __init__(self, engine, device, seconds, warm, trace_iters=0,
                 faults=()):
        self.engine, self.device = engine, device
        self.seconds, self.warm, self.trace_iters = seconds, warm, trace_iters
        self.faults = faults
        self.emissions: dict[int, list] = {}
        self.iteration = 0
        self.prev = None                   # (end time, [(rid, pos)])
        self.start = self.deadline = None
        self.tracing = None                # (profiling.Window, ExitStack)
        self.trace = None
        self.decode_positions: list = []
        self.prefills: list = []
        self._prefill = engine._prefill_slot
        engine._prefill_slot = self.prefill
        engine._decode = _Decode(self, engine._decode)

    def _range(self, label):
        if self.tracing is None:
            return contextlib.nullcontext()
        return torch.profiler.record_function("portbench." + label)

    def prefill(self, slot, req):
        with self._range("prefill_slot"):
            out = self._prefill(slot, req)
        t = C.now()
        self.emissions.setdefault(req.rid, []).append(t)
        if self.tracing is not None:
            self.prefills.append(len(req.prompt))
        return out

    def decode(self, fn, params, tokens, cache, maps, step):
        if self.prev is not None:
            end, active = self.prev
            for rid, _ in active:
                self.emissions[rid].append(end)
        i = self.iteration
        if i == self.warm:
            self.start = self.prev[0] if self.prev else C.now()
            self.deadline = self.start + self.seconds
            if self.trace_iters:
                self._start_trace()
        if self.tracing is not None and i == self.warm + self.trace_iters:
            self._stop_trace()
        if self.deadline is not None and C.now() > self.deadline:
            raise WindowClosed
        active = [(r.rid, len(r.prompt) + len(r.out) - 1)
                  for r in self.engine.active if r is not None]
        if self.tracing is not None:
            self.decode_positions.append([p for _, p in active])
        if "stale_state" in self.faults:
            # the step hands back the cache it was given
            with self._range("decode"):
                nxt, logits, _, maps = fn(params, tokens, cache, maps, step)
            out = (nxt, logits, cache, maps)
        else:
            with self._range("decode"):
                out = fn(params, tokens, cache, maps, step)
        out = self._fault(out)
        C.sync(self.device)
        self.prev = (C.now(), active)
        self.iteration += 1
        return out

    def _fault(self, out):
        nxt = out[0]
        if "alter_token" in self.faults:
            # every decoded token is replaced by the next id
            nxt = (nxt + 1) % self.engine.cfg.vocab_size
        if "half_batch" in self.faults:
            # the second half of the slots is never decoded: each repeats
            # the token it was given
            nxt = nxt.clone()
            h = nxt.shape[0] // 2
            toks = [r.out[-1] if r is not None and r.out else 0
                    for r in self.engine.active]
            nxt[h:] = torch.tensor(toks[h:], dtype=nxt.dtype,
                                   device=nxt.device)
        return (nxt,) + tuple(out[1:])

    def _start_trace(self):
        from repro_torch.core import events as E
        from repro_torch.core.runtime import BpftimeRuntime
        from repro_torch.models import ssm
        from . import profiling as P
        stack = contextlib.ExitStack()
        stack.enter_context(P.ranged({
            "emit": (E.Collector, "emit_tensor_event"),
            "probe_stage": (BpftimeRuntime, "probe_stage"),
            "ssd_chunked": (ssm, "ssd_chunked")}))
        stack.enter_context(probe_byte_counter(self))
        self.probe_bytes = 0
        win = P.Window()
        self.tracing = (win, stack)
        win.start()

    def _stop_trace(self):
        win, stack = self.tracing
        self.trace = win.stop()
        stack.close()
        self.tracing = None


@contextlib.contextmanager
def probe_byte_counter(rec):
    """Adds the bytes each probe kernel launch must move to
    rec.probe_bytes while the block runs."""
    from repro_torch.kernels import hash_update, ringbuf_emit, tensor_stats
    from .counts import probes as PB
    targets = [(tensor_stats, "tensor_stats_row_cuda", PB.tensor_stats_row),
               (hash_update, "hash_fetch_add_batch_cuda",
                PB.hash_fetch_add_batch),
               (ringbuf_emit, "ringbuf_emit_batch_cuda",
                PB.ringbuf_emit_batch)]
    saved = [getattr(mod, n) for mod, n, _ in targets]

    def wrap(fn, count):
        def inner(*args, **kwargs):
            rec.probe_bytes += count(*args[:count.__code__.co_argcount])
            return fn(*args, **kwargs)
        return inner
    for (mod, n, count), fn in zip(targets, saved):
        setattr(mod, n, wrap(fn, count))
    try:
        yield
    finally:
        for (mod, n, _), fn in zip(targets, saved):
            setattr(mod, n, fn)


def build(cell: C.Cell, seed: int, device):
    """The engine (with its runtime) on seed `seed`'s weights, and the
    request pool."""
    from repro_torch.configs.base import ModelConfig
    from repro_torch.core.runtime import BpftimeRuntime
    from repro_torch.launch import serve as L
    from repro_torch.serve.engine import Request, ServeEngine
    tr, m = cell.traffic, cell.config["model"]
    cfg = ModelConfig(**m)
    pool = TR.serve_requests(tr, cell.config, seed)
    longest = max(len(r["prompt"]) for r in pool)
    if tr["admit_limit"] < longest:
        raise ValueError(f"admit_limit {tr['admit_limit']} would reject "
                         f"prompts of {longest} tokens")
    rt = BpftimeRuntime()
    pid = rt.load_asm("admit", L.admit_filter_text(tr["admit_limit"]), [],
                      "filter")
    rt.attach(pid, "filter:sys_serve_admit")
    L.attach_serve_probes(rt, L.family_probes(cfg))
    params = W.make_params(seed, cell.config, device)
    engine = ServeEngine(params, cfg, slots=tr["slots"],
                         max_seq=tr["max_seq"], runtime=rt, device=device)
    reqs = [Request(rid=r["rid"], prompt=r["prompt"], max_new=r["max_new"])
            for r in pool]
    return engine, reqs, params


def run(cell: C.Cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, faults=()):
    """One run: (Run record, the numbers the check compares, attempted,
    failed). faults: names of faults planted in the timed path (the
    benchmark's own test of its check), and "control" to read the float8
    reference's gap beside the program's ("logit_gap_control")."""
    from repro_torch.core.runtime import to_numpy
    from repro_torch.launch import serve as L
    tr = cell.traffic
    engine, reqs, params = build(cell, seed, device)
    rec = Recorder(engine, device, seconds, tr["warm_iterations"],
                   tr["trace_iterations"] if trace else 0, faults)
    try:
        engine.submit_all(reqs)
    except WindowClosed:
        if rec.tracing is not None:          # a window shorter than the trace
            rec._stop_trace()
    else:
        raise RuntimeError("the request pool ran out before the window "
                           "closed: make the mix's pool larger")
    C.sync(device)
    run = C.Run(mode="serve", config=cell.config, traffic=tr,
                setup_s=rec.start - t_start,
                window=(rec.start, rec.deadline), trace=rec.trace,
                emissions=rec.emissions,
                traced_decode_positions=rec.decode_positions,
                traced_prefills=rec.prefills,
                probe_bytes=getattr(rec, "probe_bytes", 0))
    if device.type == "cuda":
        run.peak_bytes = torch.cuda.max_memory_allocated(device)
    maps = to_numpy(engine.maps)
    steps, events = engine.step_count, engine.events
    probes = {p[2][0]: (p[2][1], p[3]) for p in L.family_probes(engine.cfg)}
    rejected = sum(r.rejected for r in reqs)
    started = [r for r in reqs if r.out]
    unaccounted = sum(abs(len(r.out) - len(rec.emissions.get(r.rid, [])))
                      for r in reqs)
    del engine
    if device.type == "cuda":
        torch.cuda.empty_cache()
    values = {"rejected": rejected, "tokens_unaccounted": unaccounted}
    values.update(map_errors(maps, probes, steps, cell.config))
    values["events_per_step_error"] = abs(
        events - steps * events_per_step(probes, cell.config))
    done = [r for r in reqs if r.done and not r.rejected]
    sample = pick_sample(done, seed, tr["check_tokens"])
    # the float8 control, and reference precisions read beside the program
    # ("reference:<precision>", calibrate.py's stand-ins)
    others = {"logit_gap_control": "float8"} if "control" in faults else {}
    others.update({f"logit_gap_{f[10:]}": f[10:] for f in faults
                   if f.startswith("reference:")})
    gaps = served_gaps(params, cell.config, sample, device,
                       set(others.values()))
    values["logit_gap"] = max(gaps["served"], default=float("nan"))
    values["served_tokens_checked"] = len(gaps["served"])
    for key, precision in others.items():
        values[key] = max(gaps[precision], default=float("nan"))
    return run, values, len(started) + rejected, rejected


def events_per_step(probes: dict, config: dict) -> int:
    """Event rows a decode step collects: the events of every site a
    probe is attached at (`probes`: map name -> (kind, site))."""
    return sum(math.prod(P.site_layout(config, t))
               for t in {t for _, t in probes.values()})


def map_errors(maps: dict, probes: dict, steps: int, config: dict) -> dict:
    """Entries of the serving maps that differ from what `steps` probed
    decode steps must leave (reference/probes.py). A map the
    configuration's "map_expect" names must hold that number: an ARRAY or
    HASH map at key 0 and nothing elsewhere, a histogram in all, a ring
    as its records; one the run does not produce counts as one counter
    entry in error. Every other map is held by its site's events
    (pattern.site_layout): a counter (ARRAY or HASH keyed by the event's
    layer id) holds `steps` times the events at each id of its site, a
    histogram one entry an event, a ring one record an event."""
    from .reference import probes as RP
    expect = config.get("map_expect", {})
    out = {"counter_errors": sum(1 for name in expect if name not in maps),
           "hist_count_error": 0, "ring_head_error": 0}
    for name, (kind, site) in probes.items():
        ids, per_id = P.site_layout(config, site)
        if name in expect:
            ids, per_id, total = 1, expect[name], expect[name]
        else:
            per_id, total = steps * per_id, steps * ids * per_id
        if kind in ("array", "hash"):
            out["counter_errors"] += RP.counter_errors(maps[name], per_id,
                                                       ids, kind)
        elif kind == "log2hist":
            out["hist_count_error"] += RP.hist_total_error(maps[name], total)
        elif kind == "ringbuf":
            out["ring_head_error"] += RP.ring_head_error(maps[name], total)
        else:
            raise ValueError(f"no expectation for a {kind} map ({name})")
    return out


def pick_sample(done: list, seed: int, tokens: int) -> list:
    """The finished request with the most served tokens, then others in an
    order drawn from the seed, until `tokens` served tokens."""
    if not done:
        return []
    rng = np.random.default_rng(seed + 1)
    longest = max(done, key=lambda r: (len(r.out), len(r.prompt)))
    rest = [r for r in done if r is not longest]
    order = [rest[i] for i in rng.permutation(len(rest))]
    out, n = [longest], len(longest.out)
    for r in order:
        if n >= tokens:
            break
        out.append(r)
        n += len(r.out)
    return out


def served_gaps(params, config: dict, sample: list, device,
                others=()) -> dict:
    """For every served token of the sample, how far the reference's
    logit of it lies below the reference's best at its position
    ("served"); for each precision of `others` (reference/lowp.py), the
    same for the token the reference in that precision puts first there.
    The sample goes through the reference `CHECK_BATCH` sequences at a
    time (0: all at once)."""
    from . import reference as R
    from .reference.lowp import PRECISIONS
    m = config["model"]
    ref = R.model(config["reference"])
    V = m["vocab_size"]
    out = {"served": [], **{p: [] for p in others}}
    if not sample:
        return out
    n = ref.CHECK_BATCH or len(sample)
    with torch.no_grad(), R.exact_float32():
        for g0 in range(0, len(sample), n):
            group = sample[g0:g0 + n]
            seqs = [r.prompt + r.out[:-1] for r in group]
            T = max(len(s) for s in seqs)
            toks = torch.zeros(len(seqs), T, dtype=torch.int64)
            for i, s in enumerate(seqs):
                toks[i, :len(s)] = torch.tensor(s)
            toks = toks.to(device)
            logits = {p: ref.forward(params, toks, m, PRECISIONS[p])
                      for p in ("float32", *others)}
            for i, r in enumerate(group):
                pos = torch.arange(len(r.prompt) - 1,
                                   len(r.prompt) + len(r.out) - 1,
                                   device=device)
                lf = logits["float32"][i, pos, :V]
                best = lf.max(-1).values
                served = torch.tensor(r.out, device=device)
                out["served"] += (best - lf.gather(
                    1, served[:, None])[:, 0]).tolist()
                for p in others:
                    pick = logits[p][i, pos, :V].argmax(-1)
                    out[p] += (best - lf.gather(1, pick[:, None])[:, 0]
                               ).tolist()
            del logits
    return out
