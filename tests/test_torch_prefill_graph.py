"""The serving loop's batch-1 prefill replayed from CUDA graphs
(`repro_torch/serve/prefill_graph.py`).

On the CPU: the bucket ladder; which configs engage; the right-padded
prefill with its real length against the prompt alone (first token, cache
rows, conv and SSM state, last logits), through `registry.prefill_fn` and
through the work a bucket's graph holds; the capture's cuts at the
`moe.routed` and `ssm.mixer` spans; the engine's prefills, eager on the
CPU, and served from stand-in graphs that run each bucket's work eagerly.
On the card (marked `cuda`, skipping without one; this file imports no
JAX): each bucket's replay against its eager work, bit for bit; granite's
replayed spans and records; the engine with graphs against the engine
whose prefills run the same padded shapes eagerly:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_prefill_graph.py
"""
import collections
import contextlib
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch import device as D, telemetry as T  # noqa: E402
from repro_torch.configs import registry as TCFG  # noqa: E402
from repro_torch.core import events as E  # noqa: E402
from repro_torch.core.runtime import BpftimeRuntime  # noqa: E402
from repro_torch.launch import serve as L  # noqa: E402
from repro_torch.models import registry as MR  # noqa: E402
from repro_torch.serve import graph_capture as GC  # noqa: E402
from repro_torch.serve import prefill_graph as PG  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402

ARCHS = ["qwen2-0.5b", "granite-4.0-h-small", "mamba2-780m"]
CAPTURED = ARCHS + ["starcoder2-15b", "llama3.2-1b"]
EAGER = ["llama4-scout-17b-a16e", "kimi-k2-1t-a32b", "jamba-v0.1-52b",
         "qwen2-vl-72b", "seamless-m4t-medium"]
# the port's CPU tolerance for one forward in f32 (`test_torch_serve.py`)
TOL = 1e-4


def _prompt(cfg, n, seed=0):
    g = torch.Generator().manual_seed(1000 + n + seed)
    return torch.randint(0, cfg.vocab_size, (n,), generator=g).tolist()


def _alone(params, cfg, prompt, max_seq):
    """(last logits [V], cache) of the prompt prefilled alone."""
    c = MR.make_cache(cfg, 1, max_seq, torch.float32, "cpu")
    logits, c = MR.prefill_fn(params, {"tokens": torch.tensor([prompt])}, c,
                              cfg)
    return logits[0, -1], c


def _assert_same_prefill(cfg, got_last, got, want_last, want, n):
    """The same first token; within TOL the cache rows [0, n), the conv
    and SSM state and the last logits; the same length."""
    V = cfg.vocab_size
    assert int(got_last[:V].argmax()) == int(want_last[:V].argmax())
    torch.testing.assert_close(got_last, want_last, rtol=TOL, atol=TOL)
    for g, w in zip(got["blocks"], want["blocks"]):
        assert sorted(g) == sorted(w)
        for f in w:
            rows = (slice(None), slice(None), slice(0, n)) \
                if f in ("k", "v") else (slice(None),)
            torch.testing.assert_close(g[f][rows], w[f][rows], rtol=TOL,
                                       atol=TOL)
    assert got["pos"].tolist() == want["pos"].tolist() == [n]


def _config(arch, chunk):
    cfg = TCFG.smoke(arch)
    return dataclasses.replace(cfg, ssm_chunk=chunk) if chunk else cfg


# ------------------------------------------------------------------ CPU

@pytest.mark.parametrize("max_seq", [8, 48, 100, 128, 2048, 4096, 32768])
def test_bucket_ladder(max_seq):
    """Rising buckets, the last min(max_seq, 2048), none past it; every
    length from 16 to the last padded by at most half of it, to the least
    bucket that holds it; none past the last."""
    bs = PG.buckets(max_seq)
    top = min(max_seq, 2048)
    assert list(bs) == sorted(set(bs)) and bs[-1] == top
    assert set(bs) - {top} <= set(PG.LADDER)
    for n in range(1, top + 1):
        b = PG.bucket(n, max_seq)
        assert b in bs and b >= n
        assert all(c < n for c in bs if c < b)
        if n >= 16:
            assert b <= 1.5 * n
    assert PG.bucket(top + 1, max_seq) is None
    if max_seq >= 2048:
        assert bs == PG.LADDER


@pytest.mark.parametrize("arch", CAPTURED + EAGER)
def test_prefill_capturable_by_family(arch):
    """Where the decode is capturable and every MoE layer is dropless: not
    a capacity MoE, M-RoPE, or the encoder-decoder."""
    for cfg in (TCFG.get(arch), TCFG.smoke(arch)):
        assert MR.prefill_capturable(cfg) == (arch in CAPTURED)


def test_a_capacity_moe_is_not_captured():
    cfg = TCFG.smoke("granite-4.0-h-small")
    assert MR.prefill_capturable(cfg) and MR.decode_capturable(cfg)
    capacity = dataclasses.replace(cfg, moe_dropless=False)
    assert MR.decode_capturable(capacity)
    assert not MR.prefill_capturable(capacity)


def test_engages_on_a_cuda_cache_outside_tracing(monkeypatch):
    cuda_like = {"pos": type("P", (), {"is_cuda": True})()}
    cfg = TCFG.smoke("granite-4.0-h-small")
    cpu = MR.make_cache(cfg, 2, 8, torch.float32, "cpu")
    assert PG.engages(cfg, cuda_like)
    assert not PG.engages(cfg, cpu)
    for arch in EAGER:
        assert not PG.engages(TCFG.smoke(arch), cuda_like)
    monkeypatch.setattr(D, "TRACING", True)
    assert not PG.engages(cfg, cuda_like)


# each config at its smoke SSD chunk (2), and those with SSM layers at a
# chunk of 6 too, ragged in the padded prefill as well
CHUNKS = [(a, c) for a in ARCHS for c in (None, 6)
          if c is None or a != "qwen2-0.5b"]


# under an edge, at one, inside the next (odd: a ragged SSD chunk at the
# smoke chunk)
@pytest.mark.parametrize("n", [15, 16, 21])
@pytest.mark.parametrize("arch,chunk", CHUNKS)
def test_padded_prefill_gives_the_prompt_alone(arch, chunk, n):
    """`prefill_fn` on the prompt right-padded to its bucket with id 0 and
    its real length: what the prompt alone gives."""
    cfg = _config(arch, chunk)
    params = MR.init_params(cfg, torch.Generator().manual_seed(3), "cpu")
    prompt = _prompt(cfg, n)
    b = PG.bucket(n, 48)
    want_last, want = _alone(params, cfg, prompt, 48)
    toks = torch.tensor([prompt + [0] * (b - n)])
    c = MR.make_cache(cfg, 1, 48, torch.float32, "cpu")
    logits, got = MR.prefill_fn(params, {"tokens": toks, "length":
                                         torch.tensor([n])}, c, cfg)
    assert logits.shape[1] == b
    _assert_same_prefill(cfg, logits[0, n - 1], got, want_last, want, n)


@pytest.mark.parametrize("arch", ARCHS)
def test_the_prefill_writes_the_cache_it_is_given(arch):
    """`prefill_fn` writes its new cache into the cache it is given and
    returns that cache: the same tensors, holding the prompt alone's."""
    cfg = TCFG.smoke(arch)
    params = MR.init_params(cfg, torch.Generator().manual_seed(2), "cpu")
    prompt = _prompt(cfg, 21)
    want_last, want = _alone(params, cfg, prompt, 48)
    c = MR.make_cache(cfg, 1, 48, torch.float32, "cpu")
    given = E._tree_leaves(c)
    logits, got = MR.prefill_fn(params, {"tokens": torch.tensor([prompt])},
                                c, cfg)
    assert got is c
    assert all(a is b for a, b in zip(E._tree_leaves(got), given))
    _assert_same_prefill(cfg, logits[0, -1], got, want_last, want, 21)


@pytest.mark.parametrize("arch,chunk", CHUNKS)
def test_a_buckets_work_gives_the_prompt_alone(arch, chunk):
    """The work a bucket's graph holds (`PrefillGraphs._work`, eager on the
    CPU), over one staging cache in turn for prompts of several lengths,
    longest first so that shorter ones leave stale rows past their
    length: each time the logits row and the staging cache give what the
    prompt alone gives."""
    cfg = _config(arch, chunk)
    params = MR.init_params(cfg, torch.Generator().manual_seed(4), "cpu")
    g = PG.PrefillGraphs(cfg, 48, params, "cpu")
    for n in (47, 33, 16, 15, 5, 1):
        prompt = _prompt(cfg, n, seed=1)
        g.load(prompt)
        g._work(g.bucket(n))
        want_last, want = _alone(params, cfg, prompt, 48)
        _assert_same_prefill(cfg, g.row[0], g.staging, want_last, want, n)


def test_a_cut_capture_holds_one_span_a_segment():
    """granite's work, run as a capture is cut (`telemetry.cut_at`): every
    segment that opened a span opened one, a `moe.routed` or `ssm.mixer`;
    the segments' spans and records are the uncut run's, in order, and
    each `moe.routed` record counts the bucket's tokens."""
    cfg = TCFG.smoke("granite-4.0-h-small")
    params = MR.init_params(cfg, torch.Generator().manual_seed(5), "cpu")
    g = PG.PrefillGraphs(cfg, 48, params, "cpu")
    g.load(_prompt(cfg, 20))
    T.notes_begin()
    g._work(32)
    whole = T.notes_end()
    segments = []

    def cut():
        segments.append(T.notes_end())
        T.notes_begin()

    T.notes_begin()
    with T.cut_at(PG.CUT_SPANS, cut):
        g._work(32)
    segments.append(T.notes_end())
    assert [n for s in segments for n in s] == whole
    names = [[n[1] for n in s if n[0] == "span"] for s in segments]
    assert all(len(s) <= 1 for s in names)
    opened = collections.Counter(s[0] for s in names if s)
    mixers = sum(cfg.block_kind(i) == "mamba" for i in range(cfg.num_layers))
    assert opened == {"ssm.mixer": mixers, "moe.routed": cfg.num_layers}
    routed = [n for n in whole if n[:2] == ("count", "moe.routed")]
    assert len(routed) == cfg.num_layers
    assert {n[2][4] for n in routed} == {32}


def test_a_cut_span_cuts_where_it_opens_and_closes():
    """A span named in `cut_at` cuts as it opens, notes itself in the new
    graph's notes, opens no range, cuts as it closes; an exception leaving
    it cuts no more; other spans do not cut."""
    calls = []
    T.notes_begin()
    with T.recording(), T.cut_at({"a"}, lambda: calls.append(T.notes_end())
                                  or T.notes_begin()):
        with T.span("b"):
            pass
        with T.span("a") as opened:
            T.count("r", 1)
        assert opened is None
        with pytest.raises(ValueError):
            with T.span("a"):
                raise ValueError
    rest = T.notes_end()
    assert calls == [[("span", "b")], [("span", "a"), ("count", "r", 1, 1)],
                     []]
    assert rest == [("span", "a")]
    with T.span("a") as outside:
        assert outside is None
    assert len(calls) == 3


def test_a_replayed_segment_opens_its_span_and_counts_its_records(
        monkeypatch):
    """`graph_capture.replay`: the graph replayed inside a span of the
    segment's name, then its records counted; no span without a name."""
    opened, seen = [], []
    span = T.span

    @contextlib.contextmanager
    def noted(name):
        opened.append(name)
        with span(name):
            yield
        opened.append("/" + name)

    class Graph:
        def replay(self):
            seen.append(list(opened))

    monkeypatch.setattr(T, "span", noted)
    with T.recording():
        GC.replay(Graph(), "moe.routed", [("moe.routed", ("a", 32), 1),
                                          ("r", 7, 2)])
        GC.replay(Graph(), None, [("r", 7, 1)])
        keyed = T.records()["keyed"]
    assert seen == [["moe.routed"], ["moe.routed", "/moe.routed"]]
    assert opened == ["moe.routed", "/moe.routed"]
    assert keyed == {"moe.routed": {("a", 32): 1}, "r": {7: 3}}


def _runtime(cfg):
    rt = BpftimeRuntime()
    L.attach_serve_probes(rt, L.family_probes(cfg))
    return rt


def _requests(cfg, lens=(5, 17, 3, 30, 12, 9, 40)):
    return [Request(rid=i, prompt=_prompt(cfg, n, seed=i),
                    max_new=3 + i % 3) for i, n in enumerate(lens)]


def _maps(maps):
    return [t for m in sorted(maps) for f, t in sorted(maps[m].items())]


class _Eager:
    """A stand-in for a bucket's graph: its replay runs the bucket's work
    eagerly."""

    def __init__(self, graphs, b):
        self.graphs, self.b = graphs, b

    def replay(self):
        self.graphs._work(self.b)


def _eager_capture(self):
    """`PrefillGraphs.capture_all` with stand-in graphs: the same padded
    shapes, run eagerly."""
    for b in self.buckets:
        self.graphs[b] = [(_Eager(self, b), None, [])]


@pytest.mark.parametrize("arch", ARCHS + ["llama4-scout-17b-a16e"])
@pytest.mark.parametrize("tracing", [False, True])
def test_engine_prefills_eagerly_on_the_cpu(arch, tracing, monkeypatch):
    """On the CPU, under `device.tracing()` and for a config the predicate
    excludes, every prefill runs eagerly, counted ("eager", 0), and no
    graphs are built."""
    cfg = TCFG.smoke(arch)
    params = MR.init_params(cfg, torch.Generator().manual_seed(6), "cpu")
    engine = ServeEngine(params, cfg, slots=2, max_seq=48,
                         runtime=_runtime(cfg), device="cpu")
    monkeypatch.setattr(D, "TRACING", tracing)
    reqs = _requests(cfg)
    with T.recording():
        engine.submit_all(reqs)
    assert T.records()["keyed"]["serve.prefill_graph"] == {
        ("eager", 0): len(reqs)}
    assert engine._prefill_graphs is None


@pytest.mark.parametrize("arch", ARCHS)
def test_engine_serves_the_same_from_padded_prefills(arch, monkeypatch):
    """An engine whose prefills go through `PrefillGraphs` with stand-in
    graphs (the padded work, eager) against the engine of eager
    prefills: the same tokens, events and maps; every prefill counted a
    replay of its bucket, none captured at a prefill."""
    cfg = TCFG.smoke(arch)
    params = MR.init_params(cfg, torch.Generator().manual_seed(7), "cpu")
    lens = (5, 17, 3, 30, 12, 9, 40, 47)
    served = []
    for graphs in (False, True):
        with monkeypatch.context() as mp:
            if graphs:
                mp.setattr(PG, "engages", lambda cfg, cache: True)
                mp.setattr(PG.PrefillGraphs, "capture_all", _eager_capture)
            engine = ServeEngine(params, cfg, slots=3, max_seq=48,
                                 runtime=_runtime(cfg), device="cpu")
            reqs = _requests(cfg, lens)
            with T.recording():
                engine.submit_all(reqs)
            served.append(([r.out for r in reqs], engine.events,
                           _maps(engine.maps),
                           T.records()["keyed"]["serve.prefill_graph"]))
    (out_e, ev_e, maps_e, n_e), (out_g, ev_g, maps_g, n_g) = served
    assert out_g == out_e
    assert ev_g == ev_e > 0
    assert all(torch.equal(a, b) for a, b in zip(maps_e, maps_g))
    assert n_e == {("eager", 0): len(lens)}
    assert n_g == collections.Counter(("replay", PG.bucket(n, 48))
                                      for n in lens)


# ------------------------------------------------------------------ card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs run only on the card")
    return torch.device("cuda")


def _card_config(arch):
    """The smoke config in bf16 compute, as the serving cells run; "-full":
    the published widths."""
    if arch.endswith("-full"):
        return TCFG.get(arch[:-5])
    return dataclasses.replace(TCFG.smoke(arch), dtype="bfloat16")


def _leaves(tree):
    return [t.clone() for t in E._tree_leaves(tree)]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS + ["qwen2-0.5b-full"])
def test_replay_matches_the_eager_padded_prefill(cuda, arch):
    """Every bucket captured before the first prefill; then each bucket's
    replay against its work run eagerly on the same inputs: the logits
    row and the whole staging cache bit for bit; every call a replay."""
    cfg = _card_config(arch)
    max_seq = 2048 if arch.endswith("-full") else 64
    params = MR.init_params(cfg, torch.Generator(cuda).manual_seed(8), cuda)
    served = MR.serving_params(params, cfg)
    g = PG.PrefillGraphs(cfg, max_seq, served, cuda)
    g.capture_all()
    assert sorted(g.graphs) == list(g.buckets)
    with T.recording():
        for b in g.buckets:
            prompt = _prompt(cfg, max(1, b - 3), seed=b)
            row, staging = g(prompt)
            got = (row.clone(), _leaves(staging))
            g.load(prompt)
            with torch.no_grad():
                g._work(b)
            assert torch.equal(got[0], g.row), b
            assert all(torch.equal(x, y) for x, y in
                       zip(got[1], E._tree_leaves(g.staging))), b
            assert int(g.staging["pos"][0]) == len(prompt)
        counts = dict(T.records()["keyed"]["serve.prefill_graph"])
    assert counts == {("replay", b): 1 for b in g.buckets}


@pytest.mark.cuda
def test_granite_replay_spans_and_records(cuda, monkeypatch):
    """granite's replay opens as many `moe.routed` and `ssm.mixer` spans,
    and counts the same `moe.routed` records, as its eager work."""
    cfg = _card_config("granite-4.0-h-small")
    params = MR.init_params(cfg, torch.Generator(cuda).manual_seed(9), cuda)
    served = MR.serving_params(params, cfg)
    g = PG.PrefillGraphs(cfg, 64, served, cuda)
    g.capture_all()
    opened = collections.Counter()
    span = T.span

    def counted(name):
        opened[name] += 1
        return span(name)

    monkeypatch.setattr(T, "span", counted)
    prompt = _prompt(cfg, 40)
    seen = []
    for replayed in (False, True):
        opened.clear()
        with T.recording():
            if replayed:
                g(prompt)
            else:
                g.load(prompt)
                with torch.no_grad():
                    g._work(48)
            torch.cuda.synchronize()
            keyed = T.records()["keyed"]
        seen.append(({k: opened[k] for k in PG.CUT_SPANS},
                     keyed["moe.routed"]))
    assert seen[0] == seen[1]
    assert seen[0][0] == {"moe.routed": cfg.num_layers, "ssm.mixer": sum(
        cfg.block_kind(i) == "mamba" for i in range(cfg.num_layers))}


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ARCHS)
def test_engine_replays_every_prefill(cuda, arch, monkeypatch):
    """An engine on the card against one whose prefills run the same
    padded shapes eagerly (stand-in graphs): the same tokens, events and
    maps; the graphed engine's every bucket captured once, and every
    prefill a replay of its bucket."""
    cfg = _card_config(arch)
    params = MR.init_params(cfg, torch.Generator(cuda).manual_seed(10), cuda)
    lens = (5, 17, 3, 30, 12, 9, 40, 33)
    served = []
    for graphs in (False, True):
        with monkeypatch.context() as mp:
            if not graphs:
                mp.setattr(PG.PrefillGraphs, "capture_all", _eager_capture)
            engine = ServeEngine(params, cfg, slots=3, max_seq=64,
                                 runtime=_runtime(cfg), device=cuda)
            reqs = _requests(cfg, lens)
            with T.recording():
                engine.submit_all(reqs)
            served.append(([r.out for r in reqs], engine.events,
                           _maps(engine.maps),
                           T.records()["keyed"]["serve.prefill_graph"]))
    (out_e, ev_e, maps_e, n_e), (out_g, ev_g, maps_g, n_g) = served
    assert out_g == out_e
    assert ev_g == ev_e > 0
    assert all(torch.equal(a, b) for a, b in zip(maps_e, maps_g))
    replays = collections.Counter(("replay", PG.bucket(n, 64)) for n in lens)
    assert n_e == replays
    assert n_g == replays + collections.Counter(
        ("capture", b) for b in PG.buckets(64))
