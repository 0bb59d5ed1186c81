"""The serving decode step replayed from CUDA graphs
(`repro_torch/serve/decode_graph.py`).

On the CPU: which configs and callers engage the graphed path, the engine's
step counting its eager calls there, and the model's decode writing its new
cache into a given buffer (the graphs' double buffer) with the eager
decode's bits. On the card (marked `cuda`, skipping without one; this file
imports no JAX): the graphed step against the eager step, step by step,
for each decoder family the predicate admits, the same on the serving
tree's bf16 weights, and the engine with and without graphs:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_decode_graph.py
"""
import dataclasses
import types

import pytest

torch = pytest.importorskip("torch")

from repro_torch import device as D, telemetry as T  # noqa: E402
from repro_torch.configs import registry as TCFG  # noqa: E402
from repro_torch.core import events as E  # noqa: E402
from repro_torch.core.runtime import BpftimeRuntime  # noqa: E402
from repro_torch.dist import sharding  # noqa: E402
from repro_torch.launch import serve as L  # noqa: E402
from repro_torch.models import registry as MR  # noqa: E402
from repro_torch.serve import decode_graph as DG  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.steps import make_decode_step  # noqa: E402

CAPTURED = ["qwen2-0.5b", "starcoder2-15b", "llama4-scout-17b-a16e",
            "kimi-k2-1t-a32b", "mamba2-780m", "jamba-v0.1-52b"]
EAGER = ["qwen2-vl-72b", "seamless-m4t-medium"]
# one decoder config of each family the predicate admits
FAMILIES = ["qwen2-0.5b", "llama4-scout-17b-a16e", "mamba2-780m",
            "jamba-v0.1-52b"]


def _runtime(cfg):
    rt = BpftimeRuntime()
    L.attach_serve_probes(rt, L.family_probes(cfg))
    return rt


def _requests(cfg, n=5):
    g = torch.Generator().manual_seed(11)
    # even prompts: the smoke SSD chunk is 2
    return [Request(rid=i, prompt=torch.randint(
        0, cfg.vocab_size, (4 + 2 * (i % 4),), generator=g).tolist(),
        max_new=3 + i % 3) for i in range(n)]


def _prefill_into(params, cfg, caches, slots, prompt, max_seq):
    """Prefill `prompt` alone and write it into the slots `slots` of each
    cache of `caches`, in place, as `ServeEngine._prefill_slot` does."""
    dev = caches[0]["pos"].device
    one = MR.make_cache(cfg, 1, max_seq, torch.float32, dev)
    _, one = MR.prefill_fn(params, {"tokens": torch.tensor(
        [prompt], device=dev)}, one, cfg)
    for c in caches:
        for full, o in zip(c["blocks"], one["blocks"]):
            for f in full:
                for s in slots:
                    full[f][:, s] = o[f][:, 0]
        for s in slots:
            c["pos"][s] = one["pos"][0]


def _clone(tree):
    return [t.clone() for t in E._tree_leaves(tree)]


def _equal(a, b):
    return len(a) == len(b) and all(
        x.shape == y.shape and torch.equal(x.to(y.dtype), y)
        for x, y in zip(a, b))


def _maps(maps):
    return [t for m in sorted(maps) for f, t in sorted(maps[m].items())]


# ------------------------------------------------------------------ CPU

@pytest.mark.parametrize("arch", CAPTURED + EAGER)
def test_decode_capturable_by_family(arch):
    cfg = TCFG.get(arch)
    assert MR.decode_capturable(cfg) == (arch in CAPTURED)
    assert MR.decode_capturable(TCFG.smoke(arch)) == (arch in CAPTURED)


def test_expert_parallel_over_a_mesh_is_not_captured(monkeypatch):
    moe, dense = (TCFG.smoke(a) for a in ("llama4-scout-17b-a16e",
                                          "qwen2-0.5b"))
    mesh = types.SimpleNamespace(axis_names=("data", "model"),
                                 shape={"data": 1, "model": 2})
    monkeypatch.setattr(sharding, "active_mesh", lambda: mesh)
    assert MR.decode_capturable(moe)
    monkeypatch.setenv("REPRO_MOE_EP", "1")
    assert not MR.decode_capturable(moe)
    assert MR.decode_capturable(dense)


def test_engages_on_a_cuda_cache_outside_tracing(monkeypatch):
    cuda_like = {"pos": types.SimpleNamespace(is_cuda=True)}
    cpu = MR.make_cache(TCFG.smoke("qwen2-0.5b"), 2, 8, torch.float32,
                        "cpu")
    cfg = TCFG.smoke("qwen2-0.5b")
    assert DG.engages(cfg, cuda_like)
    assert not DG.engages(cfg, cpu)
    assert not DG.engages(TCFG.smoke("qwen2-vl-72b"), cuda_like)
    monkeypatch.setattr(D, "TRACING", True)
    assert not DG.engages(cfg, cuda_like)


@pytest.mark.parametrize("arch", ["qwen2-0.5b", "qwen2-vl-72b"])
@pytest.mark.parametrize("tracing", [False, True])
def test_engine_step_is_eager_on_the_cpu(arch, tracing, monkeypatch):
    """On the CPU, under the dry run's `device.tracing()`, and for a config
    the predicate excludes, the engine's step runs the eager decode and
    counts every call as "eager"."""
    cfg = TCFG.smoke(arch)
    params = MR.init_params(cfg, torch.Generator().manual_seed(0), "cpu")
    engine = ServeEngine(params, cfg, slots=2, max_seq=32,
                         runtime=_runtime(cfg), device="cpu")
    monkeypatch.setattr(DG.DecodeGraphs, "__call__", None)
    monkeypatch.setattr(D, "TRACING", tracing)
    with T.recording():
        engine.submit_all(_requests(cfg))
    assert engine.step_count > 0
    assert T.records()["keyed"]["decode.graph"] == {
        "eager": engine.step_count}


@pytest.mark.parametrize("arch", FAMILIES)
def test_decode_into_a_given_cache_gives_the_eager_bits(arch):
    """`decode_fn(..., cache_out=)` (the graphs' work): the same logits bit
    for bit, the eager decode's new cache written into cache_out, the
    given cache unchanged; over three steps, each reading the last one's
    cache_out."""
    cfg = TCFG.smoke(arch)
    params = MR.init_params(cfg, torch.Generator().manual_seed(1), "cpu")
    cache = MR.make_cache(cfg, 3, 16, torch.float32, "cpu")
    _prefill_into(params, cfg, [cache], [0, 2], [5, 9, 3, 7], 16)
    toks = torch.tensor([[1], [2], [3]])
    for _ in range(3):
        given = _clone(cache)
        out = E._tree_map(torch.empty_like, cache)
        logits, new = MR.decode_fn(params, toks, cache, cfg)
        got_logits, got = MR.decode_fn(params, toks, cache, cfg,
                                       cache_out=out)
        assert got is out
        assert torch.equal(got_logits, logits)
        assert _equal(E._tree_leaves(new), E._tree_leaves(got))
        assert _equal(given, E._tree_leaves(cache))
        cache, toks = got, logits[:, -1].argmax(-1)[:, None]


# ------------------------------------------------------------------ card

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: CUDA graphs run only on the card")
    return torch.device("cuda")


def _card_config(arch):
    """The smoke config in bf16 compute, as the serving cell runs; "-full":
    the published widths."""
    if arch.endswith("-full"):
        return TCFG.get(arch[:-5])
    return dataclasses.replace(TCFG.smoke(arch), dtype="bfloat16")


@pytest.mark.cuda
@pytest.mark.parametrize("arch", FAMILIES + ["qwen2-0.5b-full"])
def test_graphed_step_matches_the_eager_step(cuda, arch):
    """Six calls of the graphed step against the eager step from the same
    cache, with two slots rewritten in place between the second and the
    third call (a refill): the same next tokens, event rows, maps, logits
    and new cache; the given cache's bytes unchanged by every call; one
    capture in each direction, every later call a replay. Then two calls
    on one given cache give what the eager step gives."""
    cfg = _card_config(arch)
    full = arch.endswith("-full")
    B, S = (32, 2048) if full else (4, 32)
    params = MR.init_params(cfg, torch.Generator(cuda).manual_seed(2), cuda)
    rt_e, rt_g = _runtime(cfg), _runtime(cfg)
    eager = make_decode_step(cfg, rt_e)
    graphed = make_decode_step(cfg, rt_g, graphs=True)
    ce = MR.make_cache(cfg, B, S, torch.float32, cuda)
    _prefill_into(params, cfg, [ce], range(B), [3, 1, 4, 1, 5, 9], S)
    cg = E._tree_map(torch.clone, ce)
    me, mg = rt_e.init_device_maps(cuda), rt_g.init_device_maps(cuda)
    toks = torch.arange(B, device=cuda)[:, None] % cfg.vocab_size
    worst = 0.0
    with T.recording():
        for step in range(6):
            if step == 2:
                _prefill_into(params, cfg, [ce, cg], [1, B - 1],
                              [2, 7, 1, 8, 2, 8, 1, 8], S)
            old, given = cg, _clone(cg)
            ne, le, ce, me = eager(params, toks, ce, me, step)
            ng, lg, cg, mg = graphed(params, toks, cg, mg, step)
            assert _equal(given, E._tree_leaves(old)), step
            assert torch.equal(ne, ng), step
            assert torch.equal(eager.last[0], graphed.last[0]), step
            assert _equal(_maps(me), _maps(mg)), step
            assert _equal(E._tree_leaves(ce), E._tree_leaves(cg)), step
            worst = max(worst, float((le - lg).abs().max()))
            toks = ne[:, None].to(toks.dtype)
        counts = dict(T.records()["keyed"]["decode.graph"])
    assert worst == 0.0, f"logits differ by up to {worst}"
    assert counts == {"eager": 6, "capture": 2, "replay": 4}
    outs = []
    for _ in range(2):
        given = _clone(cg)
        ne, le, _, me2 = eager(params, toks, ce, me, 6)
        ng, lg, new, mg2 = graphed(params, toks, cg, mg, 6)
        assert _equal(given, E._tree_leaves(cg))
        outs.append((ne, ng, le.clone(), lg.clone(),
                     _clone(new), _maps(me2), _maps(mg2)))
    for ne, ng, le, lg, new, m_e, m_g in outs:
        assert torch.equal(ne, ng) and torch.equal(le, lg)
        assert _equal(m_e, m_g)
    assert _equal(outs[0][4], outs[1][4])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mamba2-780m"])
def test_engine_serves_the_same_with_and_without_graphs(cuda, arch,
                                                        monkeypatch):
    """Two engines on one set of weights, one with the graphs turned off
    by the predicate: the same tokens for every request, the same events
    and maps; the graphed engine captures once in each direction and
    replays every later call."""
    cfg = _card_config(arch)
    params = MR.init_params(cfg, torch.Generator(cuda).manual_seed(3), cuda)
    served = []
    for graphs in (False, True):
        with monkeypatch.context() as mp:
            if not graphs:
                mp.setattr(DG, "engages", lambda cfg, cache: False)
            engine = ServeEngine(params, cfg, slots=3, max_seq=48,
                                 runtime=_runtime(cfg), device=cuda)
            reqs = _requests(cfg, 7)
            with T.recording():
                engine.submit_all(reqs)
            served.append(([r.out for r in reqs], engine.events,
                           _maps(engine.maps),
                           dict(T.records()["keyed"]["decode.graph"]),
                           engine.step_count))
    (out_e, ev_e, maps_e, n_e, steps), (out_g, ev_g, maps_g, n_g, _) = served
    assert out_g == out_e
    assert ev_g == ev_e > 0
    assert _equal(maps_e, maps_g)
    assert n_e == {"eager": steps}
    assert n_g == {"capture": 2, "replay": steps - 2}



@pytest.mark.cuda
@pytest.mark.parametrize("arch", FAMILIES + ["granite-4.0-h-small"])
def test_graphed_step_on_the_serving_tree(cuda, arch):
    """Six calls of the graphed step on the serving tree
    (`registry.serving_params`, one object at every call, as `ServeEngine`
    passes it) against the eager step on the f32 tree: the same next
    tokens, event rows, maps, logits and cache, bit for bit; one capture
    in each direction, every later call a replay."""
    cfg = _card_config(arch)
    B, S = 4, 32
    params = MR.init_params(cfg, torch.Generator(cuda).manual_seed(4), cuda)
    served = MR.serving_params(params, cfg)
    assert served is not params
    rt_e, rt_g = _runtime(cfg), _runtime(cfg)
    eager = make_decode_step(cfg, rt_e)
    graphed = make_decode_step(cfg, rt_g, graphs=True)
    ce = MR.make_cache(cfg, B, S, torch.float32, cuda)
    _prefill_into(params, cfg, [ce], range(B), [3, 1, 4, 1, 5, 9], S)
    cg = E._tree_map(torch.clone, ce)
    me, mg = rt_e.init_device_maps(cuda), rt_g.init_device_maps(cuda)
    toks = torch.arange(B, device=cuda)[:, None] % cfg.vocab_size
    with T.recording():
        for step in range(6):
            ne, le, ce, me = eager(params, toks, ce, me, step)
            ng, lg, cg, mg = graphed(served, toks, cg, mg, step)
            assert torch.equal(ne, ng), step
            assert torch.equal(le, lg), step
            assert torch.equal(eager.last[0], graphed.last[0]), step
            assert _equal(_maps(me), _maps(mg)), step
            assert _equal(E._tree_leaves(ce), E._tree_leaves(cg)), step
            toks = ne[:, None].to(toks.dtype)
        counts = dict(T.records()["keyed"]["decode.graph"])
    assert counts == {"eager": 6, "capture": 2, "replay": 4}
