"""The port's telemetry (`repro_torch.telemetry`): off, a span is one
shared object and nothing reaches the profiler, and steps give the same
bits on and off; on, under `torch.profiler` on the CPU, the spans of the
serving loop, the decode step and the train step nest as the layers do,
and the keyed records count what the engine did. On the card, the launch
records match the kernels' launch totals."""
import contextlib
import dataclasses

import pytest

torch = pytest.importorskip("torch")

from repro_torch import device as D, telemetry as T  # noqa: E402
from repro_torch.configs import base as TB, registry as TCFG  # noqa: E402
from repro_torch.core.runtime import BpftimeRuntime  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve as L, train as LT  # noqa: E402
from repro_torch.models import registry as MR  # noqa: E402
from repro_torch.optim import tree_leaves  # noqa: E402
from repro_torch.serve.engine import Request, ServeEngine  # noqa: E402
from repro_torch.serve.steps import make_decode_step  # noqa: E402
from repro_torch.train.train_step import (init_train_state,  # noqa: E402
                                          make_train_step)

CFG = TCFG.smoke("qwen2-0.5b")
TCFG_ = TB.TrainConfig(microbatch=2, warmup=1, lr=1e-3)
VETO_ALWAYS = """
    mov r1, 1
    call override_return
    mov r0, 0
    exit
"""


@pytest.fixture(scope="module")
def params():
    return MR.init_params(CFG, torch.Generator().manual_seed(5), "cpu")


def _serve_runtime():
    rt = BpftimeRuntime()
    L.attach_serve_probes(rt, L.family_probes(CFG))
    return rt


def _requests():
    g = torch.Generator().manual_seed(11)
    lens = [5, 9, 3, 12, 7]
    return [Request(rid=i, prompt=torch.randint(0, CFG.vocab_size, (n,),
                                                generator=g).tolist(),
                    max_new=3 + i % 3) for i, n in enumerate(lens)]


def _train_batch(seed=3, nmb=2, mb=2, S=16):
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, CFG.vocab_size, (nmb, mb, S + 1), generator=g)
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}


def _decode_inputs(params):
    cache = MR.make_cache(CFG, 2, 16, torch.float32, "cpu")
    toks = torch.tensor([[3], [7]])
    return cache, toks


def _leaves(tree):
    return [t.detach().clone() for t in tree_leaves(tree)]


def _raise(*a, **k):
    raise AssertionError("a profiler range opened with telemetry off")


def _no_ranges(monkeypatch):
    """Opening a profiler range raises while the block runs."""
    monkeypatch.setattr(torch.profiler, "record_function", _raise)
    monkeypatch.setattr(torch.autograd, "_record_function_with_args_enter",
                        _raise)


# ------------------------------------------------------------------ off

def test_off_a_span_is_one_shared_object():
    assert not T.on()
    a, b = T.span("serve.iteration"), T.span("decode.step")
    assert a is b is T.OFF
    with a as got:
        assert got is None


def test_off_nothing_enters_the_profiler_and_nothing_is_counted(
        params, monkeypatch):
    _no_ranges(monkeypatch)
    with T.recording(), pytest.raises(AssertionError):
        T.span("serve.iteration").__enter__()
    T.count("serve.prefill_tokens", 4)
    engine = ServeEngine(params, CFG, slots=2, max_seq=32,
                         runtime=_serve_runtime(), device="cpu")
    engine.submit_all(_requests())
    state = init_train_state(CFG, TCFG_, device="cpu", params=params)
    make_train_step(CFG, TCFG_)(state, _train_batch())
    assert T.records()["keyed"] == {}


def test_off_a_running_profiler_sees_no_span(params):
    engine = ServeEngine(params, CFG, slots=2, max_seq=32,
                         runtime=_serve_runtime(), device="cpu")
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        engine.submit_all(_requests())
    assert engine.step_count > 0
    assert not [e for e in prof.events() if e.name.startswith(T.PREFIX)]


def test_decode_and_train_steps_give_the_same_bits_on_and_off(params):
    outs = []
    for on in (False, True):
        cache, toks = _decode_inputs(params)
        maps = {}
        dstep = make_decode_step(CFG, None)
        with T.recording() if on else contextlib.nullcontext():
            nxt, logits, cache, _ = dstep(params, toks, cache, maps, 0)
            state = init_train_state(CFG, TCFG_, device="cpu",
                                     params=params)
            new, met = make_train_step(CFG, TCFG_)(state, _train_batch())
        outs.append([nxt, logits, *cache["blocks"][0].values(),
                     met["loss"], *_leaves(new["params"]),
                     *_leaves(new["opt"])])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_probed_decode_step_gives_the_same_bits_on_and_off(params):
    outs = []
    for on in (False, True):
        rt = _serve_runtime()
        step = make_decode_step(CFG, rt)
        cache, toks = _decode_inputs(params)
        maps = rt.init_device_maps("cpu")
        with T.recording() if on else contextlib.nullcontext():
            nxt, logits, cache, maps = step(params, toks, cache, maps, 0)
        outs.append([nxt, logits] + [t for m in maps.values()
                                     for t in m.values()])
    for a, b in zip(*outs):
        assert torch.equal(a, b)


def test_while_a_step_is_traced_spans_are_off(monkeypatch):
    monkeypatch.setattr(D, "TRACING", True)
    _no_ranges(monkeypatch)
    with T.recording():
        assert T.span("train.step") is T.OFF


def test_counts_only_inside_recording_and_records_carry_launch_totals():
    with T.recording():
        T.count("k", (1, 2))
        T.count("k", (1, 2), 3)
        T.count("j", 7)
    T.count("k", (1, 2))
    rec = T.records()
    assert rec["keyed"] == {"k": {(1, 2): 4}, "j": {7: 1}}
    assert rec["launches"] == ops.launch_counts()
    with T.recording():
        assert T.records()["keyed"] == {}


# ------------------------------------------------------------------ on

def _profiled(fn):
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof, \
            T.recording():
        out = fn()
    spans = [e for e in prof.events() if e.name.startswith(T.PREFIX)]
    return out, spans


def _name(e):
    return e.name[len(T.PREFIX):]


def _ancestors(e):
    out, p = [], e.cpu_parent
    while p is not None:
        if p.name.startswith(T.PREFIX):
            out.append(_name(p))
        p = p.cpu_parent
    return out


def _children(e, name):
    return [c for c in _descendants(e) if _name(c) == name]


def _descendants(e):
    out = []
    for c in e.cpu_children:
        if c.name.startswith(T.PREFIX):
            out.append(c)
        out += _descendants(c)
    return out


def test_serving_spans_nest_as_the_loop_runs(params):
    reqs = _requests()
    engine = ServeEngine(params, CFG, slots=2, max_seq=32,
                         runtime=_serve_runtime(), device="cpu")
    _, spans = _profiled(lambda: engine.submit_all(reqs))
    by = {}
    for e in spans:
        by.setdefault(_name(e), []).append(e)
    iters = by["serve.iteration"]
    assert len(iters) == engine.step_count
    for it in iters:
        assert len(_children(it, "decode.step")) == 1
        assert _ancestors(it) == []
    assert len(by["decode.step"]) == engine.step_count
    for e in by["decode.step"]:
        assert [_name(c) for c in e.cpu_children
                if c.name.startswith(T.PREFIX)] == [
            "decode.model", "decode.sample", "probe.stage"]
    assert len(by["serve.prefill"]) == len(reqs)
    for e in by["serve.slot_write"]:
        assert _ancestors(e)[:3] == ["serve.prefill", "serve.refill",
                                     "serve.iteration"]
    assert len(by["serve.slot_write"]) == len(reqs)
    assert len(by["probe.emit"]) == engine.events
    for e in by["probe.emit"]:
        assert _ancestors(e)[:2] == ["decode.model", "decode.step"]
    assert len(by["serve.read"]) == len(by["serve.retire"]) == len(iters)
    assert "serve.control" not in by          # no shared-memory plane
    keyed = T.records()["keyed"]
    prefilled = keyed["serve.prefill_tokens"]
    assert sum(prefilled.values()) == len(reqs)
    assert sum(n * k for n, k in prefilled.items()) == \
        sum(len(r.prompt) for r in reqs)
    decoded = keyed["serve.decode_position"]
    # every decoded token but each request's first (from its prefill)
    assert sum(decoded.values()) == sum(len(r.out) - 1 for r in reqs)
    want = {}
    for r in reqs:
        for j in range(1, len(r.out)):
            p = len(r.prompt) + j - 1
            want[p] = want.get(p, 0) + 1
    assert decoded == want


def _train_spans(state, step):
    (new, met), spans = _profiled(lambda: step(state, _train_batch()))
    by = {}
    for e in spans:
        by.setdefault(_name(e), []).append(e)
    return new, met, by


def test_train_spans_a_microbatch_and_a_step(params):
    rt = BpftimeRuntime()
    LT.attach_train_probes(rt)
    tcfg = dataclasses.replace(TCFG_, remat=True)
    state = init_train_state(CFG, tcfg, rt, device="cpu", params=params)
    _, met, by = _train_spans(state, make_train_step(CFG, tcfg, rt))
    assert int(met["vetoed"]) == 0
    assert len(by["train.step"]) == 1
    step = by["train.step"][0]
    for name, n in (("train.forward", 2), ("train.backward", 2),
                    ("model.loss", 2), ("train.accumulate", 3),
                    ("train.clip", 1), ("probe.stage", 1),
                    ("train.veto_read", 1), ("train.optimizer", 1)):
        assert len(by[name]) == n, name
        assert all("train.step" in _ancestors(e) for e in by[name]), name
    for e in by["model.loss"]:
        assert _ancestors(e)[0] == "train.forward"
    # the forward's probe events, once a microbatch each (the remat
    # recompute runs with the collector suspended)
    emits = by["probe.emit"]
    assert emits and all("train.step" in _ancestors(e) for e in emits)
    assert _children(step, "train.optimizer")


def test_a_vetoed_step_has_no_optimizer_span(params):
    rt = BpftimeRuntime()
    rt.attach(rt.load_asm("veto", VETO_ALWAYS, [], "filter"), "probe:loss")
    state = init_train_state(CFG, TCFG_, rt, device="cpu", params=params)
    _, met, by = _train_spans(state, make_train_step(CFG, TCFG_, rt))
    assert int(met["vetoed"]) == 1
    assert len(by["train.veto_read"]) == 1
    assert "train.optimizer" not in by
    assert len(by["train.forward"]) == len(by["train.backward"]) == 2


# ------------------------------------------------------------------ card

@pytest.mark.cuda
def test_launch_records_match_the_launch_totals_on_the_card(params):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels launch only there")
    cfg = dataclasses.replace(CFG, dtype="bfloat16")
    dev = torch.device("cuda")
    p = MR.init_params(cfg, torch.Generator(dev).manual_seed(5), dev)
    rt = BpftimeRuntime()
    L.attach_serve_probes(rt, L.family_probes(cfg))
    engine = ServeEngine(p, cfg, slots=2, max_seq=32, runtime=rt,
                         device=dev)
    before = ops.launch_counts()
    with T.recording():
        engine.submit_all(_requests())
        q = torch.randn(4, 2048, 64, device=dev, dtype=torch.bfloat16)
        kv = torch.randn(2, 2048, 64, device=dev, dtype=torch.bfloat16)
        for causal in (True, False):
            qq = q.clone().requires_grad_(True)
            o = ops.fa.FlashAttention.apply(qq, kv, kv, causal)
            o.float().sum().backward()
        # the statistics' dict route launches the same kernel family
        ops.tensor_stats(q)
        torch.cuda.synchronize()
    rec = T.records()
    keyed, after = rec["keyed"], rec["launches"]
    for name, kernel in (("probe.tensor_stats", "tensor_stats"),
                         ("probe.hash_fetch_add", "hash_fetch_add_batch"),
                         ("probe.ringbuf_emit", "ringbuf_emit_batch"),
                         ("flash.fwd", "flash_fwd"),
                         ("flash.bwd", "flash_bwd")):
        assert sum(keyed.get(name, {}).values()) == \
            after[kernel] - before[kernel], name
    assert keyed["flash.fwd"] == {(4, 2, 2048, 64, True): 1,
                                  (4, 2, 2048, 64, False): 1}
    assert keyed["flash.bwd"] == keyed["flash.fwd"]
    stats = keyed["probe.tensor_stats"]
    assert stats.pop(("repro_tensor_stats", q.numel(), 2)) == 1
    assert sum(stats.values()) == engine.events
    assert all(sym == "repro_tensor_stats_row" and size in (2, 4)
               for sym, _, size in stats)
