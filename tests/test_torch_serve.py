"""The port's serving path against the JAX package's, on the CPU: the smoke
qwen2-0.5b config (f32) with the JAX weights carried across, the admission
filter and the four serving probes attached on the fused lane. Then the
port alone in bf16 compute, one case a served family: the engine on its
serving tree (`registry.serving_params`) against the model's entry points
over the f32 tree, bit for bit, and a served decode step that casts no
weight."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402

from repro.configs import registry as JCFG  # noqa: E402
from repro.core import maps as JM  # noqa: E402
from repro.core.runtime import BpftimeRuntime as JRuntime  # noqa: E402
from repro.models import registry as JMR  # noqa: E402
from repro.serve.engine import Request as JRequest, ServeEngine as JEngine  # noqa: E402,E501

from repro_torch.configs import registry as TCFG  # noqa: E402
from repro_torch.core import events as TE  # noqa: E402
from repro_torch.core.runtime import BpftimeRuntime as TRuntime, to_numpy  # noqa: E402,E501
from repro_torch.launch import serve as TL  # noqa: E402
from repro_torch.models import registry as TMR  # noqa: E402
from repro_torch.serve.engine import Request as TRequest, ServeEngine as TEngine  # noqa: E402,E501

CPU = "cpu"
JCFG_ = JCFG.smoke("qwen2-0.5b")
TCFG_ = TCFG.smoke("qwen2-0.5b")
STAT_TOL = 2e-5
ADMIT_LIMIT = 12


@pytest.fixture(scope="module")
def weights():
    jp = JMR.init_params(jax.random.PRNGKey(0), JCFG_)
    npp = jax.tree.map(np.asarray, jp)
    return jp, TMR.params_from_numpy(npp, CPU)


# the fields the port's config adds to the JAX package's (granite-4.0-h's
# scalars, its shared expert's width, the dropless router), each at a
# default that changes nothing
PORT_FIELDS = {"moe_shared_d_ff": 0, "moe_dropless": False,
               "embedding_multiplier": 1.0, "residual_multiplier": 1.0,
               "attention_multiplier": 0.0, "logits_scaling": 1.0}


def test_config_copied_unchanged():
    """Every field of the JAX package's config, copied with its value;
    the port's own fields at their defaults."""
    for t, j in ((TCFG.get("qwen2-0.5b"), JCFG.get("qwen2-0.5b")),
                 (TCFG_, JCFG_)):
        td = dict(t.__dict__)
        assert {k: td.pop(k) for k in PORT_FIELDS} == PORT_FIELDS
        assert td == j.__dict__


def test_weights_carry_across(weights):
    jp, tp = weights
    jl = jax.tree.leaves(jp)
    assert len(jl) > 0
    assert tp["stack"]["blocks"][0]["attn"]["wq"].shape == \
        jp["stack"]["blocks"][0]["attn"]["wq"].shape
    np.testing.assert_array_equal(tp["embed"]["embedding"].numpy(),
                                  np.asarray(jp["embed"]["embedding"]))


def test_prefill_and_decode_logits_match(weights):
    jp, tp = weights
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, JCFG_.vocab_size, (2, 7))
    jc = JMR.make_cache(JCFG_, 2, 16, jnp.float32)
    tc = TMR.make_cache(TCFG_, 2, 16, torch.float32, CPU)
    jl, jc = JMR.prefill_fn(jp, {"tokens": jnp.asarray(prompt, jnp.int32)},
                            jc, JCFG_)
    tl, tc = TMR.prefill_fn(tp, {"tokens": torch.as_tensor(prompt)}, tc,
                            TCFG_)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    for _ in range(3):
        nxt = np.asarray(jnp.argmax(jl[:, -1, :JCFG_.vocab_size], -1))
        assert (tl[:, -1, :TCFG_.vocab_size].argmax(-1).numpy()
                == nxt).all()
        jl, jc = JMR.decode_fn(jp, jnp.asarray(nxt[:, None], jnp.int32), jc,
                               JCFG_)
        tl, tc = TMR.decode_fn(tp, torch.tensor(nxt[:, None]), tc, TCFG_)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                                   atol=1e-4)
    np.testing.assert_array_equal(tc["pos"].numpy(), np.asarray(jc["pos"]))
    for j in range(len(jc["blocks"])):
        for f in ("k", "v"):
            np.testing.assert_allclose(tc["blocks"][j][f].numpy(),
                                       np.asarray(jc["blocks"][j][f]),
                                       rtol=1e-4, atol=1e-4)


def test_train_forward_and_flash_attention_match(weights):
    """The no-cache forward and the chunked online-softmax attention (the
    path for sequences above 2048) against the JAX package's."""
    from repro.models import layers as JL, transformer as JTF
    from repro_torch.models import layers as TL_, transformer as TTF
    jp, tp = weights
    toks = np.random.default_rng(4).integers(0, JCFG_.vocab_size, (2, 9))
    jl, _ = JTF.forward(jp, jnp.asarray(toks, jnp.int32), JCFG_)
    tl, _ = TTF.forward(tp, torch.as_tensor(toks), TCFG_)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=1e-4,
                               atol=1e-4)
    rng = np.random.default_rng(5)
    q = rng.normal(size=(2, 16, 4, 8)).astype(np.float32)
    k, v = (rng.normal(size=(2, 16, 2, 8)).astype(np.float32)
            for _ in range(2))
    want = JL.flash_attention(*map(jnp.asarray, (q, k, v)), causal=True,
                              q_chunk=4, kv_chunk=8)
    got = TL_.flash_attention(*map(torch.as_tensor, (q, k, v)), causal=True,
                              q_chunk=4, kv_chunk=8)
    full = TL_.full_attention(*map(torch.as_tensor, (q, k, v)), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(got.numpy(), full.numpy(), rtol=1e-4,
                               atol=1e-5)


def _jax_runtime():
    rt = JRuntime()
    pid = rt.load_asm("admit", TL.admit_filter_text(ADMIT_LIMIT), [],
                      "filter")
    rt.attach(pid, "filter:sys_serve_admit")
    for name, text, (mname, kind, n, w), target in TL.SERVE_PROBES:
        spec = JM.MapSpec(mname, JM.MapKind(kind), n, rec_width=w)
        rt.attach(rt.load_asm(name, text, [spec], "uprobe"), target,
                  mode="fused")
    return rt


def _torch_runtime():
    rt = TRuntime()
    pid = rt.load_asm("admit", TL.admit_filter_text(ADMIT_LIMIT), [],
                      "filter")
    rt.attach(pid, "filter:sys_serve_admit")
    TL.attach_serve_probes(rt)
    return rt


@pytest.fixture(scope="module")
def served(weights):
    jp, tp = weights
    reqs_t = TL.make_requests(8, 8, TCFG_.vocab_size)
    reqs_j = [JRequest(rid=r.rid, prompt=list(r.prompt), max_new=r.max_new)
              for r in reqs_t]
    je = JEngine(jp, JCFG_, slots=4, max_seq=128, runtime=_jax_runtime())
    je.submit_all(reqs_j)
    te = TEngine(tp, TCFG_, slots=4, max_seq=128, runtime=_torch_runtime(),
                 device=CPU)
    te.submit_all(reqs_t)
    return je, reqs_j, te, reqs_t


def test_serve_tokens_and_admission_match(served):
    je, reqs_j, te, reqs_t = served
    assert [r.rejected for r in reqs_t] == [r.rejected for r in reqs_j]
    assert any(r.rejected for r in reqs_t) and not all(
        r.rejected for r in reqs_t)
    assert [r.out for r in reqs_t] == [r.out for r in reqs_j]
    assert te.step_count == je.step_count
    assert te.events == te.step_count * (2 * TCFG_.num_layers + 1)


def test_serve_map_states_match(served):
    je, _, te, _ = served
    jm = {n: {f: np.asarray(a) for f, a in st.items()}
          for n, st in je.maps.items()}
    tm = to_numpy(te.maps)
    assert set(tm) == set(jm)
    for name in ("sv_layer_counts", "sv_key_hash", "sv_rms_hist"):
        for f in jm[name]:
            np.testing.assert_array_equal(tm[name][f], jm[name][f],
                                          err_msg=f"{name}.{f}")
    assert tm["sv_layer_counts"]["values"][:TCFG_.num_layers].sum() > 0
    rb_t, rb_j = tm["sv_logits_rb"], jm["sv_logits_rb"]
    np.testing.assert_array_equal(rb_t["head"], rb_j["head"])
    np.testing.assert_array_equal(rb_t["dropped"], rb_j["dropped"])
    assert rb_t["head"][0] == te.step_count
    # lanes: step and numel are integers (exact); rms and absmax are Q47.16
    # stats (within the stats tolerance)
    np.testing.assert_array_equal(rb_t["data"][:, :2], rb_j["data"][:, :2])
    np.testing.assert_allclose(rb_t["data"][:, 2:].astype(np.float64),
                               rb_j["data"][:, 2:].astype(np.float64),
                               rtol=STAT_TOL, atol=1)


@pytest.mark.parametrize("mode", ["scan", "vectorized"])
def test_last_tape_replays_bit_identical(served, mode):
    """The last decode step's tape through the scan and vectorized modes
    ends in the map state the fused lane produced."""
    _, _, te, _ = served
    rows, maps_in, step = te.last_tape
    from repro_torch.core import jit as TJ
    fused, _ = te.runtime.probe_stage(rows, maps_in,
                                      TJ.make_aux(time_ns=step, device=CPU),
                                      mode="fused")
    got, _ = te.runtime.probe_stage(rows, maps_in,
                                    TJ.make_aux(time_ns=step, device=CPU),
                                    mode=mode)
    want, got = to_numpy(fused), to_numpy(got)
    np.testing.assert_array_equal(to_numpy(te.maps)["sv_key_hash"]["values"],
                                  want["sv_key_hash"]["values"])
    for name in want:
        for f in want[name]:
            np.testing.assert_array_equal(got[name][f], want[name][f],
                                          err_msg=f"{name}.{f} [{mode}]")


def test_entry_points_refuse_missing_cuda():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        TMR.init_params(TCFG_)
    with pytest.raises(RuntimeError, match="CUDA"):
        TRuntime().init_device_maps()
    with pytest.raises(RuntimeError, match="CUDA"):
        TEngine({}, TCFG_)
    with pytest.raises(RuntimeError, match="CUDA"):
        TL.main(["--requests", "1"])


# ------------------------------------------------- the serving tree (bf16)

GRANITE_CELL = "granite-4.0-h-small.serve_chat"
SERVED_ARCHS = ["qwen2-0.5b", "granite-4.0-h-small", "jamba-v0.1-52b",
                "llama4-scout-17b-a16e", "mamba2-780m", "qwen2-vl-72b"]


def _bf16_model(arch):
    """(config, f32 params) at the arch's smoke cut in bf16 compute, every
    leaf away from a bf16 value (norm scales, biases and the SSM's
    constants too), so a leaf rounded that should not be changes bits.
    granite-4.0-h-small: the benchmark cell's own smoke cut and seeded
    weights."""
    import dataclasses
    from portbench import smoke, weights as W
    from repro_torch.configs.base import ModelConfig
    if arch == "granite-4.0-h-small":
        c = smoke.small_cell(GRANITE_CELL)
        m = dict(c.config["model"], dtype="bfloat16")
        return ModelConfig(**m), W.make_params(
            2**31 + 30, {**c.config, "model": m}, CPU)
    cfg = dataclasses.replace(TCFG.smoke(arch), dtype="bfloat16")
    params = TMR.init_params(cfg, torch.Generator().manual_seed(5), CPU)
    g = torch.Generator().manual_seed(6)
    return cfg, TE._tree_map(
        lambda t: t + 0.05 * torch.randn(t.shape, generator=g), params)


def _map_leaves(maps):
    return [t for m in sorted(maps) for f, t in sorted(maps[m].items())]


# even prompts: the smoke configs' SSD chunk is 2
SERVED_PROMPTS = [[3, 1, 4, 1, 5, 9], [2, 7, 1, 8]]


@pytest.mark.parametrize("arch,wrong", [(a, False) for a in SERVED_ARCHS]
                         + [("granite-4.0-h-small", True)])
def test_serving_tree_gives_the_per_use_cast_bits(arch, wrong, monkeypatch):
    """ServeEngine on its serving tree (bf16 compute): two prefills into
    two slots, then four probed decode steps, against `prefill_fn` and the
    eager probed decode step over the f32 tree, which cast at every use:
    the same logits, tokens, event rows, map states and cache, bit for
    bit. `wrong`: the mamba mixer's `norm_scale`, which enters f32
    arithmetic, declared as cast: then the bits differ."""
    from repro_torch.models import ssm as SSM
    from repro_torch.serve.steps import make_decode_step
    cfg, params = _bf16_model(arch)
    if wrong:
        monkeypatch.setitem(TMR.CAST_LEAVES, "mamba",
                            SSM.CAST_LEAVES + ("norm_scale",))
    max_seq, V = 32, cfg.vocab_size
    got = {"prefill": [], "decode": []}
    with monkeypatch.context() as mp:
        for name in ("prefill_fn", "decode_fn"):
            def spy(*args, _fn=getattr(TMR, name), _at=name[:-3], **kw):
                out = _fn(*args, **kw)
                got[_at].append(out[0].clone())
                return out
            mp.setattr(TMR, name, spy)
        rt = TRuntime()
        TL.attach_serve_probes(rt, TL.family_probes(cfg))
        engine = TEngine(params, cfg, slots=2, max_seq=max_seq, runtime=rt,
                         device=CPU)
        reqs = [TRequest(rid=i, prompt=list(p), max_new=5)
                for i, p in enumerate(SERVED_PROMPTS)]
        engine.submit_all(reqs)
    assert engine.params is params
    assert engine.step_count == 4 and len(got["prefill"]) == 2

    # the f32 tree through the model's entry points
    rt = TRuntime()
    TL.attach_serve_probes(rt, TL.family_probes(cfg))
    step = make_decode_step(cfg, rt)
    maps = rt.init_device_maps(CPU)
    cache = TMR.make_cache(cfg, 2, max_seq, torch.float32, CPU)
    want = {"prefill": [], "decode": []}
    outs = [[] for _ in SERVED_PROMPTS]
    for s, prompt in enumerate(SERVED_PROMPTS):
        one = TMR.make_cache(cfg, 1, max_seq, torch.float32, CPU)
        logits, one = TMR.prefill_fn(params, {"tokens": torch.tensor(
            [prompt])}, one, cfg)
        want["prefill"].append(logits)
        for full, o in zip(cache["blocks"], one["blocks"]):
            for f in full:
                full[f][:, s] = o[f][:, 0]
        cache["pos"][s] = one["pos"][0]
        outs[s].append(int(torch.argmax(logits[0, -1, :V])))
    for i in range(4):
        toks = torch.tensor([[o[-1]] for o in outs])
        nxt, logits, cache, maps = step(params, toks, cache, maps, i)
        want["decode"].append(logits)
        for o, t in zip(outs, nxt.tolist()):
            o.append(t)

    same = (all(torch.equal(a, b) for k in want
                for a, b in zip(got[k], want[k]))
            and [r.out for r in reqs] == outs
            and torch.equal(engine.last_tape[0], step.last[0])
            and all(torch.equal(a, b) for a, b in zip(
                _map_leaves(engine.maps), _map_leaves(maps)))
            and all(torch.equal(a, b) for a, b in zip(
                TE._tree_leaves(engine.cache), TE._tree_leaves(cache))))
    assert same != wrong
    # the logits are not all alike, so equal bits say something
    assert float(want["decode"][-1].std()) > 1e-4


class _CastsOfLeaves(TorchDispatchMode):
    """Counts the f32 -> bf16 casts whose input shares storage with one of
    `leaves`."""

    def __init__(self, leaves):
        super().__init__()
        self.ptrs = {t.untyped_storage().data_ptr() for t in leaves}
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if (func is torch.ops.aten._to_copy.default
                and args[0].dtype == torch.float32
                and kwargs.get("dtype") == torch.bfloat16
                and args[0].untyped_storage().data_ptr() in self.ptrs):
            self.n += 1
        return func(*args, **kwargs)


class _Counted:
    """The engine's decode callable, run under a dispatch mode."""

    def __init__(self, fn, mode):
        self._fn, self._mode = fn, mode

    def __getattr__(self, name):
        return getattr(self._fn, name)

    def __call__(self, *args):
        with self._mode:
            return self._fn(*args)


def test_a_served_decode_step_casts_no_weight(monkeypatch):
    """One served decode step of the granite smoke cut under a dispatch
    mode: no f32 -> bf16 cast of a parameter's storage on the serving
    tree; on the f32 tree (serving_params turned off) at least one for
    every leaf the tree declares cast. The engine keeps the f32 tree it
    was given, and `serve.compute_weights` counts the leaves cast and kept
    and the bytes held in bf16."""
    from portbench.reference.train import flat
    from repro_torch import telemetry as T
    cfg, params = _bf16_model("granite-4.0-h-small")
    kept_names = {"A_log", "dt_bias", "norm_scale"}
    leaves = flat(params)
    kept = [k for k in leaves if k[-1] in kept_names or any(
        str(n).startswith(("norm", "final_norm")) for n in k)]
    cast = [k for k in leaves if k not in kept]
    counts = {}
    for serving in (True, False):
        with monkeypatch.context() as mp:
            if not serving:
                mp.setattr(TMR, "serving_params", lambda params, cfg: params)
            with T.recording():
                engine = TEngine(params, cfg, slots=2, max_seq=32,
                                 device=CPU)
                record = T.records()["keyed"].get("serve.compute_weights")
            casts = _CastsOfLeaves(TE._tree_leaves(params)
                                   + TE._tree_leaves(engine.serving_params))
            engine._decode = _Counted(engine._decode, casts)
            engine.submit_all([TRequest(rid=0, prompt=[3, 1, 4, 1],
                                        max_new=2)])
        assert engine.step_count == 1
        assert engine.params is params
        counts[serving] = (casts.n, record)
    assert counts[True] == (0, {(len(cast), len(kept), sum(
        2 * leaves[k].numel() for k in cast)): 1})
    assert counts[False][1] is None
    assert counts[False][0] >= len(cast)
    # the MoE's experts and the mixers' projections are among the cast
    assert {k[-1] for k in cast} >= {"w_in", "w_gate", "w_out", "router",
                                     "in_proj", "out_proj", "embedding"}
