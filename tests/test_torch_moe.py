"""The port's MoE layer and the MoE family against the JAX package, on the
CPU: routing (integers bit for bit at a capacity that drops, ties
included), the expert FFN, combine, the router's probe values and the
load-balance loss; then llama4-scout at smoke width (f32) through prefill,
decode, the loss and serving with the MoE probes. Weights and inputs come
from the JAX package or a numpy seed, carried across as numpy arrays.

The family helpers here are shared with tests/test_torch_ssm.py."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import registry as JCFG  # noqa: E402
from repro.core import events as JE, maps as JM  # noqa: E402
from repro.core.runtime import BpftimeRuntime as JRuntime  # noqa: E402
from repro.models import moe as JMOE, registry as JMR  # noqa: E402
from repro.serve.engine import Request as JRequest, ServeEngine as JEngine  # noqa: E402,E501

from repro_torch.configs import registry as TCFG  # noqa: E402
from repro_torch.core import events as TE  # noqa: E402
from repro_torch.core.runtime import BpftimeRuntime as TRuntime, to_numpy  # noqa: E402,E501
from repro_torch.launch import serve as TL  # noqa: E402
from repro_torch.models import moe as TMOE, registry as TMR  # noqa: E402
from repro_torch.serve.engine import ServeEngine as TEngine  # noqa: E402

CPU = "cpu"
TOL = 1e-5          # one layer (f32)
MODEL_TOL = 1e-4    # a whole model's logits, caches and loss (f32)
STAT_TOL = 2e-5     # the collector's Q47.16 stat lanes
ADMIT_LIMIT = 12
LLAMA4 = "llama4-scout-17b-a16e"
KIMI = "kimi-k2-1t-a32b"
# kimi-k2 at 16 experts and k = 8 (registry.smoke caps k at 2): combine
# adds eight contributions a token
KIMI_K8 = dict(num_experts=16, experts_per_token=8)
INFO_INTS = ("gids", "sort_idx", "sorted_eids", "pos_c", "tok_idx", "keep")


def both_cfgs(arch, **over):
    return (dataclasses.replace(JCFG.smoke(arch), **over),
            dataclasses.replace(TCFG.smoke(arch), **over))


def to_torch(tree):
    return TMR.params_from_numpy(jax.tree.map(np.asarray, tree), CPU)


# ------------------------------------------------------------ the MoE layer

def _moe_case(arch, tie, **over):
    """Both configs (capacity factor 0.5 unless `over` says otherwise, so
    the capacity drops), the layer's weights in each package and x [2, 32,
    D]. tie: router columns 1 and 2 are zero, so experts 1 and 2 get
    exactly equal gates, and they meet at the top-k boundary in some
    rows."""
    jc, tc = both_cfgs(arch, **{"capacity_factor": 0.5, **over})
    npp = jax.tree.map(np.asarray, JMOE.init_moe(jax.random.PRNGKey(1), jc))
    npp = {k: np.array(v) for k, v in npp.items()}
    if tie:
        npp["router"][:, 1:3] = 0.0
    x = np.random.default_rng(7).normal(size=(2, 32, jc.d_model)) \
        .astype(np.float32)
    return jc, tc, npp, TMR.params_from_numpy(npp, CPU), x


ROUTE_CASES = [(LLAMA4, {}), ("jamba-v0.1-52b", {}), (KIMI, KIMI_K8),
               (KIMI, dict(KIMI_K8, capacity_factor=1.0))]


@pytest.mark.parametrize("tie", [False, True], ids=["random", "tie"])
@pytest.mark.parametrize("arch,over", ROUTE_CASES,
                         ids=["top1", "top2", "top8", "top8-cf1"])
def test_route_integers_match_jax_at_a_dropping_capacity(arch, over, tie):
    jc, tc, npp, tp, x = _moe_case(arch, tie, **over)
    jd, ji = JMOE.route(npp, jnp.asarray(x), jc)
    td, ti = TMOE.route(tp, torch.as_tensor(x), tc)
    assert TMOE.capacity(tc, 64) == JMOE.capacity(jc, 64)
    for k in INFO_INTS:
        np.testing.assert_array_equal(ti[k].numpy(), np.asarray(ji[k]),
                                      err_msg=k)
    assert ti["T"] == ji["T"]
    assert int((~ti["keep"]).sum()) > 0, "the capacity should drop"
    if tie:
        gids = ti["gids"].numpy()
        # rows where expert 1 won the tie for the last slot over expert 2
        assert ((gids[:, -1] == 1) & ~(gids == 2).any(-1)).any()
    np.testing.assert_allclose(ti["gvals"].numpy(), np.asarray(ji["gvals"]),
                               rtol=TOL, atol=TOL)
    np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=TOL,
                               atol=TOL)
    # combine of the same expert outputs through each package's route
    out_e = np.random.default_rng(8).normal(size=td.shape).astype(np.float32)
    np.testing.assert_allclose(
        TMOE.combine(torch.as_tensor(out_e), ti).numpy(),
        np.asarray(JMOE.combine(jnp.asarray(out_e), ji)), rtol=TOL,
        atol=TOL)


def _probe_rows(E, fn):
    """fn() under a collector that wants moe.load and moe.drops; returns
    (fn's result, the tape)."""
    wanted = {(E.SITES.get_or_create(s), E.KIND_TRACEPOINT)
              for s in ("moe.load", "moe.drops")}
    with E.Collector(wanted) as col:
        out = fn()
        return out, np.asarray(col.take_all_rows())


def assert_tapes_match(tr, jr):
    """Integer lanes exact (the site by name: each package numbers its
    sites in the order it met them), stat lanes within STAT_TOL."""
    assert tr.shape == jr.shape
    assert [TE.SITES.name_of(int(s)) for s in tr[:, 0]] == \
        [JE.SITES.name_of(int(s)) for s in jr[:, 0]]
    ints = [1, 2, 3, 4, 10, 11, 12, 13, 14, 15]
    np.testing.assert_array_equal(tr[:, ints], jr[:, ints])
    np.testing.assert_allclose(tr[:, 5:10].astype(np.float64),
                               jr[:, 5:10].astype(np.float64),
                               rtol=STAT_TOL, atol=STAT_TOL * TE.FX_ONE)


@pytest.mark.parametrize("arch,over", ROUTE_CASES[:3],
                         ids=["top1", "top2", "top8"])
def test_apply_moe_probes_and_aux_loss_match_jax(arch, over):
    jc, tc, npp, tp, x = _moe_case(arch, tie=False, **over)
    jy, jr = _probe_rows(
        JE, lambda: JMOE.apply_moe(npp, jnp.asarray(x), jc))
    ty, tr = _probe_rows(
        TE, lambda: TMOE.apply_moe(tp, torch.as_tensor(x), tc))
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=TOL,
                               atol=TOL)
    assert tr.shape == (2, TE.EVENT_WIDTH)
    assert_tapes_match(tr, jr)
    # moe.load sums to T*k assignments; moe.drops is their overflow
    load_sum = tr[0, 5] * tr[0, 4] / TE.FX_ONE
    assert load_sum == pytest.approx(64 * tc.experts_per_token)
    assert tr[1, 5] > 0
    np.testing.assert_allclose(
        float(TMOE.aux_load_balance_loss(tp, torch.as_tensor(x), tc)),
        float(JMOE.aux_load_balance_loss(npp, jnp.asarray(x), jc)),
        rtol=TOL, atol=TOL)


def test_unprobed_moe_computes_no_router_stats():
    """With no collector active the router's probe values are not made
    (the JAX graph drops them as dead code)."""
    _, tc, _, tp, x = _moe_case(LLAMA4, tie=False)
    calls = []
    orig = TMOE.expert_load
    try:
        TMOE.expert_load = lambda *a: calls.append(1) or orig(*a)
        TMOE.apply_moe(tp, torch.as_tensor(x), tc)
        assert calls == []
        _probe_rows(TE, lambda: TMOE.apply_moe(tp, torch.as_tensor(x), tc))
        assert calls == [1]
    finally:
        TMOE.expert_load = orig


# ------------------------------------------------------------ whole families

def family_weights(arch, **over):
    jc, tc = both_cfgs(arch, **over)
    jp = JMR.init_params(jax.random.PRNGKey(0), jc)
    return jc, tc, jp, to_torch(jp)


def family_wanted(E, cfg):
    """The (site, kind) pairs the family's serving probes attach to."""
    kinds = {"uprobe": E.KIND_ENTRY, "uretprobe": E.KIND_EXIT,
             "probe": E.KIND_TRACEPOINT}
    out = set()
    for *_, target in TL.family_probes(cfg):
        kind, site = target.split(":")
        out.add((E.SITES.get_or_create(site), kinds[kind]))
    return out


def check_family_forward(weights):
    """Prefill (an even length: the SSD chunk of the smoke configs is 2),
    three decode steps with the family's probe sites collected, and
    loss_fn, against the JAX package."""
    jc, tc, jp, tp = weights
    rng = np.random.default_rng(3)
    prompt = rng.integers(0, jc.vocab_size, (2, 6))
    jcache = JMR.make_cache(jc, 2, 16, jnp.float32)
    tcache = TMR.make_cache(tc, 2, 16, torch.float32, CPU)
    jl, jcache = JMR.prefill_fn(jp, {"tokens": jnp.asarray(prompt,
                                                           jnp.int32)},
                                jcache, jc)
    tl, tcache = TMR.prefill_fn(tp, {"tokens": torch.as_tensor(prompt)},
                                tcache, tc)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=MODEL_TOL,
                               atol=MODEL_TOL)
    jw, tw = family_wanted(JE, jc), family_wanted(TE, tc)
    for _ in range(3):
        nxt = np.asarray(jnp.argmax(jl[:, -1, :jc.vocab_size], -1))
        assert (tl[:, -1, :tc.vocab_size].argmax(-1).numpy() == nxt).all()
        with JE.Collector(jw) as jcol:
            jl, jcache = JMR.decode_fn(jp, jnp.asarray(nxt[:, None],
                                                       jnp.int32), jcache,
                                       jc)
            jr = np.asarray(jcol.take_all_rows())
        with TE.Collector(tw) as tcol:
            tl, tcache = TMR.decode_fn(tp, torch.tensor(nxt[:, None]),
                                       tcache, tc)
            tr = tcol.take_all_rows().numpy()
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   rtol=MODEL_TOL, atol=MODEL_TOL)
        assert tr.shape[0] > 0
        assert_tapes_match(tr, jr)
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    for jb, tb in zip(jcache["blocks"], tcache["blocks"]):
        assert set(jb) == set(tb)
        for f in jb:
            assert tb[f].dtype == getattr(torch, str(jb[f].dtype))
            np.testing.assert_allclose(tb[f].numpy(), np.asarray(jb[f]),
                                       rtol=MODEL_TOL, atol=MODEL_TOL,
                                       err_msg=f)
    toks, labels = rng.integers(0, jc.vocab_size, (2, 2, 8))
    labels[0, :2] = -1
    jloss, _ = JMR.loss_fn(jp, {"tokens": jnp.asarray(toks, jnp.int32),
                                "labels": jnp.asarray(labels, jnp.int32)},
                           jc)
    tloss, _ = TMR.loss_fn(tp, {"tokens": torch.as_tensor(toks),
                                "labels": torch.as_tensor(labels)}, tc)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=MODEL_TOL,
                               atol=MODEL_TOL)


def even_requests(cfg, n=8, max_new=8):
    """launch/serve.make_requests with each prompt cut to an even length
    (the smoke configs' SSD chunk is 2)."""
    reqs = TL.make_requests(n, max_new, cfg.vocab_size)
    for r in reqs:
        del r.prompt[len(r.prompt) // 2 * 2:]
    return reqs


def serve_both(weights):
    """The JAX and the port's engines, each with the admission filter and
    the family's probes on the fused lane, over the same requests."""
    jc, tc, jp, tp = weights
    probes = TL.family_probes(tc)
    jrt = JRuntime()
    jrt.attach(jrt.load_asm("admit", TL.admit_filter_text(ADMIT_LIMIT), [],
                            "filter"), "filter:sys_serve_admit")
    for name, text, (mname, kind, n, w), target in probes:
        spec = JM.MapSpec(mname, JM.MapKind(kind), n, rec_width=w)
        jrt.attach(jrt.load_asm(name, text, [spec], "uprobe"), target,
                   mode="fused")
    trt = TRuntime()
    trt.attach(trt.load_asm("admit", TL.admit_filter_text(ADMIT_LIMIT), [],
                            "filter"), "filter:sys_serve_admit")
    TL.attach_serve_probes(trt, probes)
    reqs_t = even_requests(tc)
    reqs_j = [JRequest(rid=r.rid, prompt=list(r.prompt), max_new=r.max_new)
              for r in reqs_t]
    je = JEngine(jp, jc, slots=4, max_seq=128, runtime=jrt)
    je.submit_all(reqs_j)
    te = TEngine(tp, tc, slots=4, max_seq=128, runtime=trt, device=CPU)
    te.submit_all(reqs_t)
    return je, reqs_j, te, reqs_t


def check_served(served, events_per_step):
    """Same admission and tokens, and every map bit for bit but the logits
    ring buffer's rms and absmax lanes, Q47.16 stats (within STAT_TOL)."""
    je, reqs_j, te, reqs_t = served
    assert [r.rejected for r in reqs_t] == [r.rejected for r in reqs_j]
    assert any(r.rejected for r in reqs_t) and not all(
        r.rejected for r in reqs_t)
    assert [r.out for r in reqs_t] == [r.out for r in reqs_j]
    assert te.step_count == je.step_count
    assert te.events == te.step_count * events_per_step
    jm = {n: {f: np.asarray(a) for f, a in st.items()}
          for n, st in je.maps.items()}
    tm = to_numpy(te.maps)
    assert set(tm) == set(jm)
    rb_t, rb_j = tm["sv_logits_rb"], jm["sv_logits_rb"]
    np.testing.assert_allclose(rb_t["data"][:, 2:].astype(np.float64),
                               rb_j["data"][:, 2:].astype(np.float64),
                               rtol=STAT_TOL, atol=1)
    rb_t["data"], rb_j["data"] = rb_t["data"][:, :2], rb_j["data"][:, :2]
    for name in jm:
        for f in jm[name]:
            np.testing.assert_array_equal(tm[name][f], jm[name][f],
                                          err_msg=f"{name}.{f}")
    return tm


@pytest.fixture(scope="module")
def llama4():
    return family_weights(LLAMA4)


def test_llama4_forward_decode_and_loss_match_jax(llama4):
    check_family_forward(llama4)


# the configs no other test names, each on its own path: LayerNorm, a
# non-gated GeLU and learned biases (starcoder2); tied embeddings (phi4-mini,
# llama3.2); 16 experts at k = 8 (kimi-k2)
OTHER_FAMILY_CASES = [("starcoder2-15b", {}), ("phi4-mini-3.8b", {}),
                      ("llama3.2-1b", {}), (KIMI, KIMI_K8)]


@pytest.mark.parametrize("arch,over", OTHER_FAMILY_CASES,
                         ids=["starcoder2-15b", "phi4-mini-3.8b",
                              "llama3.2-1b", "kimi-k2-16e-top8"])
def test_family_forward_decode_and_loss_match_jax(arch, over):
    check_family_forward(family_weights(arch, **over))


def test_llama4_serves_as_jax_with_the_moe_probes(llama4):
    tc = llama4[1]
    # per layer: block entry and exit, moe.load, moe.drops; then logits
    tm = check_served(serve_both(llama4), 4 * tc.num_layers + 1)
    steps = tm["sv_logits_rb"]["head"][0]
    assert tm["load_hist"]["bins"].sum() == tc.num_layers * steps
    assert tm["total_drops"]["values"][0] == 0    # capacity 8 >= 4 tokens


def test_only_encdec_and_mrope_wait_and_no_cuda_means_no_model():
    """Every family builds its parameters and cache on the CPU when asked
    (the encoder-decoder and M-RoPE families no longer wait for a later
    slice), and asks for CUDA otherwise."""
    for arch in (LLAMA4, "mamba2-780m", "jamba-v0.1-52b",
                 "seamless-m4t-medium", "qwen2-vl-72b"):
        cfg = TCFG.smoke(arch)
        TMR.init_params(cfg, device=CPU)
        TMR.make_cache(cfg, 1, 8, torch.float32, CPU)
        if not torch.cuda.is_available():
            with pytest.raises(RuntimeError, match="CUDA"):
                TMR.init_params(cfg)
            with pytest.raises(RuntimeError, match="CUDA"):
                TMR.make_cache(cfg, 1, 8, torch.float32)


def test_launcher_serves_a_moe_model(capsys):
    TL.main(["--arch", LLAMA4, "--device", CPU, "--requests", "4",
             "--max-new", "4"])
    assert "served 4, rejected 0" in capsys.readouterr().out
