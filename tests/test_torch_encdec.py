"""The port's encoder-decoder family (seamless-m4t) against the JAX package,
on the CPU, at smoke width (f32): the encoder at 8 frames (full attention)
and at 4096 (the port's flash attention, non-causal, through its plain
version here; JAX's chunked online softmax), the teacher-forced forward
and the loss, prefill and decode with the cross cache, probed prefill and
decode steps with ENCDEC_PROBES (tapes and maps), and the serving engine
and launcher stopping where the JAX package's do. Weights come from the
JAX package, inputs from a numpy seed, carried across as numpy arrays."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import events as JE, maps as JM  # noqa: E402
from repro.core.runtime import BpftimeRuntime as JRuntime  # noqa: E402
from repro.launch import serve as JLAUNCH  # noqa: E402
from repro.models import encdec as JED, registry as JMR  # noqa: E402
from repro.serve import steps as JSTEPS  # noqa: E402
from repro.serve.engine import Request as JRequest, ServeEngine as JEngine  # noqa: E402,E501

from repro_torch.configs import registry as TCFG  # noqa: E402
from repro_torch.core import events as TE  # noqa: E402
from repro_torch.core.runtime import BpftimeRuntime as TRuntime, to_numpy  # noqa: E402,E501
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve as TLAUNCH  # noqa: E402
from repro_torch.models import encdec as TED, registry as TMR  # noqa: E402
from repro_torch.serve import steps as TSTEPS  # noqa: E402
from repro_torch.serve.engine import Request as TRequest, ServeEngine as TEngine  # noqa: E402,E501

from test_torch_moe import (CPU, MODEL_TOL, STAT_TOL, assert_tapes_match,  # noqa: E402,E501
                            family_wanted, family_weights)

SEAMLESS = "seamless-m4t-medium"
FRAMES = 8


@pytest.fixture(scope="module")
def seamless():
    return family_weights(SEAMLESS)


def frames(cfg, B, S, seed=11):
    return np.random.default_rng(seed).normal(
        size=(B, S, cfg.d_model)).astype(np.float32)


def tokens(cfg, B, S, seed=12):
    return np.random.default_rng(seed).integers(0, cfg.vocab_size, (B, S))


@pytest.mark.parametrize("S", [FRAMES, 4096])
def test_encode_matches_jax(seamless, S, monkeypatch):
    """At 8 frames both packages take full attention; above 2048 the port
    calls ops.flash_attention(causal=False) once a layer and JAX its
    chunked flash formulation."""
    jc, tc, jp, tp = seamless
    calls = []
    flash = ops.flash_attention

    def counted(q, k, v, causal=True):
        calls.append(causal)
        return flash(q, k, v, causal=causal)
    monkeypatch.setattr(ops, "flash_attention", counted)
    emb = frames(jc, 1, S)
    want = JED.encode(jp, jnp.asarray(emb), jc)
    got = TED.encode(tp, torch.as_tensor(emb), tc)
    assert calls == ([False] * tc.enc_layers if S > 2048 else [])
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=MODEL_TOL,
                               atol=MODEL_TOL)


def test_forward_train_and_loss_match_jax(seamless):
    jc, tc, jp, tp = seamless
    emb, toks = frames(jc, 2, FRAMES), tokens(jc, 2, 6)
    labels = tokens(jc, 2, 6, seed=13)
    labels[0, :2] = -1
    jl = JED.forward_train(jp, {"enc_embeds": jnp.asarray(emb),
                                "tokens": jnp.asarray(toks, jnp.int32)}, jc)
    tl = TED.forward_train(tp, {"enc_embeds": torch.as_tensor(emb),
                                "tokens": torch.as_tensor(toks)}, tc)
    assert tl.shape == (2, 6, tc.padded_vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=MODEL_TOL,
                               atol=MODEL_TOL)
    jloss, _ = JMR.loss_fn(jp, {"enc_embeds": jnp.asarray(emb),
                                "tokens": jnp.asarray(toks, jnp.int32),
                                "labels": jnp.asarray(labels, jnp.int32)},
                           jc)
    tloss, _ = TMR.loss_fn(tp, {"enc_embeds": torch.as_tensor(emb),
                                "tokens": torch.as_tensor(toks),
                                "labels": torch.as_tensor(labels)}, tc)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=MODEL_TOL,
                               atol=MODEL_TOL)


def test_make_cache_sizes_the_cross_cache():
    cfg = TCFG.smoke(SEAMLESS)
    c = TMR.make_cache(cfg, 2, 16, torch.float32, CPU, enc_seq=40)
    shape = (cfg.dec_layers, 2, 16, cfg.num_kv_heads, cfg.hd)
    assert tuple(c["k"].shape) == tuple(c["v"].shape) == shape
    assert tuple(c["xk"].shape) == shape[:2] + (40,) + shape[3:]
    assert tuple(TMR.make_cache(cfg, 2, 16, torch.float32, CPU)["xv"]
                 .shape) == shape
    assert c["pos"].dtype == torch.int32 and not c["pos"].any()


def test_prefill_and_decode_match_jax(seamless):
    """Prefill replaces the cross cache with the encoder's length (8
    frames into a cache made for max_seq 16), then two decode steps."""
    jc, tc, jp, tp = seamless
    emb, toks = frames(jc, 2, FRAMES), tokens(jc, 2, 5)
    jl, jcache = JMR.prefill_fn(
        jp, {"enc_embeds": jnp.asarray(emb),
             "tokens": jnp.asarray(toks, jnp.int32)},
        JMR.make_cache(jc, 2, 16, jnp.float32), jc)
    tl, tcache = TMR.prefill_fn(
        tp, {"enc_embeds": torch.as_tensor(emb),
             "tokens": torch.as_tensor(toks)},
        TMR.make_cache(tc, 2, 16, torch.float32, CPU), tc)
    assert tcache["xk"].shape[2] == jcache["xk"].shape[2] == FRAMES
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=MODEL_TOL,
                               atol=MODEL_TOL)
    for _ in range(2):
        nxt = np.asarray(jnp.argmax(jl[:, -1, :jc.vocab_size], -1))[:, None]
        assert (tl[:, -1, :tc.vocab_size].argmax(-1).numpy() == nxt[:, 0]) \
            .all()
        jl, jcache = JMR.decode_fn(jp, jnp.asarray(nxt, jnp.int32), jcache,
                                   jc)
        tl, tcache = TMR.decode_fn(tp, torch.tensor(nxt), tcache, tc)
        np.testing.assert_allclose(tl.numpy(), np.asarray(jl),
                                   rtol=MODEL_TOL, atol=MODEL_TOL)
    assert list(tcache) == list(jcache)
    np.testing.assert_array_equal(tcache["pos"].numpy(),
                                  np.asarray(jcache["pos"]))
    for f in ("k", "v", "xk", "xv"):
        np.testing.assert_allclose(tcache[f].numpy(), np.asarray(jcache[f]),
                                   rtol=MODEL_TOL, atol=MODEL_TOL, err_msg=f)


def _runtimes(tc):
    jrt = JRuntime()
    for name, text, (mname, kind, n, w), target in TLAUNCH.ENCDEC_PROBES:
        spec = JM.MapSpec(mname, JM.MapKind(kind), n, rec_width=w)
        jrt.attach(jrt.load_asm(name, text, [spec], "uprobe"), target,
                   mode="fused")
    trt = TRuntime()
    TLAUNCH.attach_serve_probes(trt, TLAUNCH.family_probes(tc))
    return jrt, trt


def test_probed_prefill_and_decode_steps_match_jax(seamless):
    """make_prefill_step with ENCDEC_PROBES fires enc.in once and
    enc.block once per encoder layer; each decode step decode.logits once.
    Tapes as JAX's (sites, kinds, layers exact; stats within STAT_TOL),
    maps bit for bit but the ring buffer's stat lanes."""
    jc, tc, jp, tp = seamless
    assert TLAUNCH.family_probes(tc) == TLAUNCH.ENCDEC_PROBES
    jrt, trt = _runtimes(tc)
    B = 2
    emb, toks = frames(jc, B, FRAMES), tokens(jc, B, 5)
    # the tapes: every site both runtimes want and SERVE_PROBES' sites,
    # which never fire in this family
    jw = family_wanted(JE, jc) | {(JE.SITES.get_or_create(s), k) for s, k in
                                  (("block", JE.KIND_ENTRY),
                                   ("block", JE.KIND_EXIT),
                                   ("logits", JE.KIND_TRACEPOINT))}
    with JE.Collector(jw) as col:
        JMR.prefill_fn(jp, {"enc_embeds": jnp.asarray(emb),
                            "tokens": jnp.asarray(toks, jnp.int32)},
                       JMR.make_cache(jc, B, 16, jnp.float32), jc)
        jtape = np.asarray(col.take_all_rows())
    jmaps = jrt.init_device_maps()
    jcache = JMR.make_cache(jc, B, 16, jnp.float32)
    jl, jcache, jmaps = JSTEPS.make_prefill_step(jc, jrt)(
        jp, {"enc_embeds": jnp.asarray(emb),
             "tokens": jnp.asarray(toks, jnp.int32)}, jcache, jmaps)
    tmaps = trt.init_device_maps(CPU)
    prefill = TSTEPS.make_prefill_step(tc, trt)
    tl, tcache, tmaps = prefill(
        tp, {"enc_embeds": torch.as_tensor(emb),
             "tokens": torch.as_tensor(toks)},
        TMR.make_cache(tc, B, 16, torch.float32, CPU), tmaps)
    ttape = prefill.last[0].numpy()
    names = [TE.SITES.name_of(int(s)) for s in ttape[:, 0]]
    assert names == ["enc.in"] + ["enc.block"] * tc.enc_layers
    assert ttape[1:, 2].tolist() == list(range(tc.enc_layers))
    assert_tapes_match(ttape, jtape)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=MODEL_TOL,
                               atol=MODEL_TOL)
    jdec = JSTEPS.make_decode_step(jc, jrt)
    tdec = TSTEPS.make_decode_step(tc, trt)
    nxt_j = jnp.argmax(jl[:, -1, :jc.vocab_size], -1)[:, None]
    nxt_t = tl[:, -1, :tc.vocab_size].argmax(-1)[:, None]
    for step in range(3):
        nj, _, jcache, jmaps = jdec(jp, nxt_j.astype(jnp.int32), jcache,
                                    jmaps, jnp.int32(step))
        nt, _, tcache, tmaps = tdec(tp, nxt_t, tcache, tmaps, step)
        rows = tdec.last[0].numpy()
        assert [TE.SITES.name_of(int(s)) for s in rows[:, 0]] == \
            ["decode.logits"]
        assert rows[0, 3] == step
        np.testing.assert_array_equal(nt.numpy(), np.asarray(nj))
        nxt_j, nxt_t = nj[:, None], nt[:, None]
    jm = {n: {f: np.asarray(a) for f, a in st.items()}
          for n, st in jmaps.items()}
    tm = to_numpy(tmaps)
    assert set(tm) == set(jm)
    assert tm["ed_rms_hist"]["bins"].sum() == tc.enc_layers
    assert tm["ed_in_rms_hist"]["bins"].sum() == 1
    assert tm["ed_logits_rb"]["head"][0] == 3
    rb_t, rb_j = tm["ed_logits_rb"], jm["ed_logits_rb"]
    np.testing.assert_allclose(rb_t["data"][:, 2:].astype(np.float64),
                               rb_j["data"][:, 2:].astype(np.float64),
                               rtol=STAT_TOL, atol=1)
    rb_t["data"], rb_j["data"] = rb_t["data"][:, :2], rb_j["data"][:, :2]
    for name in jm:
        for f in jm[name]:
            np.testing.assert_array_equal(tm[name][f], jm[name][f],
                                          err_msg=f"{name}.{f}")


def test_engine_and_launcher_stop_on_enc_embeds_as_jax(seamless):
    """The serving engine builds a prefill batch from tokens alone: both
    packages' engines and launchers raise KeyError: 'enc_embeds' on the
    first prefill."""
    jc, tc, jp, tp = seamless
    prompt = tokens(jc, 1, 5)[0].tolist()
    with pytest.raises(KeyError, match="enc_embeds"):
        JEngine(jp, jc, slots=2, max_seq=32).submit_all(
            [JRequest(rid=0, prompt=list(prompt), max_new=2)])
    with pytest.raises(KeyError, match="enc_embeds"):
        TEngine(tp, tc, slots=2, max_seq=32, device=CPU).submit_all(
            [TRequest(rid=0, prompt=list(prompt), max_new=2)])
    with pytest.raises(KeyError, match="enc_embeds"):
        JLAUNCH.main(["--arch", SEAMLESS])
    with pytest.raises(KeyError, match="enc_embeds"):
        TLAUNCH.main(["--arch", SEAMLESS, "--device", CPU])
