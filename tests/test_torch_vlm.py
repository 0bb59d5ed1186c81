"""The port's M-RoPE and the VLM family (qwen2-vl) against the JAX package,
on the CPU: apply_rope with distinct temporal/height/width ids (which must
differ from plain RoPE; iota ids on all three axes do not), then qwen2-vl
at smoke width (f32) with prepended frontend embeddings and patch-grid
positions through the train logits, the loss, prefill and decode, and
text-only serving with SERVE_PROBES; and the registry's prefill passing
`embeds` on. Weights come from the JAX package, inputs from a numpy seed,
carried across as numpy arrays."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import registry as JCFG  # noqa: E402
from repro.launch import serve as JLAUNCH  # noqa: E402
from repro.models import (layers as JL, registry as JMR,  # noqa: E402
                          transformer as JTF)

from repro_torch.configs import registry as TCFG  # noqa: E402
from repro_torch.launch import serve as TLAUNCH  # noqa: E402
from repro_torch.models import (layers as TL, registry as TMR,  # noqa: E402,E501
                                transformer as TTF)

from test_torch_moe import (CPU, MODEL_TOL, check_served, family_weights,  # noqa: E402,E501
                            serve_both, to_torch)

ROPE_TOL = 1e-6     # one rotation in f32
VLM = "qwen2-vl-72b"
GRID = (2, 4)       # the smoke frontend's 8 patch embeddings


@pytest.fixture(scope="module")
def vlm():
    return family_weights(VLM)


def vlm_batch(cfg, n_text, batch=1, seed=5):
    """Frontend embeddings for the GRID patches, n_text tokens and their
    M-RoPE ids, as numpy arrays."""
    rng = np.random.default_rng(seed)
    rows, cols = GRID
    assert rows * cols == cfg.frontend_tokens
    emb = rng.normal(size=(batch, rows * cols, cfg.d_model)) \
        .astype(np.float32)
    toks = rng.integers(0, cfg.vocab_size, (batch, n_text))
    pos = TL.mrope_grid_positions(rows, cols, n_text, batch).numpy()
    return emb, toks, pos


def jax_batch(emb, toks, pos, **extra):
    return {"embeds": jnp.asarray(emb),
            "tokens": jnp.asarray(toks, jnp.int32),
            "positions": jnp.asarray(pos, jnp.int32),
            **{k: jnp.asarray(v, jnp.int32) for k, v in extra.items()}}


def torch_batch(emb, toks, pos, **extra):
    return {"embeds": torch.as_tensor(emb), "tokens": torch.as_tensor(toks),
            "positions": torch.as_tensor(pos),
            **{k: torch.as_tensor(v) for k, v in extra.items()}}


def test_mrope_matches_jax_and_differs_from_rope():
    jc, tc = JCFG.smoke(VLM), TCFG.smoke(VLM)
    x = np.random.default_rng(0).normal(size=(2, 11, 4, tc.hd)) \
        .astype(np.float32)
    grid = TL.mrope_grid_positions(*GRID, 3, batch=2)
    assert grid.shape == (2, 11, 3)
    assert len({tuple(r) for r in grid[0, :8].tolist()}) == 8
    got = TL.apply_rope(torch.as_tensor(x), grid, tc)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(grid.numpy()), jc)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=ROPE_TOL,
                               atol=ROPE_TOL)
    # plain RoPE of the same tokens (the temporal id, or the sequence
    # index) turns the patches otherwise
    plain = dataclasses.replace(tc, rope_kind="rope")
    seq = torch.arange(11).expand(2, 11)
    for ids in (grid[..., 0], seq):
        other = TL.apply_rope(torch.as_tensor(x), ids, plain)
        assert float((got - other).abs()[:, :8].max()) > 1e-2
    # with the same id on all three axes M-RoPE is plain RoPE
    same = TL.apply_rope(torch.as_tensor(x),
                         seq[..., None].expand(2, 11, 3), tc)
    np.testing.assert_allclose(
        same.numpy(), TL.apply_rope(torch.as_tensor(x), seq, plain).numpy(),
        rtol=ROPE_TOL, atol=ROPE_TOL)


def test_vlm_train_logits_and_loss_match_jax(vlm):
    jc, tc, jp, tp = vlm
    emb, toks, pos = vlm_batch(jc, 6, batch=2)
    labels = np.random.default_rng(6).integers(0, jc.vocab_size,
                                               (2, 8 + 6))
    labels[:, :8] = -1                      # no loss on the patches
    jl, _ = JTF.forward(jp, jnp.asarray(toks, jnp.int32), jc,
                        embeds=jnp.asarray(emb),
                        positions=jnp.asarray(pos, jnp.int32))
    tl, _ = TTF.forward(tp, torch.as_tensor(toks), tc,
                        embeds=torch.as_tensor(emb),
                        positions=torch.as_tensor(pos))
    assert tl.shape == (2, 14, tc.padded_vocab)
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=MODEL_TOL,
                               atol=MODEL_TOL)
    jloss, _ = JMR.loss_fn(jp, jax_batch(emb, toks, pos, labels=labels), jc)
    tloss, _ = TMR.loss_fn(tp, torch_batch(emb, toks, pos, labels=labels),
                           tc)
    np.testing.assert_allclose(float(tloss), float(jloss), rtol=MODEL_TOL,
                               atol=MODEL_TOL)


def test_vlm_prefill_with_embeds_and_decode_match_jax(vlm):
    """A multimodal prefill (8 patches, 6 tokens, grid ids) and two decode
    steps, whose ids are the cache length on all three axes."""
    jc, tc, jp, tp = vlm
    emb, toks, pos = vlm_batch(jc, 6)
    jl, jcache = JMR.prefill_fn(jp, jax_batch(emb, toks, pos),
                                JMR.make_cache(jc, 1, 32, jnp.float32), jc)
    tl, tcache = TMR.prefill_fn(
        tp, torch_batch(emb, toks, pos),
        TMR.make_cache(tc, 1, 32, torch.float32, CPU), tc)
    assert tl.shape == (1, 14, tc.padded_vocab)
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
    assert int(tcache["pos"][0]) == int(jcache["pos"][0]) == 16
    for jb, tb in zip(jcache["blocks"], tcache["blocks"]):
        for f in jb:
            np.testing.assert_allclose(tb[f].numpy(), np.asarray(jb[f]),
                                       rtol=MODEL_TOL, atol=MODEL_TOL)


def test_vlm_serves_as_jax_with_the_serve_probes(vlm):
    tc = vlm[1]
    # per layer: block entry and exit; then logits
    check_served(serve_both(vlm), 2 * tc.num_layers + 1)


def test_prefill_fn_passes_the_frontend_embeddings_on():
    """registry.prefill_fn prepends batch["embeds"], as the JAX package's
    does: 4 embedding rows and 6 tokens give 10 positions of logits."""
    arch = "qwen2-0.5b"
    jc = dataclasses.replace(JCFG.smoke(arch), frontend="vision",
                             frontend_tokens=4)
    tc = dataclasses.replace(TCFG.smoke(arch), frontend="vision",
                             frontend_tokens=4)
    jp = JMR.init_params(jax.random.PRNGKey(0), jc)
    tp = to_torch(jp)
    rng = np.random.default_rng(9)
    emb = rng.normal(size=(1, 4, jc.d_model)).astype(np.float32)
    toks = rng.integers(0, jc.vocab_size, (1, 6))
    jl, _ = JMR.prefill_fn(jp, {"tokens": jnp.asarray(toks, jnp.int32),
                                "embeds": jnp.asarray(emb)},
                           JMR.make_cache(jc, 1, 16, jnp.float32), jc)
    tl, tcache = TMR.prefill_fn(tp, {"tokens": torch.as_tensor(toks),
                                     "embeds": torch.as_tensor(emb)},
                                TMR.make_cache(tc, 1, 16, torch.float32,
                                               CPU), tc)
    assert tuple(jl.shape) == (1, 10, 256)
    assert tuple(tl.shape) == tuple(jl.shape)
    assert int(tcache["pos"][0]) == 10
    np.testing.assert_allclose(tl.numpy(), np.asarray(jl), rtol=MODEL_TOL,
                               atol=MODEL_TOL)


def test_launcher_serves_the_vlm_text_only_as_jax(capsys):
    JLAUNCH.main(["--arch", VLM])
    want = capsys.readouterr().out
    TLAUNCH.main(["--arch", VLM, "--device", CPU])
    got = capsys.readouterr().out
    assert "served 8, rejected 0, decode steps 14" in got
    assert got.splitlines()[0] == want.splitlines()[0]
