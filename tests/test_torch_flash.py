"""CPU evidence for the bf16 flash-attention kernels' arithmetic.

The Hopper kernels (`csrc/flash_attention_sm90.cuh`) run only on the card.
What changes in their arithmetic is where they round: P and dS enter the
tensor cores as bf16, split into two terms (hi = bf16(x), lo = bf16(x -
hi)) whose products are summed in the f32 accumulator, so each carries
about 16 bits; every accumulator stays f32. `model_fwd` and `model_bwd`
below repeat those rounding points in a few lines of PyTorch on the CPU;
the tests hold the model, at the kernels' bf16 tolerances
(`flash_attention.TOL_*`, shared with `tests/test_torch_cuda.py`),
against the Pallas kernels in interpret mode
and against the port's plain versions, and show that one bf16 term alone,
as SDPA rounds P, does not hold o's tolerance. They also check the
wrapper's dispatch by type without launching anything.
"""
import math
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import flash_attention as JFA  # noqa: E402

from repro_torch.kernels import flash_attention as TFA, ref  # noqa: E402

F32, BF16 = torch.float32, torch.bfloat16
TILE = 64        # the kernels' kv tile: the forward's online-softmax step
NEG = -1e30


def _bf16(t):
    """Round an f32 tensor to bf16 and back."""
    return t.to(BF16).to(F32)


def _split(t):
    """P or dS as the kernels feed it to the tensor cores: hi + lo, two
    bf16 terms."""
    hi = _bf16(t)
    return hi + _bf16(t - hi)


def _mask(q0, nq, k0, nk, causal):
    qpos = q0 + torch.arange(nq)[:, None]
    kpos = k0 + torch.arange(nk)[None, :]
    return (qpos >= kpos) if causal else torch.ones(nq, nk, dtype=torch.bool)


def model_fwd(q, k, v, causal, rep, rnd=_split):
    """The bf16 forward kernel's arithmetic on [BH, S, hd] bf16 tensors:
    f32 scores and online softmax over 64-key tiles, P rounded by `rnd`
    before P V, an f32 accumulator; o in bf16, lse in f32."""
    q, ke, ve = q.float(), ref._kv_per_q_head(k, rep), \
        ref._kv_per_q_head(v, rep)
    BH, Sq, hd = q.shape
    scale = 1.0 / math.sqrt(hd)
    m = torch.full((BH, Sq, 1), NEG)
    l = torch.zeros((BH, Sq, 1))
    acc = torch.zeros((BH, Sq, hd))
    for k0 in range(0, ke.shape[1], TILE):
        kt, vt = ke[:, k0:k0 + TILE], ve[:, k0:k0 + TILE]
        s = torch.matmul(q, kt.transpose(1, 2)) * scale
        s = torch.where(_mask(0, Sq, k0, kt.shape[1], causal), s, NEG)
        m_new = torch.maximum(m, s.amax(-1, keepdim=True))
        corr, p = torch.exp(m - m_new), torch.exp(s - m_new)
        l = l * corr + p.sum(-1, keepdim=True)
        acc = acc * corr + torch.matmul(rnd(p), vt)
        m = m_new
    l = l.clamp_min(1e-30)
    return (acc / l).to(BF16), (m + torch.log(l))[..., 0]


def model_bwd(q, k, v, o, lse, do, causal, rep, rows=256):
    """The bf16 backward kernels' arithmetic: delta from the stored o, P
    from lse in f32, dS = P (dP - delta) scale in f32, P and dS split into
    two bf16 terms before P^T dO, dS^T Q and dS K; f32 accumulators, the
    rep-group sum of dk and dv in f32, rounded once."""
    BH, Sq, hd = q.shape
    BKH, Skv, _ = k.shape
    scale = 1.0 / math.sqrt(hd)
    delta = (do.float() * o.float()).sum(-1)
    ke, ve = ref._kv_per_q_head(k, rep), ref._kv_per_q_head(v, rep)
    dq = torch.empty((BH, Sq, hd))
    dk_h, dv_h = torch.zeros((BH, Skv, hd)), torch.zeros((BH, Skv, hd))
    for q0 in range(0, Sq, rows):
        qc, doc = q[:, q0:q0 + rows].float(), do[:, q0:q0 + rows].float()
        s = torch.matmul(qc, ke.transpose(1, 2)) * scale
        p = torch.exp(s - lse[:, q0:q0 + rows, None])
        p = torch.where(_mask(q0, qc.shape[1], 0, Skv, causal), p, 0.0)
        dp = torch.matmul(doc, ve.transpose(1, 2))
        ds = p * (dp - delta[:, q0:q0 + rows, None]) * scale
        pb, dsb = _split(p), _split(ds)
        dv_h += torch.matmul(pb.transpose(1, 2), doc)
        dk_h += torch.matmul(dsb.transpose(1, 2), qc)
        dq[:, q0:q0 + rows] = torch.matmul(dsb, ke)
    dk = dk_h.reshape(BKH, rep, Skv, hd).sum(1)
    dv = dv_h.reshape(BKH, rep, Skv, hd).sum(1)
    return dq.to(BF16), dk.to(BF16), dv.to(BF16)


def _inputs(BH, BKH, S, hd, seed):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal((n, S, hd))
                            .astype(np.float32)).to(BF16)
            for n in (BH, BKH, BKH, BH)]


def _close(got, want, tol, what, scale=1.0, norm_tol=None):
    """|got - want| <= atol * scale + rtol |want| everywhere, and, given
    norm_tol, within it in relative 2-norm."""
    g, w = np.asarray(got, np.float32), np.asarray(want, np.float32)
    np.testing.assert_allclose(g, w, rtol=tol[0], atol=tol[1] * scale,
                               err_msg=what)
    if norm_tol is not None:
        rel = np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30)
        assert rel <= norm_tol, f"{what}: relative norm {rel:.3e}"


def _grads_close(got, want, what):
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        w = np.asarray(w, np.float32)
        _close(g, w, TFA.TOL_BF16_GRAD, f"{what} {name}",
               scale=max(1.0, float(np.abs(w).max())),
               norm_tol=TFA.TOL_BF16_NORM)


def _np(t):
    return t.float().numpy()


@pytest.mark.parametrize("shape", [
    (2, 2, 128, 32),      # (BH, BKH, S, hd): MHA
    (8, 4, 256, 16),      # GQA rep 2
    (7, 1, 192, 64),      # GQA rep 7, as qwen2-0.5b
])
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_model_matches_pallas_interpret(shape, causal):
    BH, BKH, S, hd = shape
    rep = BH // BKH
    q, k, v, do = _inputs(BH, BKH, S, hd, sum(shape) + causal)
    jin = [jnp.asarray(_np(t)).astype(jnp.bfloat16) for t in (q, k, v, do)]
    jo, jlse = JFA.flash_fwd(*jin[:3], causal=causal, lq=64, lkv=64,
                             rep=rep, interpret=True)
    o, lse = model_fwd(q, k, v, causal, rep)
    _close(_np(o), np.asarray(jo.astype(jnp.float32)), TFA.TOL_BF16_O,
           "o vs Pallas")
    _close(lse.numpy(), np.asarray(jlse), TFA.TOL_LSE, "lse vs Pallas")
    # both backwards from the model's o and lse, as the kernels run
    jg = JFA.flash_bwd(*jin[:3], jnp.asarray(_np(o)).astype(jnp.bfloat16),
                       jnp.asarray(lse.numpy()), jin[3], causal=causal,
                       lq=64, lkv=64, rep=rep, interpret=True)
    got = model_bwd(q, k, v, o, lse, do, causal, rep)
    assert all(g.dtype == BF16 for g in got)
    _grads_close([_np(g) for g in got],
                 [np.asarray(w.astype(jnp.float32)) for w in jg],
                 "vs Pallas")


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_model_matches_plain_at_path_heads(causal):
    """B 1, S 1024, 14 q / 2 kv heads, hd 64: the model against the plain
    versions that the card tests hold the kernels to, at their
    tolerances."""
    BH, BKH, S, hd = 14, 2, 1024, 64
    q, k, v, do = _inputs(BH, BKH, S, hd, 13 + causal)
    o, lse = model_fwd(q, k, v, causal, BH // BKH)
    wo, wlse = ref.flash_fwd(q, k, v, causal, BH // BKH)
    _close(_np(o), _np(wo), TFA.TOL_BF16_O, "o vs plain")
    _close(lse.numpy(), wlse.numpy(), TFA.TOL_LSE, "lse vs plain")
    got = model_bwd(q, k, v, o, lse, do, causal, BH // BKH)
    want = ref.flash_bwd(q, k, v, o, lse, do, causal, BH // BKH)
    _grads_close([_np(g) for g in got], [_np(w) for w in want], "vs plain")


def test_one_bf16_term_misses_o_tolerance():
    """Why the kernels split P: rounded once to bf16 (as SDPA does), P
    puts o outside its unchanged tolerance on these inputs, where the two
    terms stay well inside it."""
    BH, BKH, S, hd = 14, 2, 1024, 64
    q, k, v, _ = _inputs(BH, BKH, S, hd, 2)
    wo = ref.flash_fwd(q, k, v, True, BH // BKH)[0].float()
    rtol, atol = TFA.TOL_BF16_O

    def worst(rnd):
        o = model_fwd(q, k, v, True, BH // BKH, rnd)[0].float()
        return float(((o - wo).abs() / (atol + rtol * wo.abs())).max())
    assert worst(_bf16) > 1.0
    assert worst(_split) < 0.5


@pytest.mark.parametrize("dtype,family", [(BF16, "sm90_wgmma"),
                                          (F32, "fma_f32")])
def test_wrapper_routes_by_type(dtype, family):
    assert TFA.route(dtype) == family


@pytest.mark.parametrize("dtype", [torch.float16, torch.float64,
                                   torch.int32])
def test_wrapper_refuses_other_types(dtype):
    with pytest.raises(TypeError, match="f32 or bf16"):
        TFA.route(dtype)
    q = torch.zeros(2, 64, 16, dtype=dtype)
    with pytest.raises(TypeError, match="f32 or bf16"):
        TFA.flash_fwd_cuda(q, q, q)


def test_entry_points_dispatch_bf16_to_sm90_and_f32_to_fma():
    """The C entry points take the `bf16` flag that `route` sets: bf16 to
    the Hopper launchers, f32 to the FMA kernels, which take only f32."""
    csrc = Path(TFA.__file__).with_name("csrc")
    src = (csrc / "flash_attention.cu").read_text()
    head = (csrc / "flash_attention_sm90.cuh").read_text()
    for hd in TFA.HEAD_DIMS:
        assert f"case {hd}: return bf16 ? BF16({hd}) : F32({hd});" in src
    for launcher, kernels in (("fwd_bf16", ("sm90::fwd_kernel<HD>",)),
                              ("bwd_bf16", ("sm90::dkv_kernel<HD>",
                                            "sm90::dq_kernel<HD>")),
                              ("fwd_f32", ("flash_fwd_kernel<HD>",)),
                              ("bwd_f32", ("flash_dkv_kernel<HD>",
                                           "flash_dq_kernel<HD>"))):
        body = src[src.index(f"int {launcher}("):]
        body = body[:body.index("\n}\n")]
        assert all(k in body for k in kernels), launcher
    assert "flash_fwd_kernel(const float* __restrict__ q" in src
    for kernel in ("fwd_kernel", "dkv_kernel", "dq_kernel"):
        assert f"\n{kernel}(const bf16* __restrict__ q" in head
    assert "atomicAdd" not in head and "atom." not in head
