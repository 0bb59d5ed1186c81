"""The port's Hopper kernels against their plain PyTorch versions, on the
card. Every test is marked `cuda` and skips without a CUDA device. This
file imports no JAX, so it also runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.core import maps as M  # noqa: E402
from repro_torch.kernels import (hash_update as TH, ref as TREF,  # noqa: E402
                                 ringbuf_emit as TRB, tensor_stats as TTS)

TOL = 2e-5
STATS = ("mean", "rms", "min", "max", "absmax")

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    return torch.device("cuda")


@pytest.mark.parametrize("shape", [(4, 1, 896), (4, 1, 152064), (1 << 22,),
                                   (1,), (1027,)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tensor_stats_kernel_matches_plain(cuda, shape, dtype):
    g = torch.Generator(device=cuda).manual_seed(0)
    x = torch.randn(shape, generator=g, device=cuda) * 5
    x.view(-1)[:3] = torch.tensor([float("nan"), float("inf"),
                                   float("-inf")], device=cuda)[:x.numel()]
    x = x.to(getattr(torch, dtype))
    got = TTS.tensor_stats_cuda(x)
    want = TREF.tensor_stats(x)
    for k in STATS:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=TOL,
                                   atol=TOL, err_msg=k)
    assert int(got["nan_cnt"]) == int(want["nan_cnt"])
    assert int(got["inf_cnt"]) == int(want["inf_cnt"])
    again = TTS.tensor_stats_cuda(x)
    assert all(torch.equal(got[k], again[k]) for k in got)


def test_tensor_stats_kernel_unaligned_view(cuda):
    """A contiguous view that starts off a 16-byte boundary takes the
    kernel's scalar path."""
    base = torch.randn(4097, device=cuda)
    x = base[1:]
    assert x.data_ptr() % 16 != 0
    got, want = TTS.tensor_stats_cuda(x), TREF.tensor_stats(x)
    for k in STATS:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=TOL,
                                   atol=TOL, err_msg=k)


def _hash_inputs(seed, n, batch, *, tombstones, full):
    rng = np.random.default_rng(seed)
    st = M.init_state_np(M.MapSpec("h", M.MapKind.HASH, n))
    resident = rng.choice(1 << 40, size=n if full else n // 2,
                          replace=False) - (1 << 39)
    for k in resident:
        M.n_hash_update(st, int(k), int(rng.integers(-100, 100)))
    if tombstones:
        for k in resident[: len(resident) // 3]:
            M.n_hash_delete(st, int(k))
    pool = np.concatenate([resident, rng.integers(-(1 << 62), 1 << 62,
                                                  max(batch // 4, 1))])
    keys = pool[rng.integers(0, pool.size, batch)]
    deltas = rng.integers(-(1 << 62), 1 << 62, batch)
    valid = rng.random(batch) < 0.85
    return st, keys, deltas, valid


@pytest.mark.parametrize("case", [dict(tombstones=False, full=False),
                                  dict(tombstones=True, full=False),
                                  dict(tombstones=False, full=True)],
                         ids=["plain", "tombstones", "full"])
def test_hash_kernel_matches_plain_and_numpy(cuda, case):
    st, keys, deltas, valid = _hash_inputs(5, 256, 512, **case)
    args = [torch.as_tensor(a, device=cuda) for a in
            (st["keys"], st["used"], st["values"], keys, deltas, valid)]
    got = TH.hash_fetch_add_batch_cuda(*args)
    oracle = {f: a.copy() for f, a in st.items()}
    M.n_hash_fetch_add_batch(oracle, keys, deltas, valid)
    for f, g, w in zip(("keys", "used", "values"), got,
                       TREF.hash_fetch_add_batch(*args)):
        assert torch.equal(g, w), f
        np.testing.assert_array_equal(g.cpu().numpy(), oracle[f])


@pytest.mark.parametrize("batch", [0, 40, 4096])
def test_ringbuf_kernel_matches_plain(cuda, batch):
    rng = np.random.default_rng(batch)
    args = [torch.as_tensor(a, device=cuda) for a in (
        rng.integers(-5, 5, (64, 4)), np.array([70]),
        rng.integers(-99, 99, (batch, 4)).reshape(batch, 4),
        rng.random(batch) < 0.6)]
    for g, w in zip(TRB.ringbuf_emit_batch_cuda(*args),
                    TREF.ringbuf_emit_batch(*args)):
        assert torch.equal(g, w)


# ------------------------------------------------------ flash attention

def _flash_case(cuda, BH, BKH, S, hd, dtype, seed):
    g = torch.Generator(device=cuda).manual_seed(seed)
    mk = lambda n: torch.randn(n, S, hd, generator=g,  # noqa: E731
                               device=cuda).to(getattr(torch, dtype))
    return mk(BH), mk(BKH), mk(BKH), mk(BH)


# (BH, BKH, S, hd): GQA rep 1, 2 and 7; S off the 64-row tile; the path's
# head dim 64 and the smoke config's 16; one batch row of the training
# path's shape (S 4096, 14 q / 2 kv heads)
FLASH_CASES = [(4, 4, 128, 32), (8, 4, 256, 16), (14, 2, 200, 64),
               (28, 4, 1024, 64), (4, 2, 100, 128), (14, 2, 4096, 64)]


@pytest.mark.parametrize("case", FLASH_CASES,
                         ids=["-".join(map(str, c)) for c in FLASH_CASES])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [True, False])
def test_flash_kernels_match_plain(cuda, case, dtype, causal):
    from repro_torch.kernels import flash_attention as TFA
    torch.backends.cuda.matmul.allow_tf32 = False
    BH, BKH, S, hd = case
    q, k, v, do = _flash_case(cuda, BH, BKH, S, hd, dtype, sum(case))
    rep = BH // BKH
    o, lse = TFA.flash_fwd_cuda(q, k, v, causal)
    wo, wlse = TREF.flash_fwd(q, k, v, causal, rep)
    # (rtol, atol) of o, lse and the gradients, whose atol scales with
    # their largest magnitude (TFA.TOL_*): f32 as test_flash_kernel.py;
    # bf16 one rounding of o apart, lse (f32 on both sides) within 1e-4,
    # gradients with P and dS rounded to bf16 and the rep-group sum rounded
    # once in the kernel, and within 1e-2 in relative norm
    if dtype == "float32":
        tf, tb = TFA.TOL_F32
        o_tol, lse_tol, g_tol, norm_tol = (tf, tf), (tf, tf), (tb, tb), None
    else:
        o_tol, lse_tol, g_tol, norm_tol = (TFA.TOL_BF16_O, TFA.TOL_LSE,
                                           TFA.TOL_BF16_GRAD,
                                           TFA.TOL_BF16_NORM)
    np.testing.assert_allclose(o.float().cpu().numpy(),
                               wo.float().cpu().numpy(), *o_tol)
    np.testing.assert_allclose(lse.cpu().numpy(), wlse.cpu().numpy(),
                               *lse_tol)
    got = TFA.flash_bwd_cuda(q, k, v, o, lse, do, causal)
    want = TREF.flash_bwd(q, k, v, o, lse, do, causal, rep)
    again = TFA.flash_bwd_cuda(q, k, v, o, lse, do, causal)
    for name, g_, w_, a_ in zip(("dq", "dk", "dv"), got, want, again):
        assert g_.dtype == q.dtype and g_.shape == w_.shape
        assert torch.equal(g_, a_), f"{name} differs between two runs"
        g32, w32 = g_.float(), w_.float()
        scale = max(1.0, float(w32.abs().max()))
        np.testing.assert_allclose(g32.cpu().numpy(), w32.cpu().numpy(),
                                   rtol=g_tol[0], atol=g_tol[1] * scale,
                                   err_msg=name)
        if norm_tol is not None:
            rel = float((g32 - w32).norm() / w32.norm())
            assert rel <= norm_tol, f"{name}: relative norm {rel:.3e}"


def test_flash_attention_op_launches_kernels(cuda):
    from repro_torch.kernels import ops
    g = torch.Generator(device=cuda).manual_seed(1)
    q = torch.randn(2, 192, 14, 64, generator=g, device=cuda,
                    dtype=torch.bfloat16).requires_grad_(True)
    k, v = (torch.randn(2, 192, 2, 64, generator=g, device=cuda,
                        dtype=torch.bfloat16).requires_grad_(True)
            for _ in range(2))
    ops.reset_launch_counts()
    o = ops.flash_attention(q, k, v, causal=True)
    loss = o.float().square().sum()
    grads = torch.autograd.grad(loss, (q, k, v), retain_graph=True)
    again = torch.autograd.grad(loss, (q, k, v))
    counts = ops.launch_counts()
    assert counts["flash_fwd"] == 1 and counts["flash_bwd"] == 2
    assert grads[0].dtype == torch.bfloat16 and grads[1].shape == k.shape
    for name, g_, a_ in zip(("dq", "dk", "dv"), grads, again):
        assert torch.equal(g_, a_), f"{name} differs between two backwards"
