"""The port's kernels (repro_torch.kernels) on the CPU: each plain PyTorch
version against the JAX package's `kernels.ref` and its Pallas body in
interpret mode, and `ops` dispatch by device. The CUDA kernels themselves
are held against these plain versions on the card by
tests/test_torch_cuda.py."""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import maps as JM  # noqa: E402
from repro.kernels import hash_update as JH, ref as JREF  # noqa: E402
from repro.kernels import ringbuf_emit as JRB, tensor_stats as JTS  # noqa: E402,E501

from repro_torch.kernels import (hash_update as TH, ops, ref as TREF,  # noqa: E402,E501
                                 ringbuf_emit as TRB, tensor_stats as TTS)

SHAPES = [(7,), (128,), (1024,), (1025,), (4, 333), (16, 1024), (3, 5, 129),
          (8192,), (1,)]                       # tests/test_kernels.py:14
DTYPES = ["float32", "bfloat16"]
TOL = 2e-5
STATS = ("mean", "rms", "min", "max", "absmax")


def _pair(x32: np.ndarray, dtype: str):
    """The same values as a JAX array and a torch tensor (bf16 rounding
    from f32 is round-to-nearest-even in both)."""
    j = jnp.asarray(x32).astype(jnp.bfloat16 if dtype == "bfloat16"
                                else jnp.float32)
    t = torch.as_tensor(x32.copy()).to(getattr(torch, dtype))
    return j, t


def _check_stats(got, *wants):
    for want in wants:
        for k in STATS:
            np.testing.assert_allclose(float(got[k]), float(want[k]),
                                       rtol=TOL, atol=TOL, err_msg=k)
        assert int(got["nan_cnt"]) == int(want["nan_cnt"])
        assert int(got["inf_cnt"]) == int(want["inf_cnt"])
        assert got["nan_cnt"].dtype == torch.int64


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("dtype", DTYPES)
def test_tensor_stats_plain_matches_ref_and_pallas(shape, dtype):
    rng = np.random.default_rng(abs(hash(shape)) % 2**31)
    x = (rng.normal(size=shape) * 10).astype(np.float32)
    jx, tx = _pair(x, dtype)
    got = TREF.tensor_stats(tx)
    assert got["mean"].dtype == torch.float32
    _check_stats(got, JREF.tensor_stats(jx),
                 JTS.tensor_stats_pallas(jx, interpret=True))


@pytest.mark.parametrize("case", ["nan_inf", "all_bad", "empty", "huge"])
def test_tensor_stats_special_values(case):
    x = {"nan_inf": [1.0, np.nan, -np.inf, 4.0, np.inf, -2.0],
         "all_bad": [np.nan, np.inf, -np.inf],
         "empty": [],
         "huge": [3e38, -3e38, 1.0]}[case]
    x = np.asarray(x, np.float32)
    jx, tx = _pair(x, "float32")
    got = TREF.tensor_stats(tx)
    # (the JAX reference refuses an empty tensor; the port returns zeros)
    wants = [] if case == "empty" else \
        [JREF.tensor_stats(jx), JTS.tensor_stats_pallas(jx, interpret=True)]
    if case == "huge":       # sum of squares overflows f32 in every version
        assert float(got["rms"]) == float(wants[0]["rms"]) == np.inf
        got = {k: v for k, v in got.items() if k != "rms"}
        wants = [{k: v for k, v in w.items() if k != "rms"} for w in wants]
        for w in wants:
            for k in ("mean", "min", "max", "absmax"):
                np.testing.assert_allclose(float(got[k]), float(w[k]),
                                           rtol=TOL)
        return
    _check_stats(got, *wants)
    if case in ("all_bad", "empty"):
        assert all(float(got[k]) == 0.0 for k in STATS)


def _hash_inputs(seed, n, batch, *, tombstones, full):
    rng = np.random.default_rng(seed)
    st = JM.init_state(JM.MapSpec("h", JM.MapKind.HASH, n), np)
    resident = rng.choice(1 << 40, size=n if full else n // 2,
                          replace=False) - (1 << 39)
    for k in resident:
        JM.n_hash_update(st, int(k), int(rng.integers(-100, 100)))
    if tombstones:
        for k in resident[: len(resident) // 3]:
            JM.n_hash_delete(st, int(k))
    pool = np.concatenate([resident, rng.integers(-(1 << 62), 1 << 62,
                                                  max(batch // 4, 1))])
    keys = pool[rng.integers(0, pool.size, batch)]
    deltas = rng.integers(-(1 << 62), 1 << 62, batch)
    valid = rng.random(batch) < 0.85
    return st, keys, deltas, valid


@pytest.mark.parametrize("case", [
    dict(tombstones=False, full=False), dict(tombstones=True, full=False),
    dict(tombstones=False, full=True), dict(tombstones=True, full=True)],
    ids=["plain", "tombstones", "full", "full_tombstones"])
def test_hash_plain_matches_ref_pallas_and_numpy(case):
    st, keys, deltas, valid = _hash_inputs(3, 16, 48, **case)
    if case["tombstones"]:
        assert (st["used"] == 2).any()
    if case["full"] and not case["tombstones"]:
        assert (st["used"] == 1).all()
    args_np = (st["keys"], st["used"], st["values"], keys, deltas, valid)
    got = TREF.hash_fetch_add_batch(*[torch.as_tensor(a.copy())
                                      for a in args_np])
    jargs = [jnp.asarray(a) for a in args_np]
    want = JREF.hash_fetch_add_batch(*jargs)
    pallas = JH.hash_fetch_add_batch_pallas(*jargs, interpret=True)
    oracle = {f: a.copy() for f, a in st.items()}
    JM.n_hash_fetch_add_batch(oracle, keys, deltas, valid)
    for i, f in enumerate(("keys", "used", "values")):
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(want[i]))
        np.testing.assert_array_equal(got[i].numpy(), np.asarray(pallas[i]))
        np.testing.assert_array_equal(got[i].numpy(), oracle[f])
    # the inputs are not written
    np.testing.assert_array_equal(args_np[2], st["values"])


@pytest.mark.parametrize("batch", [5, 40])
def test_ringbuf_plain_matches_ref_and_pallas(batch):
    """B > cap (40 rows into 8 slots) and B < cap."""
    rng = np.random.default_rng(batch)
    data = rng.integers(-5, 5, (8, 4))
    head = np.array([11])
    rows = rng.integers(-(1 << 62), 1 << 62, (batch, 4))
    valid = rng.random(batch) < 0.7
    args_np = (data, head, rows, valid)
    got = TREF.ringbuf_emit_batch(*[torch.as_tensor(a.copy())
                                    for a in args_np])
    jargs = [jnp.asarray(a) for a in args_np]
    for want in (JREF.ringbuf_emit_batch(*jargs),
                 JRB.ringbuf_emit_batch_pallas(*jargs, interpret=True)):
        np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
        np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))


def test_ops_dispatch_by_device():
    x = torch.arange(10, dtype=torch.float32)
    ops.reset_launch_counts()
    st = ops.tensor_stats(x)
    assert float(st["mean"]) == 4.5
    assert ops.launch_counts() == {"tensor_stats": 0,
                                   "hash_fetch_add_batch": 0,
                                   "ringbuf_emit_batch": 0,
                                   "flash_fwd": 0, "flash_bwd": 0}
    with pytest.raises(ValueError, match="meta"):
        ops.tensor_stats(torch.empty(4, device="meta"))
    for fn, args in ((TTS.tensor_stats_cuda, (x,)),
                     (TRB.ringbuf_emit_batch_cuda,
                      (torch.zeros(4, 2, dtype=torch.int64),
                       torch.zeros(1, dtype=torch.int64),
                       torch.zeros(3, 2, dtype=torch.int64),
                       torch.ones(3, dtype=torch.bool))),
                     (TH.hash_fetch_add_batch_cuda,
                      tuple(torch.zeros(4, dtype=torch.int64)
                            for _ in range(5))
                      + (torch.ones(4, dtype=torch.bool),))):
        with pytest.raises(ValueError, match="CUDA"):
            fn(*args)


def test_kernel_modules_import_no_toolchain():
    """Importing the kernel modules builds nothing: the libraries are
    compiled at first launch."""
    from repro_torch.kernels import build
    if not torch.cuda.is_available():
        assert build._LIBS == {}
    assert TTS.grid_for(1) == 1 and TTS.grid_for(1 << 30) == TTS.MAX_GRID
