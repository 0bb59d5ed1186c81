"""The collector's event row in one step, on the CPU: `ref.tensor_stats_row`
(the plain version of the `tensor_stats` kernel's row epilogue) against the
JAX collector's row (src/repro/core/events.py `emit_tensor_event`), its
Q47.16 lanes against `events.to_fx`, the collector's row route against its
`stats_fn` route, and the pure-Python launch plans of the two probe kernels
(the tensor_stats grid and one-block cut, the hash kernel's routes). The
kernels themselves are held against these plain versions on the card by
tests/test_torch_cuda.py."""
import re
import zlib
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import events as JE, maps as JM  # noqa: E402
from repro.kernels import hash_update as JH  # noqa: E402
from repro.kernels import ref as JREF, tensor_stats as JTS  # noqa: E402

from repro_torch.core import events as TE, maps as M  # noqa: E402
from repro_torch.kernels import (hash_update as TH, ops, ref as TREF,  # noqa: E402,E501
                                 tensor_stats as TTS)

TOL = 2e-5          # tensor_stats' tolerance, as tests/test_kernels.py
SITE, KIND, LAYER = 7, JE.KIND_EXIT, 3
EXACT = [0, 1, 2, 3, 4, 10, 11, 12, 13, 14, 15]   # header, counts, spare


def _input(case: str) -> np.ndarray:
    rng = np.random.default_rng(zlib.crc32(case.encode()))
    if case == "nan_inf":
        return np.asarray([1.0, np.nan, -np.inf, 4.0, np.inf, -2.5, np.nan],
                          np.float32)
    if case == "all_nonfinite":
        return np.asarray([np.nan, np.inf, -np.inf, np.nan], np.float32)
    shape = {"3x40": (3, 40), "4x1x896": (4, 1, 896), "1": (1,)}[case]
    x = (rng.normal(size=shape) * 4).astype(np.float32)
    if x.size > 3:
        x.reshape(-1)[[2, 11, 17]] = [np.nan, np.inf, -np.inf]
    return x


def _jax_row(x32: np.ndarray, dtype: str, source: str) -> np.ndarray:
    """The JAX collector's row of x (site SITE, kind KIND, layer LAYER)."""
    stats = {"ref": JREF.tensor_stats,
             "pallas": lambda t: JTS.tensor_stats_pallas(t, interpret=True)}
    jx = jnp.asarray(x32).astype(jnp.bfloat16 if dtype == "bfloat16"
                                 else jnp.float32)
    with JE.Collector({(SITE, KIND)}, stats_fn=stats[source]) as col:
        col.layer_ctx = jnp.asarray(LAYER, jnp.int64)
        col.emit_tensor_event(SITE, KIND, jx)
        return np.asarray(col.take_all_rows())[0]


@pytest.mark.parametrize("source", ["ref", "pallas"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", ["3x40", "4x1x896", "1", "nan_inf",
                                  "all_nonfinite"])
def test_tensor_stats_row_matches_jax_collector(case, dtype, source):
    x32 = _input(case)
    tx = torch.as_tensor(x32.copy()).to(getattr(torch, dtype))
    got = TREF.tensor_stats_row(tx, SITE, KIND, LAYER)
    assert got.dtype == torch.int64 and got.shape == (TE.EVENT_WIDTH,)
    got = got.numpy()
    want = _jax_row(x32, dtype, source)
    np.testing.assert_array_equal(got[EXACT], want[EXACT])
    np.testing.assert_allclose(got[5:10].astype(np.float64),
                               want[5:10].astype(np.float64), rtol=TOL,
                               atol=TOL * TE.FX_ONE)
    if case == "all_nonfinite":
        assert (got[5:10] == 0).all()


# values at and beyond the +-2**62 clamp (2**46 * 2**16 == 2**62), tiny
# values that truncate to 0, and sums of squares that overflow f32
@pytest.mark.parametrize("values", [
    [0.5, -1.25, 3.0], [2.0**46], [-2.0**46], [2.0**46, -2.0**45],
    [1.5 * 2.0**46, 1.0], [3e30, -3e30], [3e38, -3e38, 1.0], [1e-9, -1e-9],
    [-7.62939453125e-06, 7.62939453125e-06]])
def test_tensor_stats_row_fx_lanes_are_to_fx_of_the_stats(values):
    x = torch.tensor(values, dtype=torch.float32)
    row = TREF.tensor_stats_row(x, SITE, KIND, LAYER)
    st = TREF.tensor_stats(x)
    want = TE.to_fx(torch.stack([st[k] for k in TREF.STAT_KEYS]))
    assert torch.equal(row[5:10], want)
    jwant = np.asarray(JE.to_fx(jnp.asarray(torch.stack(
        [st[k] for k in TREF.STAT_KEYS]).numpy())))
    np.testing.assert_array_equal(row[5:10].numpy(), jwant)
    assert TE.to_fx is TREF.to_fx       # one definition of the format


def _tape(stats_fn):
    """A tape of probe_site and traceable events over f32 and bf16 tensors
    across two layers."""
    rng = np.random.default_rng(11)
    sid = TE.SITES.get_or_create("rows.site")
    fid = TE.SITES.get_or_create("rows.fn")

    @TE.traceable("rows.fn")
    def fn(y):
        return y * 3.0

    wanted = {(sid, TE.KIND_TRACEPOINT), (fid, TE.KIND_ENTRY),
              (fid, TE.KIND_EXIT)}
    with TE.Collector(wanted, stats_fn=stats_fn) as col:
        for layer in range(2):
            col.layer_ctx = layer
            x = torch.as_tensor(rng.normal(size=(4, 1, 96)).astype(
                np.float32) * (layer + 1))
            x[0, 0, 5] = float("nan")
            TE.probe_site("rows.site", x)
            fn(x.to(torch.bfloat16))
        TE.probe_site("rows.site", torch.tensor([float("inf"), 2.0]))
        return col.take_all_rows()


def test_collector_row_route_matches_stats_fn_route():
    rows = _tape(None)
    assert rows.shape == (7, TE.EVENT_WIDTH) and rows.dtype == torch.int64
    assert torch.equal(rows, _tape(ops.tensor_stats))
    assert rows[:, 2].tolist() == [0, 0, 0, 1, 1, 1, 1]
    assert rows[:, 1].tolist()[:3] == [TE.KIND_TRACEPOINT, TE.KIND_ENTRY,
                                       TE.KIND_EXIT]


def test_ops_tensor_stats_row_on_cpu_is_the_plain_row():
    ops.reset_launch_counts()
    x = torch.arange(12, dtype=torch.float16).reshape(3, 4)   # cast to f32
    got = ops.tensor_stats_row(x, 1, 2, 3)
    assert torch.equal(got, TREF.tensor_stats_row(x.float(), 1, 2, 3))
    assert ops.launch_counts()["tensor_stats"] == 0
    with pytest.raises(ValueError, match="CUDA"):
        TTS.tensor_stats_row_cuda(x.float(), 1, 2, 3)


# ------------------------------------------------- launch plans (pure Python)

def test_tensor_stats_grid_and_one_block_cut():
    cut = TTS.ONE_BLOCK_MAX
    assert TTS.grid_for(0) == TTS.grid_for(cut) == 1
    assert TTS.grid_for(cut + 1) > 1
    grids = [TTS.grid_for(n) for n in range(cut, 1 << 26, 4099)]
    assert grids == sorted(grids) and max(grids) == TTS.MAX_GRID
    assert all(g % TTS.GRID_MULTIPLE == 0 for g in grids[1:])
    assert TTS.MAX_GRID % TTS.GRID_MULTIPLE == 0
    assert TTS.MAX_GRID <= TTS.SCRATCH_GRID
    # the wrapper's block is the kernel's
    src = (Path(TTS.__file__).parent / "csrc" / "tensor_stats.cu").read_text()
    assert re.search(r"constexpr int kThreads = (\d+);", src).group(1) == \
        str(TTS.BLOCK)
    # a grid beyond the scratch's partial records is refused before launch
    for grid in (0, TTS.SCRATCH_GRID + 1):
        with pytest.raises(ValueError, match="grid"):
            TTS._launch("repro_tensor_stats_row", torch.zeros(3), grid)


@pytest.mark.parametrize("b", [0, 1, 49, 1024, 1025, 4096])
def test_hash_plan_routes_at_the_boundary(b):
    n = TH.max_shared_n(b)
    assert TH.plan(n, b) == ("shared", True)
    assert 24 * n + TH.batch_bytes(b) <= TH.SMEM_MAX
    assert 24 * (n + 1) + TH.batch_bytes(b) > TH.SMEM_MAX
    assert TH.plan(n + 1, b) == ("global", True)
    assert TH.plan(256, b, "global") == ("global", True)
    with pytest.raises(ValueError, match="fit"):
        TH.plan(n + 1, b, "shared")
    m = TH.batch_slots(b)
    assert m >= max(2 * b, 32) and m & (m - 1) == 0 and m < max(4 * b, 64)
    # the serving and training path's map (256 slots) is always shared
    assert n >= 256


def test_hash_plan_large_batch_uses_scratch():
    b = 12000                      # a batch table of ~0.5 MB
    assert TH.plan(256, b) == ("global", False)
    assert TH.plan(1 << 20, 49) == ("global", True)
    with pytest.raises(ValueError, match="route"):
        TH.plan(256, 49, "warp")


def _key_with_home(n, home, start):
    """The first key from `start` up whose home slot in an n-slot table is
    `home`."""
    k = start
    while M._np_hash_idx(k, n) != home:
        k += 1
    return k


def _hidden_case(first):
    """A 64-slot table where key K sits two slots past its home with an
    empty slot between (hidden from a lookup), and a batch in which a new
    key M, whose home is that empty slot, comes before (first="M") or after
    (first="K") K's events. Sequentially, K matches its hidden slot once M
    has filled the gap, else K is inserted into the gap."""
    n, h = 64, 10
    st = M.init_state_np(M.MapSpec("h", M.MapKind.HASH, n))
    for s in range(n):
        if s not in (h + 1, h + 5):
            st["keys"][s] = 7000 + s
            st["used"][s] = 1 if s % 9 else 2
            st["values"][s] = s
    kk = _key_with_home(n, h, 1 << 20)
    st["keys"][h + 2], st["used"][h + 2], st["values"][h + 2] = kk, 1, 100
    mk = _key_with_home(n, h + 1, 1 << 30)
    nk = _key_with_home(n, h + 3, 1 << 40)
    order = [mk, kk, kk, nk, mk] if first == "M" else [kk, mk, kk, nk, kk]
    keys = np.array(order, dtype=np.int64)
    deltas = np.array([3, 5, 7, 11, 13], dtype=np.int64)
    return st, keys, deltas, np.ones(5, dtype=bool)


@pytest.mark.parametrize("first", ["M", "K"])
def test_hash_plain_hidden_resident_key_matches_jax(first):
    """The case the hash kernel's general insert exists for, on the plain
    version, the numpy twin, the JAX reference and the Pallas body."""
    st, keys, deltas, valid = _hidden_case(first)
    args = (st["keys"], st["used"], st["values"], keys, deltas, valid)
    got = TREF.hash_fetch_add_batch(*[torch.as_tensor(a.copy())
                                      for a in args])
    oracle = {f: a.copy() for f, a in st.items()}
    M.n_hash_fetch_add_batch(oracle, keys, deltas, valid)
    jargs = [jnp.asarray(a) for a in args]
    wants = [JREF.hash_fetch_add_batch(*jargs),
             JH.hash_fetch_add_batch_pallas(*jargs, interpret=True)]
    joracle = {f: a.copy() for f, a in st.items()}
    JM.n_hash_fetch_add_batch(joracle, keys, deltas, valid)
    for i, f in enumerate(("keys", "used", "values")):
        np.testing.assert_array_equal(got[i].numpy(), oracle[f])
        np.testing.assert_array_equal(got[i].numpy(), joracle[f])
        for w in wants:
            np.testing.assert_array_equal(got[i].numpy(), np.asarray(w[i]))
    h = 10                       # K's hidden slot (h + 2) gets K's sum
    added = int(got[2][h + 2]) - 100
    assert added == (12 if first == "M" else 0)
