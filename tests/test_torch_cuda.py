"""The port's Hopper kernels against their plain PyTorch versions, on the
card. Every test is marked `cuda` and skips without a CUDA device. This
file imports no JAX, so it also runs where JAX is not installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

A change to the probe kernels is brought up with `-k "stats or hash"`
first.
"""
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import numpy as np  # noqa: E402

from repro_torch.core import events as TE, maps as M  # noqa: E402
from repro_torch.kernels import (hash_update as TH, ops, ref as TREF,  # noqa: E402,E501
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
    row = TTS.tensor_stats_row_cuda(x, 1, 2, 3)
    _check_row(row, x, got, (1, 2, 3))


def _check_row(row, x, stats, header):
    """Row against ref.tensor_stats_row: header and counts exact, the fx
    lanes within the stats tolerance, and bit for bit to_fx of the
    kernel's own stats (`stats`, the dict entry on the same tensor)."""
    want = TREF.tensor_stats_row(x, *header)
    assert row.dtype == torch.int64 and row.shape == (16,)
    exact = [0, 1, 2, 3, 4, 10, 11, 12, 13, 14, 15]
    assert torch.equal(row[exact], want[exact])
    np.testing.assert_allclose(row[5:10].cpu().double().numpy(),
                               want[5:10].cpu().double().numpy(), rtol=TOL,
                               atol=TOL * TE.FX_ONE)
    own = TE.to_fx(torch.stack([stats[k] for k in STATS]))
    assert torch.equal(row[5:10], own)


ROW_SHAPES = [(4, 1, 896), (4, 1, 152064), (2, 4096, 896), (1,), (1027,),
              (TTS.ONE_BLOCK_MAX + 1,)]


@pytest.mark.parametrize("shape", ROW_SHAPES,
                         ids=lambda s: "x".join(map(str, s)))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_tensor_stats_row_kernel_matches_plain(cuda, shape, dtype):
    g = torch.Generator(device=cuda).manual_seed(3)
    x = torch.randn(shape, generator=g, device=cuda) * 7
    x.view(-1)[-3:] = torch.tensor([float("nan"), float("-inf"),
                                    float("inf")], device=cuda)[-x.numel():]
    x = x.to(getattr(torch, dtype))
    row = TTS.tensor_stats_row_cuda(x, 5, 1, 23)
    _check_row(row, x, TTS.tensor_stats_cuda(x), (5, 1, 23))


def test_tensor_stats_repeats_bit_identical_across_grids(cuda):
    """Three rounds over tensors at the one-block cut (-1, at, +1) and over
    grids of different sizes called in turn give identical rows: a ticket
    counter left unreset would fold the wrong partials."""
    cut = TTS.ONE_BLOCK_MAX
    sizes = [cut - 1, cut, cut + 1, 1 << 22, 40 * 4096 + 5, 1 << 26, 3,
             100 * 4096]
    g = torch.Generator(device=cuda).manual_seed(4)
    xs = [torch.randn(n, generator=g, device=cuda) for n in sizes]
    assert len({TTS.grid_for(n) for n in sizes}) >= 4
    rounds = [[TTS.tensor_stats_row_cuda(x, 0, 0, 0) for x in xs]
              for _ in range(3)]
    for again in rounds[1:]:
        for n, a, b in zip(sizes, rounds[0], again):
            assert torch.equal(a, b), n
    for x, row in zip(xs, rounds[0]):
        _check_row(row, x, TTS.tensor_stats_cuda(x), (0, 0, 0))


def test_probe_kernels_give_the_same_results_on_any_stream(cuda):
    """tensor_stats (dict and row entries, one block and a grid) and the
    hash fetch-add (both routes) keep scratch per (device, stream): called
    on the default stream and on a side stream, in turns, they give
    bit-identical results."""
    g = torch.Generator(device=cuda).manual_seed(5)
    xs = [torch.randn(n, generator=g, device=cuda) for n in (100, 1 << 20)]
    rng = np.random.default_rng(5)
    keys = torch.as_tensor(rng.integers(0, 300, 4096), device=cuda)
    deltas = torch.as_tensor(rng.integers(-9, 9, 4096), device=cuda)
    valid = torch.as_tensor(rng.random(4096) < 0.8, device=cuda)

    def run():
        out = []
        for x in xs:
            out += list(TTS.tensor_stats_cuda(x).values())
            out.append(TTS.tensor_stats_row_cuda(x, 1, 2, 3))
        for n, route in ((256, "shared"), (16384, "global")):
            tbl = [torch.zeros(n, dtype=torch.int64, device=cuda)
                   for _ in range(3)]
            assert TH.plan(n, 4096)[0] == route
            out += list(TH.hash_fetch_add_batch_cuda(*tbl, keys, deltas,
                                                     valid))
        torch.cuda.synchronize()
        return [t.clone() for t in out]

    side = torch.cuda.Stream()
    results = []
    for _ in range(2):
        results.append(run())
        with torch.cuda.stream(side):
            results.append(run())
    for again in results[1:]:
        for a, b in zip(results[0], again):
            assert torch.equal(a, b)


def test_collector_one_launch_per_event(cuda):
    """The collector's row route: one tensor_stats launch per event, and a
    tape bit-identical to the stats_fn route's."""
    sid = TE.SITES.get_or_create("cuda.rows")
    g = torch.Generator(device=cuda).manual_seed(6)
    xs = [torch.randn(4, 1, 896, generator=g, device=cuda).to(torch.bfloat16),
          torch.randn(4, 1, 152064, generator=g, device=cuda),
          torch.randn(1, device=cuda)]

    def tape(stats_fn):
        with TE.Collector({(sid, TE.KIND_TRACEPOINT)},
                          stats_fn=stats_fn) as col:
            for layer, x in enumerate(xs):
                col.layer_ctx = layer
                TE.probe_site("cuda.rows", x)
            return col.take_all_rows()

    ops.reset_launch_counts()
    rows = tape(None)
    assert ops.launch_counts()["tensor_stats"] == len(xs)
    assert rows.shape == (len(xs), 16) and rows.is_cuda
    assert torch.equal(rows, tape(ops.tensor_stats))


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


def _hash_check(cuda, st, keys, deltas, valid, route):
    args = [torch.as_tensor(a, device=cuda) for a in
            (st["keys"], st["used"], st["values"], keys, deltas, valid)]
    before = [a.clone() for a in args[:3]]
    got = TH.hash_fetch_add_batch_cuda(*args, route=route)
    oracle = {f: a.copy() for f, a in st.items()}
    M.n_hash_fetch_add_batch(oracle, keys, deltas, valid)
    for f, g, w in zip(("keys", "used", "values"), got,
                       TREF.hash_fetch_add_batch(*args)):
        assert torch.equal(g, w), f
        np.testing.assert_array_equal(g.cpu().numpy(), oracle[f])
    for a, b in zip(args[:3], before):
        assert torch.equal(a, b)             # the inputs are not written


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


HASH_BATCHES = [0, 1, 49, 1024, 1025, 4096]


@pytest.mark.parametrize("route", TH.ROUTES)
@pytest.mark.parametrize("batch", HASH_BATCHES)
def test_hash_kernel_routes_at_their_boundary(cuda, batch, route):
    """The largest table of the shared route and the next size up, which
    takes the global route, half full with tombstones."""
    n = TH.max_shared_n(batch) + (route == "global")
    assert TH.plan(n, batch)[0] == route
    st, keys, deltas, valid = _hash_inputs(batch + 1, n, batch,
                                           tombstones=True, full=False)
    _hash_check(cuda, st, keys, deltas, valid, None)


@pytest.mark.parametrize("route", TH.ROUTES)
@pytest.mark.parametrize("case", ["same_key", "all_invalid", "tombstones",
                                  "full", "full_tombstones"])
@pytest.mark.parametrize("batch", HASH_BATCHES)
def test_hash_kernel_cases(cuda, batch, case, route):
    """A 256-slot table (the path's) on both routes: every key the same,
    every event invalid, tombstones, a full table (new keys dropped)."""
    st, keys, deltas, valid = _hash_inputs(
        7 * batch + len(case), 256, batch,
        tombstones="tombstones" in case, full=case.startswith("full"))
    if case == "same_key":
        keys = np.full(batch, keys[0] if batch else 5, dtype=np.int64)
    if case == "all_invalid":
        valid = np.zeros(batch, dtype=bool)
    _hash_check(cuda, st, keys, deltas, valid, route)


def test_hash_kernel_batch_table_in_scratch(cuda):
    """A batch whose batch table exceeds shared memory: global route, the
    batch table in a scratch tensor; new keys overflow the table."""
    batch = 12000
    assert TH.plan(256, batch) == ("global", False)
    st, keys, deltas, valid = _hash_inputs(9, 256, batch, tombstones=True,
                                           full=False)
    keys[::97] = np.iinfo(np.int64).min      # the batch table's empty marker
    _hash_check(cuda, st, keys, deltas, valid, None)


@pytest.mark.parametrize("batch", [0, 40, 4096])
def test_ringbuf_kernel_matches_plain(cuda, batch):
    """Rows, head and the dropped (lap) count; the head starts past cap, so
    every row laps, and at 4096 rows only the last 64 stay."""
    rng = np.random.default_rng(batch)
    args = [torch.as_tensor(a, device=cuda) for a in (
        rng.integers(-5, 5, (64, 4)), np.array([70]), np.array([3]),
        rng.integers(-99, 99, (batch, 4)).reshape(batch, 4),
        rng.random(batch) < 0.6)]
    got = TRB.ringbuf_emit_batch_cuda(*args)
    for g, w in zip(got, TREF.ringbuf_emit_batch(*args)):
        assert torch.equal(g, w)
    assert int(got[2]) - 3 == int(args[4].sum())


@pytest.mark.parametrize("head", [0, 30, 63, 64])
def test_ringbuf_kernel_laps_from_any_head(cuda, head):
    """The first lap at rank cap - head, counted in closed form."""
    rng = np.random.default_rng(head)
    args = [torch.as_tensor(a, device=cuda) for a in (
        np.zeros((64, 2), np.int64), np.array([head]), np.array([0]),
        rng.integers(-99, 99, (100, 2)), rng.random(100) < 0.8)]
    for g, w in zip(TRB.ringbuf_emit_batch_cuda(*args),
                    TREF.ringbuf_emit_batch(*args)):
        assert torch.equal(g, w)


def test_ringbuf_apply_is_one_launch(cuda):
    """The fused lane's RINGBUF apply is one kernel launch that writes
    data, head and dropped, equal to the same apply on the CPU."""
    from repro_torch.core import jit as J
    from repro_torch.core.runtime import BpftimeRuntime
    from repro_torch.launch import serve as L
    name, text, spec, target = L.SERVE_PROBES[3]
    rt = BpftimeRuntime()
    pid = rt.load_asm(name, text, [M.MapSpec(spec[0], M.MapKind(spec[1]),
                                             spec[2], rec_width=spec[3])])
    rt.attach(pid, target, mode="fused")
    rows = np.zeros((300, 16), np.int64)
    rows[:, 0] = TE.SITES.get_or_create("logits")
    rows[:, 1] = TE.KIND_TRACEPOINT
    rows[:, 3:10] = np.random.default_rng(1).integers(0, 1 << 30, (300, 7))
    out = {}
    for dev in (cuda, "cpu"):
        ops.reset_launch_counts()
        maps, _ = rt.probe_stage(torch.as_tensor(rows, device=dev),
                                 rt.init_device_maps(dev),
                                 J.make_aux(device=dev))
        out[str(dev)] = {f: t.cpu() for f, t in maps[spec[0]].items()}
        if dev == cuda:
            assert ops.launch_counts()["ringbuf_emit_batch"] == 1
    for f in ("data", "head", "dropped"):
        assert torch.equal(out[str(cuda)][f], out["cpu"][f]), f
    assert int(out["cpu"]["dropped"]) == 300 - 64


# ------------------------------------------------- table interpreter

CORPUS = sorted(Path(__file__).with_name("corpus").glob("*.json"))


def _interp_check(case, match_all):
    from repro_torch.kernels import interp_cases as IC
    got = ops.table_interp_run(*case, match_all=match_all, want_r0=True)
    want = ops.table_interp_run(*IC.to_cpu(case), match_all=match_all,
                                want_r0=True)
    assert IC.compare(IC.to_cpu(got), want) == []


@pytest.mark.parametrize("events", [1, 49, 600, 4096])
def test_interp_kernel_mixed_table_matches_plain(cuda, events):
    """Eight slots on both sub-lanes: counters, a HASH map that fills, a
    ringbuf that laps, every other helper, loops whose fuel runs out."""
    from repro_torch.kernels import interp_cases as IC
    _interp_check(IC.mixed_case(events, events, cuda), False)


@pytest.mark.parametrize("events", [49, 600, 1029])
@pytest.mark.parametrize("big", [False, True], ids=["shared", "global"])
def test_interp_kernel_branching_hash_vec_matches_plain(cuda, events, big):
    """A HASH fetch-add behind a data-dependent loop, forced onto the vec
    sub-lane (its lanes reach HASH at different machine steps: the inserts
    go in (step, lane) order), beside a sequential program and a vec
    counter; the map states in shared memory and, with the big universe,
    in device memory; tapes below, above and not a multiple of the block's
    threads."""
    from repro_torch.kernels import interp_cases as IC, table_interp as TI
    case = IC.branch_case(events, events, cuda, big)
    P, N = case[1]["hcls"].shape
    assert TI.plan(case[0], P, N, events, 16)["maps"] == \
        ("global" if big else "shared")
    _interp_check(case, False)


@pytest.mark.parametrize("events", [49, 4096])
def test_interp_kernel_isa_traps_match_plain(cuda, events):
    """Unsigned and by-zero DIV/MOD, shift masking, ALU32, unaligned
    sub-word stack access, jmp32 and unsigned compares."""
    from repro_torch.kernels import interp_cases as IC
    _interp_check(IC.traps_case(events, events, cuda), True)


@pytest.mark.parametrize("vec", [False, True])
@pytest.mark.parametrize("events", [49, 4096])
@pytest.mark.parametrize("path", CORPUS, ids=[p.stem for p in CORPUS])
def test_interp_kernel_corpus_matches_plain(cuda, path, events, vec):
    from repro_torch.kernels import interp_cases as IC
    d = json.loads(path.read_text())
    case = IC.corpus_case(d["text"], d["tape"], events, 0, vec, cuda)
    if case is None:
        assert vec            # the program may not take the vec sub-lane
        return
    _interp_check(case, True)


def test_interp_kernel_one_launch_per_probe_stage(cuda):
    """One launch per probe stage while the lane is on and the tape is not
    empty, whatever the table holds (an empty table too); none for an
    empty tape."""
    from repro_torch.core import jit as J
    from repro_torch.kernels import interp_cases as IC
    rt, links = IC.mixed_runtime()
    for lk in links:
        rt.detach(lk)
    maps = rt.init_device_maps(cuda)
    rows = torch.as_tensor(IC.mixed_tape(49, 0), device=cuda)
    ops.reset_launch_counts()
    out, _ = rt.probe_stage(rows, maps, J.make_aux(device=cuda))
    assert ops.launch_counts()["table_interp"] == 1
    rt.probe_stage(rows[:0], out, J.make_aux(device=cuda))
    assert ops.launch_counts()["table_interp"] == 1
    for name in out:
        if name != "__live_table__":
            for f in out[name]:
                assert torch.equal(out[name][f], maps[name][f])


# ------------------------------------------------------ flash attention# ------------------------------------------------------ flash attention

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


@pytest.mark.parametrize("route", TH.ROUTES)
@pytest.mark.parametrize("first", ["M", "K"])
def test_hash_kernel_hidden_resident_key(cuda, first, route):
    """A resident key hidden behind an empty slot takes the kernel's general
    insert (a leader may match once an earlier insert fills the gap)."""
    _hash_check(cuda, *_hidden_case(first), route)


def test_publish_of_cuda_maps_equals_to_numpy(cuda, tmp_path):
    """The shm plane's publish makes one host copy of CUDA map states; the
    region reads them back bit for bit."""
    from repro_torch.core.runtime import BpftimeRuntime, to_numpy
    from repro_torch.core.shm import ShmRegion
    rt = BpftimeRuntime()
    for s in (M.MapSpec("a", M.MapKind.ARRAY, 64),
              M.MapSpec("h", M.MapKind.HASH, 32),
              M.MapSpec("r", M.MapKind.RINGBUF, 8, rec_width=3),
              M.MapSpec("l", M.MapKind.LOG2HIST)):
        rt.create_map(s)
    rt.setup_shm(str(tmp_path), worker_id="w0")
    maps = rt.init_device_maps(cuda)
    g = torch.Generator(device=cuda).manual_seed(0)
    for st in maps.values():
        for t in st.values():
            t.copy_(torch.randint(-2**40, 2**40, t.shape, generator=g,
                                  device=cuda))
    rt.publish(maps)
    want = to_numpy(maps)
    region = ShmRegion.attach(str(tmp_path), mode="r", worker_id="w0")
    for name, st in maps.items():
        got, seq, _ = region.snapshot_device_meta(name)
        assert seq == 2
        for f, t in st.items():
            assert torch.equal(torch.from_numpy(got[f]), t.cpu())
            assert (want[name][f] == got[f]).all()


def test_node_folds_on_the_card_equal_the_cpu(cuda):
    """The tree's node folds (t_group_summary_fold_multi, t_hash_coalesce)
    on the card bit for bit on the CPU and the numpy twins, i64 wrap
    included."""
    rng = np.random.default_rng(2)
    big = 1 << 62
    stacks = {"a": {"values": (rng.integers(-big, big, 128),
                               rng.integers(-big, big, (8, 128)),
                               rng.integers(-big, big, (8, 128)))},
              "p": {"values": (rng.integers(-9, 9, (2, 8)),
                               rng.integers(-big, big, (3, 2, 8)),
                               rng.integers(-big, big, (3, 2, 8)))},
              "h": {"bins": (rng.integers(-9, 9, 64),
                             rng.integers(-big, big, (8, 64)),
                             rng.integers(-big, big, (8, 64)))}}
    got = M.t_group_summary_fold_multi(stacks, cuda)
    want = M.t_group_summary_fold_multi(stacks, "cpu")
    with np.errstate(over="ignore"):
        twin = M.n_group_summary_fold_multi(stacks)
    for n in want:
        for f in want[n]:
            assert (got[n][f] == want[n][f]).all()
            assert (got[n][f] == twin[n][f]).all()
    keys = rng.integers(-300, 300, 4096).astype(np.int64)
    keys[:2] = (1 << 63) - 1
    deltas = rng.integers(-big, big, 4096).astype(np.int64) * 2
    deltas[-3:] = 0
    for a, b in zip(M.t_hash_coalesce(keys, deltas, cuda),
                    M.n_hash_coalesce(keys, deltas)):
        assert a.dtype == b.dtype and (a == b).all()


def test_tree_on_the_card_equals_numpy_tree(cuda, tmp_path):
    """A tree with its node folds on the card and one with the numpy twins
    fold the same regions into the same view."""
    import os
    from repro_torch.core import daemon as D, shm as SH
    from repro_torch.core.treeagg import TreeAggregator
    specs = [M.MapSpec("arr", M.MapKind.ARRAY, 16),
             M.MapSpec("hsh", M.MapKind.HASH, 64),
             M.MapSpec("hist", M.MapKind.LOG2HIST)]
    root, twin = str(tmp_path / "card"), str(tmp_path / "np")
    wids = [f"w{w}" for w in range(6)]
    regions = [SH.ShmRegion.create(root, specs, worker_id=w) for w in wids]
    os.makedirs(twin)
    for name in ("meta.json", "progs", "workers"):
        os.symlink(os.path.join(root, name), os.path.join(twin, name))
    on_card = TreeAggregator(root, fan_in=3, worker_ids=wids,
                             config=D.AggregatorConfig(device=cuda))
    on_host = TreeAggregator(twin, fan_in=3, worker_ids=wids,
                             config=D.AggregatorConfig(device_fold=False))
    states = [M.init_states_np(specs) for _ in wids]
    rng = np.random.default_rng(4)
    for _ in range(4):
        for st, region in zip(states, regions):
            np.add.at(st["arr"]["values"], rng.integers(0, 16, 40), 1)
            M.n_hash_fetch_add_batch(st["hsh"], rng.integers(0, 40, 40),
                                     rng.integers(-5, 6, 40))
            np.add.at(st["hist"]["bins"], rng.integers(0, 64, 40), 1)
            region.publish_device(st)
        on_card.poll_once()
        on_host.poll_once()
    a, b = SH.GlobalView.attach(root), SH.GlobalView.attach(twin)
    for s in specs:
        ga, gb = a.snapshot(s.name), b.snapshot(s.name)
        for f in gb:
            assert (ga[f] == gb[f]).all(), (s.name, f)
    assert int(a.snapshot("arr")["values"].sum()) == 6 * 4 * 40


def test_fuzz_seeds_on_the_card(cuda):
    """The fuzz harness's seeds 0-19 with every lane on the card: the
    table and batched lanes launch the interpreter kernel."""
    from repro_torch.core import fuzz as F
    ops.reset_launch_counts()
    lanes = set()
    for seed in range(20):
        r = F.run_case(F.generate_case(seed), device=cuda)
        assert not r.diverged, (seed, r.mismatches or r.crashed)
        lanes.update(r.lanes)
    assert {"jit", "table", "batched", "vectorized", "merge1"} <= lanes
    assert ops.launch_counts()["table_interp"] > 0
