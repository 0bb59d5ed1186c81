"""The port's training path against the JAX package's, on the CPU: the
plain flash-attention versions against the Pallas kernels in interpret
mode, FlashAttention's autograd, cross-entropy, the optimizers, the data
pipeline, loss and gradients with weights carried across, and whole train
steps with probes in the step (maps and tapes bit-exact, the tape the
same with remat on and off)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import registry as JCFG  # noqa: E402
from repro.configs.base import ShapeConfig, TrainConfig  # noqa: E402
from repro.core import events as JE, maps as JM  # noqa: E402
from repro.core.runtime import BpftimeRuntime as JRuntime  # noqa: E402
from repro.data.pipeline import SyntheticDataset as JData  # noqa: E402
from repro.kernels import flash_attention as JFA  # noqa: E402
from repro.models import registry as JMR, transformer as JTF  # noqa: E402
from repro.optim import optimizers as JO  # noqa: E402
from repro.train.train_step import (init_train_state as j_init,  # noqa: E402
                                    make_train_step as j_make)

from repro_torch.configs import (base as TB,  # noqa: E402
                                 registry as TCFG)
from repro_torch.core import events as TE, maps as TM  # noqa: E402
from repro_torch.core.runtime import BpftimeRuntime as TRuntime, to_numpy  # noqa: E402,E501
from repro_torch.data.pipeline import SyntheticDataset as TData  # noqa: E402
from repro_torch.kernels import flash_attention as TFA, ops, ref  # noqa: E402
from repro_torch.launch import train as TL  # noqa: E402
from repro_torch.models import (layers as TLY, registry as TMR,  # noqa: E402
                                transformer as TTF)
from repro_torch.optim import optimizers as TO  # noqa: E402
from repro_torch.train.train_step import (init_train_state as t_init,  # noqa: E402,E501
                                          make_train_step as t_make)

CPU = "cpu"
ARCH = "qwen2-0.5b"
JCFG_ = JCFG.smoke(ARCH)
TCFG_ = TCFG.smoke(ARCH)
FWD_TOL, BWD_TOL = 2e-4, 5e-4      # test_flash_kernel.py's tolerances
STEP_TOL = 1e-4
OPT_TOL = 1e-6

COUNT_BLOCKS = """
    ldxdw r6, [r1+ctx:layer]
    stxdw [r10-8], r6
    lddw r1, map:blk_counts
    mov r2, r10
    add r2, -8
    mov r3, 1
    call map_fetch_add
    mov r0, 0
    exit
"""
VETO_ALWAYS = """
    mov r1, 1
    call override_return
    mov r0, 0
    exit
"""


def _j2t(tree):
    return TMR.params_from_numpy(jax.tree.map(np.asarray, tree), CPU)


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np(v) for v in tree]
    return tree.detach().numpy() if isinstance(tree, torch.Tensor) \
        else np.asarray(tree)


def _assert_trees_close(t_tree, j_tree, tol, what):
    got = jax.tree.leaves(_np(t_tree))
    want = jax.tree.leaves(jax.tree.map(np.asarray, j_tree))
    assert len(got) == len(want) > 0
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol,
                                   err_msg=f"{what} leaf {i}")


@pytest.fixture(scope="module")
def weights():
    jp = JMR.init_params(jax.random.PRNGKey(0), JCFG_)
    return jp, _j2t(jp)


# ----------------------------------------------------- flash attention

def _flash_inputs(shape, seed):
    B, Sq, Skv, H, KH, hd = shape
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((B * H, Sq, hd)).astype(np.float32)
    k = rng.standard_normal((B * KH, Skv, hd)).astype(np.float32)
    v = rng.standard_normal((B * KH, Skv, hd)).astype(np.float32)
    do = rng.standard_normal((B * H, Sq, hd)).astype(np.float32)
    return q, k, v, do, H // KH


@pytest.mark.parametrize("shape", [
    (1, 128, 128, 2, 2, 32),     # MHA
    (2, 256, 256, 4, 2, 16),     # GQA rep=2
    (1, 128, 128, 8, 2, 64),     # GQA rep=4
])
@pytest.mark.parametrize("causal", [True, False])
def test_plain_flash_matches_pallas_interpret(shape, causal):
    q, k, v, do, rep = _flash_inputs(shape, sum(shape))
    jo, jlse = JFA.flash_fwd(*map(jnp.asarray, (q, k, v)), causal=causal,
                             lq=64, lkv=64, rep=rep, interpret=True)
    t = [torch.as_tensor(a) for a in (q, k, v, do)]
    o, lse = ref.flash_fwd(t[0], t[1], t[2], causal, rep)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo), rtol=FWD_TOL,
                               atol=FWD_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse), rtol=FWD_TOL,
                               atol=FWD_TOL)
    jg = JFA.flash_bwd(*map(jnp.asarray, (q, k, v)), jo, jlse,
                       jnp.asarray(do), causal=causal, lq=64, lkv=64,
                       rep=rep, interpret=True)
    tg = ref.flash_bwd(t[0], t[1], t[2], o, lse, t[3], causal, rep)
    for name, g, w in zip(("dq", "dk", "dv"), tg, jg):
        assert g.shape == w.shape and g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=BWD_TOL,
                                   atol=BWD_TOL, err_msg=name)


@pytest.mark.parametrize("B,S,H,KH,hd", [
    (1, 100, 2, 2, 16),          # S not a multiple of the 64-row tile
    (2, 130, 4, 2, 32),
    (1, 64, 8, 2, 16),
    (1, 96, 14, 2, 16),          # rep 7, as qwen2-0.5b
])
def test_flash_attention_autograd_matches_full_attention(B, S, H, KH, hd):
    rng = np.random.default_rng(S + H)
    arrs = [rng.standard_normal((B, S, h, hd)).astype(np.float32)
            for h in (H, KH, KH)]
    do = torch.as_tensor(rng.standard_normal((B, S, H, hd))
                         .astype(np.float32))
    ins = [torch.as_tensor(a).requires_grad_(True) for a in arrs]
    ref_ins = [torch.as_tensor(a).requires_grad_(True) for a in arrs]
    ops.reset_launch_counts()
    o = ops.flash_attention(*ins, causal=True)
    want = TLY.full_attention(*ref_ins, causal=True)
    assert o.shape == (B, S, H, hd)
    np.testing.assert_allclose(o.detach().numpy(), want.detach().numpy(),
                               rtol=1e-5, atol=1e-5)
    got_g = torch.autograd.grad(o, ins, do)
    want_g = torch.autograd.grad(want, ref_ins, do)
    for name, g, w in zip(("dq", "dk", "dv"), got_g, want_g):
        np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-4,
                                   atol=1e-5, err_msg=name)
    # a CPU tensor runs the plain versions: no kernel launched
    assert ops.launch_counts()["flash_fwd"] == 0
    assert ops.launch_counts()["flash_bwd"] == 0


def test_flash_wrappers_refuse_cpu_tensors_and_bad_shapes():
    q = torch.zeros(4, 64, 16)
    kv = torch.zeros(2, 64, 16)
    with pytest.raises(ValueError, match="CUDA"):
        TFA.flash_fwd_cuda(q, kv, kv)
    with pytest.raises(TypeError, match="f32 or bf16"):
        TFA.flash_fwd_cuda(q.half(), kv.half(), kv.half())
    with pytest.raises(ValueError, match="meta"):
        TFA.FlashAttention.apply(q.to("meta"), kv.to("meta"),
                                 kv.to("meta"), True)


# ------------------------------------------------------ loss and optim

def test_cross_entropy_matches_jax():
    rng = np.random.default_rng(7)
    V, Vpad = 250, 256
    logits = (rng.standard_normal((2, 9, Vpad)) * 3).astype(np.float32)
    labels = rng.integers(0, V, (2, 9)).astype(np.int32)
    labels[0, :3] = -1
    labels[1, -1] = -1
    for vocab in (V, None):
        want = JMR.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                 vocab)
        got = TMR.cross_entropy(torch.as_tensor(logits),
                                torch.as_tensor(labels), vocab)
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)
    all_masked = np.full((2, 9), -1, np.int32)
    assert float(TMR.cross_entropy(torch.as_tensor(logits),
                                   torch.as_tensor(all_masked), V)) == 0.0


def _opt_tree(rng):
    return {"w": rng.standard_normal((6, 5)).astype(np.float32),
            "stack": [{"a": rng.standard_normal((3, 4, 2))
                       .astype(np.float32),
                       "b": rng.standard_normal(7).astype(np.float32)}],
            "bias": rng.standard_normal(5).astype(np.float32)}


def _to_t(tree):
    return jax.tree.map(lambda a: torch.as_tensor(np.array(a)), tree)


@pytest.mark.parametrize("name", ["adamw", "adafactor"])
def test_optimizers_match_jax(name):
    rng = np.random.default_rng(11)
    params = _opt_tree(rng)
    j_init_, j_upd = JO.make_optimizer(name)
    t_init_, t_upd = TO.make_optimizer(name)
    jp, tp = jax.tree.map(jnp.asarray, params), _to_t(params)
    jo, to = j_init_(jp), t_init_(tp)
    for step in range(3):
        g = jax.tree.map(lambda a: (a * 0.3 + 0.1 * step)
                         .astype(np.float32), _opt_tree(rng))
        jg, tg = jax.tree.map(jnp.asarray, g), _to_t(g)
        jg, jn = JO.clip_by_global_norm(jg, 1.0)
        tg, tn = TO.clip_by_global_norm(tg, 1.0)
        np.testing.assert_allclose(float(tn), float(jn), rtol=OPT_TOL)
        jlr = JO.warmup_cosine(jnp.asarray(step, jnp.int32), lr=1e-2,
                               warmup=2, total=10)
        tlr = TO.warmup_cosine(torch.tensor(step, dtype=torch.int32),
                               lr=1e-2, warmup=2, total=10)
        assert tlr.dtype == torch.float32
        np.testing.assert_allclose(float(tlr), float(jlr), rtol=OPT_TOL)
        jp, jo = j_upd(jp, jg, jo, jlr, weight_decay=0.1,
                       step=jnp.asarray(step, jnp.int32))
        tp, to = t_upd(tp, tg, to, tlr, weight_decay=0.1,
                       step=torch.tensor(step, dtype=torch.int32))
        _assert_trees_close(tp, jp, OPT_TOL, f"{name} params step {step}")
        _assert_trees_close(to, jo, OPT_TOL, f"{name} state step {step}")


def test_warmup_cosine_matches_jax_over_schedule():
    for step in (0, 1, 5, 9, 10, 11, 500, 9999, 10000, 20000):
        want = JO.warmup_cosine(jnp.asarray(step, jnp.int32), lr=3e-4,
                                warmup=100, total=10_000)
        got = TO.warmup_cosine(torch.tensor(step, dtype=torch.int32),
                               lr=3e-4, warmup=100, total=10_000)
        np.testing.assert_allclose(float(got), float(want), rtol=OPT_TOL,
                                   atol=1e-12)


@pytest.mark.parametrize("microbatch", [0, 2])
def test_synthetic_dataset_bit_identical(microbatch):
    shape = ShapeConfig("t", 40, 4, "train")
    tshape = TB.ShapeConfig("t", 40, 4, "train")
    jd = JData(JCFG_, shape, TrainConfig(microbatch=microbatch), seed=5)
    td = TData(TCFG_, tshape, TB.TrainConfig(microbatch=microbatch), seed=5)
    for _ in range(3):
        jb, tb = jd.next(), td.next()
        assert sorted(jb) == sorted(tb)
        for k in jb:
            assert jb[k].dtype == tb[k].dtype
            np.testing.assert_array_equal(jb[k], tb[k])


# ----------------------------------------------- model loss and grads

def _batch(cfg, B, S, seed):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    return {"tokens": toks, "labels": labels}


def _t_loss_and_grads(tp, batch, remat):
    leaves = {id(p): p.detach().clone().requires_grad_(True)
              for p in TO.tree_leaves(tp)}
    p2 = TO.tree_map(lambda p: leaves[id(p)], tp)
    tb = {k: torch.as_tensor(v).long() for k, v in batch.items()}
    loss, _ = TMR.loss_fn(p2, tb, TCFG_, remat=remat)
    loss.backward()
    return loss.detach(), TO.tree_map(lambda p: p.grad, p2)


@pytest.mark.parametrize("remat,S", [(False, 32), (True, 32), (True, 4096)])
def test_loss_and_grads_match_jax(weights, remat, S):
    """At S = 4096 every layer runs the flash path (the plain versions
    here; the chunked online softmax in JAX)."""
    jp, tp = weights
    batch = _batch(JCFG_, 1 if S > 2048 else 2, S, S)
    (jl, _), jg = jax.value_and_grad(
        lambda p: JMR.loss_fn(p, jax.tree.map(jnp.asarray, batch), JCFG_,
                              remat=remat), has_aux=True)(jp)
    tl, tg = _t_loss_and_grads(tp, batch, remat)
    np.testing.assert_allclose(tl.item(), float(jl), rtol=STEP_TOL)
    _assert_trees_close(tg, jg, STEP_TOL, "grad")


# ----------------------------------------------------- train steps

SHAPE = ShapeConfig("t", 32, 4, "train")
TSHAPE = TB.ShapeConfig("t", 32, 4, "train")


def _j_probe_runtime():
    rt = JRuntime()
    rt.attach(rt.load_asm("blk", COUNT_BLOCKS, [JM.MapSpec(
        "blk_counts", JM.MapKind.ARRAY, max_entries=64)], "uprobe"),
        "uprobe:block")
    return rt


def _t_probe_runtime():
    rt = TRuntime()
    rt.attach(rt.load_asm("blk", COUNT_BLOCKS, [TM.MapSpec(
        "blk_counts", TM.MapKind.ARRAY, max_entries=64)], "uprobe"),
        "uprobe:block")
    return rt


def _record_tapes(rt):
    """Wrap the JAX runtime's probe_stage so every tape it runs over is
    kept (a host callback inside the jitted step)."""
    tapes, orig = [], rt.probe_stage

    def probe_stage(rows, maps, aux, mode=None):
        jax.debug.callback(lambda r: tapes.append(np.asarray(r)), rows)
        return orig(rows, maps, aux, mode=mode)
    rt.probe_stage = probe_stage
    return tapes


def _run_t_steps(tp, tcfg, rt, mode, batches):
    state = t_init(TCFG_, tcfg, rt, device=CPU, params=tp)
    step = t_make(TCFG_, tcfg, rt, probe_mode=mode)
    tapes, metrics = [], []
    for b in batches:
        state, m = step(state, b)
        tapes.append(step.last_tape.numpy().copy())
        metrics.append(m)
    return state, tapes, metrics


@pytest.fixture(scope="module")
def jax_three_steps(weights):
    jp, _ = weights
    tcfg = TrainConfig(warmup=2, total_steps=10)
    rt = _j_probe_runtime()
    tapes = _record_tapes(rt)
    state = j_init(jax.random.PRNGKey(0), JCFG_, tcfg, rt)
    state["params"] = jp
    step = jax.jit(j_make(JCFG_, tcfg, rt))
    data = JData(JCFG_, SHAPE, tcfg, seed=3, runtime=rt)
    batches, metrics = [], []
    for _ in range(3):
        b = data.next()
        batches.append(b)
        state, m = step(state, b)
        metrics.append(m)
    jax.effects_barrier()
    return state, tapes, metrics, batches


# stat lanes (mean .. absmax, Q47.16 of f32 statistics) differ in low bits
# between two frameworks' summation orders; every other lane is exact
_INT_LANES = [0, 1, 2, 3, 4, 10, 11, 12, 13, 14, 15]


@pytest.mark.parametrize("mode", ["scan", "vectorized", "fused"])
def test_three_probed_steps_match_jax(weights, jax_three_steps, mode):
    _, tp = weights
    jstate, jtapes, jmetrics, batches = jax_three_steps
    tcfg = TB.TrainConfig(warmup=2, total_steps=10)
    state, tapes, metrics = _run_t_steps(tp, tcfg, _t_probe_runtime(), mode,
                                         batches)
    assert int(state["step"]) == 3
    _assert_trees_close(state["params"], jstate["params"], STEP_TOL,
                        "params")
    _assert_trees_close(state["opt"], jstate["opt"], STEP_TOL, "opt")
    jm, tm = jax.tree.map(np.asarray, jstate["maps"]), to_numpy(
        state["maps"])
    for f in jm["blk_counts"]:
        np.testing.assert_array_equal(tm["blk_counts"][f],
                                      jm["blk_counts"][f])
    # 2 layers x 3 steps (uprobe on entry only)
    np.testing.assert_array_equal(tm["blk_counts"]["values"][:2], [3, 3])
    assert len(jtapes) == len(tapes) == 3
    for jt, tt in zip(jtapes, tapes):
        assert jt.shape == tt.shape
        np.testing.assert_array_equal(tt[:, _INT_LANES], jt[:, _INT_LANES])
        np.testing.assert_allclose(tt[:, 5:10], jt[:, 5:10], rtol=1e-4,
                                   atol=64)
    for j, t in zip(jmetrics, metrics):
        np.testing.assert_allclose(float(t["loss"]), float(j["loss"]),
                                   rtol=STEP_TOL)
        np.testing.assert_allclose(float(t["grad_norm"]),
                                   float(j["grad_norm"]), rtol=STEP_TOL)
        assert int(t["vetoed"]) == int(j["vetoed"]) == 0


def test_tape_identical_with_and_without_remat(weights, jax_three_steps,
                                              monkeypatch):
    """The remat recompute fires no probe: the tape, the maps and the
    number of tensor_stats calls are those of the step without remat."""
    _, tp = weights
    batches = jax_three_steps[3]
    rt = TRuntime()
    TL.attach_train_probes(rt)
    rt.attach(rt.load_asm("blk", COUNT_BLOCKS, [TM.MapSpec(
        "blk_counts", TM.MapKind.ARRAY, max_entries=64)], "uprobe"),
        "uprobe:block")
    calls = []

    def counting_row(x, *header):
        calls.append(x.numel())
        return ref.tensor_stats_row(x, *header)

    # the collector's default route: one row (one kernel launch) per event
    monkeypatch.setattr(ops, "tensor_stats_row", counting_row)
    runs = {}
    for remat in (False, True):
        calls.clear()
        tcfg = TB.TrainConfig(warmup=2, total_steps=10, remat=remat)
        state = t_init(TCFG_, tcfg, rt, device=CPU, params=tp)
        step = t_make(TCFG_, tcfg, rt, probe_mode="fused")
        state, _ = step(state, batches[0])
        runs[remat] = (step.last_tape.numpy(), to_numpy(state["maps"]),
                       len(calls))
    (t0, m0, n0), (t1, m1, n1) = runs[False], runs[True]
    np.testing.assert_array_equal(t1, t0)
    # 2 block entries (two programs, one row each), 1 loss, 1 grad.norm
    assert n0 == n1 == t0.shape[0] == 2 + 1 + 1
    for name in m0:
        for f in m0[name]:
            np.testing.assert_array_equal(m1[name][f], m0[name][f])


def test_grad_accum_equivalence(weights):
    """k microbatches of size m == one batch of k*m (same data)."""
    _, tp = weights
    full = TB.TrainConfig(microbatch=0, warmup=1, lr=1e-3, clip_norm=1e9)
    acc = dataclasses.replace(full, microbatch=2)
    b_full = TData(TCFG_, TSHAPE, full, seed=3).next()
    b_acc = TData(TCFG_, TSHAPE, acc, seed=3).next()
    np.testing.assert_array_equal(
        b_acc["tokens"].reshape(b_full["tokens"].shape), b_full["tokens"])
    s1, _ = t_make(TCFG_, full)(t_init(TCFG_, full, device=CPU, params=tp),
                                b_full)
    s2, _ = t_make(TCFG_, acc)(t_init(TCFG_, acc, device=CPU, params=tp),
                               b_acc)
    for p1, p2 in zip(TO.tree_leaves(s1["params"]),
                      TO.tree_leaves(s2["params"])):
        np.testing.assert_allclose(p1.numpy(), p2.numpy(), rtol=2e-4,
                                   atol=2e-5)


def test_probed_microbatch_counts_blocks(weights):
    _, tp = weights
    rt = _t_probe_runtime()
    tcfg = TB.TrainConfig(warmup=2, microbatch=2)
    state = t_init(TCFG_, tcfg, rt, device=CPU, params=tp)
    step = t_make(TCFG_, tcfg, rt)
    state, _ = step(state, TData(TCFG_, TSHAPE, tcfg, seed=3,
                                 runtime=rt).next())
    # 2 layers x 2 microbatches
    np.testing.assert_array_equal(
        state["maps"]["blk_counts"]["values"][:2].numpy(), [2, 2])


def test_device_filter_vetoes_update(weights):
    """A filter overriding on probe:loss leaves params and optimizer state
    bit-identical; the step still advances."""
    _, tp = weights
    rt = TRuntime()
    rt.attach(rt.load_asm("veto", VETO_ALWAYS, [], "filter"), "probe:loss")
    tcfg = TB.TrainConfig(warmup=0)
    state = t_init(TCFG_, tcfg, rt, device=CPU, params=tp)
    before = (_np(state["params"]), _np(state["opt"]))
    state, m = t_make(TCFG_, tcfg, rt)(state, TData(
        TCFG_, TSHAPE, tcfg, seed=3, runtime=rt).next())
    assert int(m["vetoed"]) == 1
    assert int(state["step"]) == 1
    for a, b in zip(jax.tree.leaves(before),
                    jax.tree.leaves((_np(state["params"]),
                                     _np(state["opt"])))):
        np.testing.assert_array_equal(a, b)


def test_data_fetch_filter_skips_batches():
    rt = TRuntime()
    prog = """
        ldxdw r6, [r1+ctx:arg0]
        mod r6, 2
        jne r6, 0, out
        mov r1, 1
        call override_return
        out:
        mov r0, 0
        exit
    """
    rt.attach(rt.load_asm("skip", prog, [], "filter"),
              "filter:sys_data_fetch")
    data = TData(TCFG_, TSHAPE, TB.TrainConfig(), runtime=rt)
    assert [data.next() is not None for _ in range(6)] == \
        [False, True, False, True, False, True]


def test_run_training_on_cpu_loss_decreases(capsys):
    state, hist = TL.run_training(ARCH, steps=30, seq_len=32, batch=8,
                                  device=CPU)
    losses = [h["loss"] for h in hist]
    assert losses[-1] < losses[0] - 0.2, losses[::6]
    assert int(state["step"]) == 30 and len(hist) == 30
    assert "step 30" in capsys.readouterr().out


def test_run_training_asks_for_cuda_and_refuses_later_slices():
    # shm, the artifact cache, checkpoints and int8 compression are ported;
    # a cached compiled step and elastic restore wait for ROADMAP A14
    with pytest.raises(NotImplementedError, match="A14"):
        TRuntime().aot_step(lambda: None, ())
    from repro_torch.ckpt import checkpoint as CK
    with pytest.raises(NotImplementedError, match="A14"):
        CK.restore("x", 1, {}, shardings={})
    t_make(TCFG_, TB.TrainConfig(grad_compression="int8"))
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            TL.run_training(ARCH, steps=1)


def test_train_probes_load_and_catch_nan(weights):
    """chip_smoke.py's probe set: counters, the gradient-norm histogram,
    the loss record, and the NaN guard, which vetoes a step whose loss is
    NaN."""
    _, tp = weights
    rt = TRuntime()
    TL.attach_train_probes(rt)
    tcfg = TB.TrainConfig(warmup=0)
    state = t_init(TCFG_, tcfg, rt, device=CPU, params=tp)
    step = t_make(TCFG_, tcfg, rt, probe_mode="fused")
    batch = TData(TCFG_, TSHAPE, tcfg, seed=3, runtime=rt).next()
    state, m = step(state, batch)
    assert int(m["vetoed"]) == 0
    maps = to_numpy(state["maps"])
    np.testing.assert_array_equal(maps["tr_layer_counts"]["values"][:2],
                                  [1, 1])
    assert int(maps["tr_loss_rb"]["head"][0]) == 1
    assert maps["tr_gnorm_hist"]["bins"].sum() == 1
    bad = dict(state)
    bad["params"] = TO.tree_map(lambda p: p.clone(), state["params"])
    bad["params"]["final_norm"]["scale"][0] = float("nan")
    before = _np(bad["params"])
    bad, m = step(bad, batch)
    assert int(m["vetoed"]) == 1
    for a, b in zip(jax.tree.leaves(before),
                    jax.tree.leaves(_np(bad["params"]))):
        np.testing.assert_array_equal(a, b)


# --------------------------------------------------------- the repairs

def test_runtime_live_lane_repairs_match_jax():
    jrt, trt = JRuntime(), TRuntime()
    for attr in ("live", "artifact_cache", "_promoter"):
        assert getattr(trt, attr) is None and getattr(jrt, attr) is None
    assert trt.take_promoted_step() is None
    assert jrt.take_promoted_step() is None
    maps = {"m": {"values": torch.zeros(3, dtype=torch.int64)}}
    assert trt.sync_live_table(maps) is maps
    jmaps = {"m": {"values": jnp.zeros(3, jnp.int64)}}
    assert jrt.sync_live_table(jmaps) is jmaps
    # with a live lane but no table in the state (JAX's rule): untouched
    trt.live, jrt.live = object(), object()
    assert trt.sync_live_table(maps) is maps
    assert jrt.sync_live_table(jmaps) is jmaps


def test_forward_embeds_and_remat_match_jax(weights):
    jp, tp = weights
    rng = np.random.default_rng(9)
    toks = rng.integers(0, JCFG_.vocab_size, (2, 7)).astype(np.int32)
    emb = (rng.standard_normal((2, 3, JCFG_.d_model)) * 0.02).astype(
        np.float32)
    jl, _ = JTF.forward(jp, jnp.asarray(toks), JCFG_,
                        embeds=jnp.asarray(emb), remat=True)
    tl, _ = TTF.forward(tp, torch.as_tensor(toks).long(), TCFG_,
                        embeds=torch.as_tensor(emb), remat=True)
    assert tl.shape == (2, 10, TCFG_.padded_vocab)
    np.testing.assert_allclose(tl.detach().numpy(), np.asarray(jl),
                               rtol=STEP_TOL, atol=STEP_TOL)


def test_probed_scan_remat_emits_rows_once():
    """probed_scan(remat=True): same rows (layer ids included) and same
    gradients as without remat; the recompute in backward emits nothing."""
    sid = TE.SITES.get_or_create("scan.remat.test")
    ws = torch.randn(3, 4, 4, generator=torch.Generator().manual_seed(0))

    def body(c, w):
        c = torch.tanh(c @ w)
        TE.probe_site("scan.remat.test", c)
        return c, None

    out = {}
    for remat in (False, True):
        w = ws.clone().requires_grad_(True)
        x = torch.ones(2, 4)
        with TE.Collector({(sid, TE.KIND_TRACEPOINT)}) as col:
            c, ys = TE.probed_scan(body, x, w, remat=remat)
            assert ys is None
            c.sum().backward()
            rows = col.take_all_rows()
        out[remat] = (rows, w.grad)
    np.testing.assert_array_equal(out[True][0].numpy(), out[False][0].numpy())
    assert out[True][0][:, 2].tolist() == [0, 1, 2]
    np.testing.assert_allclose(out[True][1].numpy(), out[False][1].numpy(),
                               rtol=1e-6)
    # the JAX scan gives the same layer ids
    def jbody(c, w):
        c = jnp.tanh(c @ w)
        JE.probe_site("scan.remat.test", c)
        return c, None

    with JE.Collector({(JE.SITES.get_or_create("scan.remat.test"),
                        JE.KIND_TRACEPOINT)}) as jcol:
        JE.probed_scan(jbody, jnp.ones((2, 4)), jnp.asarray(ws.numpy()),
                       remat=True)
        jrows = np.asarray(jcol.take_all_rows())
    np.testing.assert_array_equal(jrows[:, 2], [0, 1, 2])


def test_train_cli_smoke_default_full_and_device(monkeypatch, capsys):
    """--smoke stays the default, --full turns it off, --device reaches
    run_training."""
    seen = []

    def fake_run_training(arch, **kw):
        seen.append((arch, kw["smoke"], kw["device"], kw["seq_len"]))
        return None, [{"loss": 1.0}]

    monkeypatch.setattr(TL, "run_training", fake_run_training)
    TL.main([])
    TL.main(["--full", "--device", "cpu", "--seq", "4096"])
    assert seen == [(ARCH, True, "cuda", 64), (ARCH, False, "cpu", 4096)]
    assert "final loss 1.0000 after 1 steps" in capsys.readouterr().out
