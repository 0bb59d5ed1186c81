"""Training of every family against the JAX package, on the CPU: the loss
gradients of every arch of `configs/registry.py` at smoke width (f32),
with and without remat, plus the encoder's flash branch at 4096 frames and
M-RoPE with patch-grid ids; the MoE router's backward where it is not zero
(top-2, and 16 experts top-8); three probed train steps at each family's
production preset (`launch/presets.train_config`: Adafactor with bf16
parameters or AdamW in f32, microbatches accumulated in f32); one step of
llama4-scout at its preset, whose top-1 router trains on rounding noise;
and the presets themselves. Weights come from the JAX package, inputs from
a numpy seed or the data pipeline, carried across as numpy arrays."""
import dataclasses
import functools
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import registry as JCFG  # noqa: E402
from repro.configs.base import ShapeConfig as JShape  # noqa: E402
from repro.core import maps as JM  # noqa: E402
from repro.core.runtime import BpftimeRuntime as JRuntime  # noqa: E402
from repro.data.pipeline import SyntheticDataset as JData  # noqa: E402
from repro.launch import presets as JPRE  # noqa: E402
from repro.models import registry as JMR  # noqa: E402
from repro.train.train_step import (init_train_state as j_init,  # noqa: E402
                                    make_train_step as j_make)

from torch_card import block_targets  # noqa: E402
from repro_torch.configs import registry as TCFG  # noqa: E402
from repro_torch.core import maps as TM  # noqa: E402
from repro_torch.core.runtime import BpftimeRuntime as TRuntime, to_numpy  # noqa: E402,E501
from repro_torch.launch import presets as TPRE, train as TL  # noqa: E402
from repro_torch.models import layers as TLY, registry as TMR  # noqa: E402
from repro_torch.optim import optimizers as TO  # noqa: E402
from repro_torch.train.train_step import (init_train_state as t_init,  # noqa: E402,E501
                                          make_train_step as t_make)

CPU = "cpu"
LLAMA4 = "llama4-scout-17b-a16e"
MAMBA2 = "mamba2-780m"
SEAMLESS = "seamless-m4t-medium"
QWEN2_VL = "qwen2-vl-72b"
JAMBA = "jamba-v0.1-52b"
KIMI = "kimi-k2-1t-a32b"
ARCHS = sorted(TCFG.ARCHS)
# each gradient leaf within GRAD_TOL of its own norm, floored at GRAD_FLOOR
# of the whole gradient's: a leaf whose gradient is zero in exact
# arithmetic (a top-1 router, a k bias by the softmax's shift invariance)
# holds only rounding noise, which two frameworks do not share
GRAD_TOL, GRAD_FLOOR = 1e-4, 1e-3
STEP_TOL = 1e-4          # f32 parameters, optimizer state, loss, grad norm
# bf16 parameters after a few steps at the preset: an entry may be more than
# one bf16 ulp from JAX's where a gradient entry rounded to bf16 on one side
# only shifted its later moves (an entry near zero has many small ulps; a
# column of Adafactor's factored moment whose gradient is at rounding
# level, as the low-frequency rotary dims of a k bias, moves by noise), but
# by no more than BF16_LR_FRAC of the steps' summed learning rate (0.068 of
# it at most in the runs of this file), and in at most BF16_APART_SHARE of
# all entries
BF16_LR_FRAC, BF16_APART_SHARE = 0.125, 1e-3
# a gradient at most this large is rounding noise of a zero
NOISE_GRAD = 1e-8
GRID = (2, 4)            # the smoke frontend's 8 patches
# stat lanes (mean .. absmax, Q47.16 of f32 statistics) differ in low bits
# between two frameworks' summation orders; every other lane is exact
INT_LANES = [0, 1, 2, 3, 4, 10, 11, 12, 13, 14, 15]


def to_torch(tree):
    return TMR.params_from_numpy(jax.tree.map(np.asarray, tree), CPU)


def _f32(x):
    """A leaf as numpy, floats as f32 (bf16 included)."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.is_floating_point() else x).numpy()
    a = np.asarray(x)
    return a.astype(np.float32) if jnp.issubdtype(a.dtype, jnp.floating) \
        else a


def _np(tree):
    if isinstance(tree, dict):
        return {k: _np(v) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_np(v) for v in tree]
    return _f32(tree)


def _paths(tree):
    """(path string, numpy leaf) of a JAX-ordered tree."""
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [(jax.tree_util.keystr(p), _f32(x)) for p, x in flat]


def _configs(arch, **over):
    return (dataclasses.replace(JCFG.smoke(arch), **over),
            dataclasses.replace(TCFG.smoke(arch), **over))


@functools.lru_cache(maxsize=None)
def _jax_params(arch, over):
    """JAX's initial parameters of `arch` (config fields `over`, a tuple of
    pairs), made once: cases with and without remat share them."""
    return JMR.init_params(jax.random.PRNGKey(0),
                           _configs(arch, **dict(over))[0])


def _weights(arch, over=()):
    jc, tc = _configs(arch, **dict(over))
    jp = _jax_params(arch, tuple(over))
    return jc, tc, jp, to_torch(jp)


def _batch(cfg, B, S, seed, frames=None, grid=False):
    """A numpy batch of the family's inputs: tokens and labels (some
    masked), `frames` encoder frames for the encoder-decoder, the frontend's
    embeddings (and with `grid` their M-RoPE ids) for the VLM."""
    rng = np.random.default_rng(seed)
    batch = {}
    n_text = S
    if cfg.family == "encdec":
        batch["enc_embeds"] = rng.normal(
            size=(B, frames or S, cfg.d_model)).astype(np.float32)
    elif cfg.frontend != "none":
        Ft = cfg.frontend_tokens
        n_text = S - Ft
        batch["embeds"] = rng.normal(size=(B, Ft, cfg.d_model)) \
            .astype(np.float32)
        if grid:
            batch["positions"] = TLY.mrope_grid_positions(
                *GRID, n_text, B).numpy()
    batch["tokens"] = rng.integers(0, cfg.vocab_size, (B, n_text)) \
        .astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[0, :3] = -1
    if cfg.frontend != "none" and cfg.family != "encdec":
        labels[:, :cfg.frontend_tokens] = -1       # no loss on the patches
    batch["labels"] = labels
    return batch


def _jax_grads(jc, jp, batch, remat):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, _), g = jax.jit(jax.value_and_grad(
        lambda p, b: JMR.loss_fn(p, b, jc, remat=remat), has_aux=True))(
            jp, jb)
    return float(loss), _paths(g)


def _torch_grads(tc, tp, batch, remat):
    leaves = [p.detach().clone().requires_grad_(True)
              for p in TO.tree_leaves(tp)]
    it = iter(leaves)
    order = {id(p): next(it) for p in TO.tree_leaves(tp)}
    p2 = TO.tree_map(lambda p: order[id(p)], tp)
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    loss, _ = TMR.loss_fn(p2, tb, tc, remat=remat)
    grads = torch.autograd.grad(loss, leaves)
    return float(loss.detach()), [_f32(g) for g in grads]


def check_grads(jc, tc, jp, tp, batch, remat):
    """Loss within GRAD_TOL relative; each leaf within GRAD_TOL of its own
    norm, floored at GRAD_FLOOR of the whole gradient's. Returns the JAX
    gradient's (path, leaf) list and the port's leaves."""
    jl, jg = _jax_grads(jc, jp, batch, remat)
    tl, tg = _torch_grads(tc, tp, batch, remat)
    assert len(tg) == len(jg) > 0
    np.testing.assert_allclose(tl, jl, rtol=GRAD_TOL)
    floor = GRAD_FLOOR * math.sqrt(sum(float(np.square(w).sum())
                                       for _, w in jg))
    for (path, w), g in zip(jg, tg):
        assert g.shape == w.shape, path
        err = float(np.linalg.norm(g - w)) / max(float(np.linalg.norm(w)),
                                                 floor)
        assert err <= GRAD_TOL, f"{path}: {err:.2e}"
    return jg, tg


# (arch, remat, extra): every arch with and without remat; seamless with
# 4096 frames (the encoder's flash branch: ref.flash_fwd/ref.flash_bwd,
# non-causal, against JAX's chunked online softmax); qwen2-vl with
# patch-grid M-RoPE ids; llama4-scout's attention (40 q over 8 kv heads of
# 128: rep 5, hd 128) cut to 5 over 1 head of 128 at 4096 positions (the
# causal flash branch). The 4096-position cases run one layer (one encoder
# and one decoder layer), without remat for llama4-scout, to keep the CPU
# time
GRAD_CASES = [(a, r, None) for a in ARCHS for r in (False, True)] + [
    (SEAMLESS, True, "frames4096"), (QWEN2_VL, True, "grid"),
    (LLAMA4, False, "rep5-hd128-4096")]
# jamba's smoke config is two superblocks of 8 layers; one holds every kind
# of layer (attention, Mamba-2, MoE every second layer), and each case
# compiles in JAX in about half the time
JAMBA_OVER = (("num_layers", 8),)
EXTRA_OVER = {"frames4096": (("enc_layers", 1), ("dec_layers", 1)),
              "rep5-hd128-4096": (("num_heads", 5), ("num_kv_heads", 1),
                                  ("head_dim", 128), ("num_layers", 1))}


def case_over(arch, extra=None):
    """The config fields a case overrides, as a tuple of pairs."""
    return EXTRA_OVER.get(extra) or (JAMBA_OVER if arch == JAMBA else ())


@functools.lru_cache(maxsize=None)
def grad_case(arch, over, remat, extra):
    """check_grads of `arch` (config fields `over`, a tuple of pairs) on a
    batch of 2 x 16 positions, or with `extra`: 4096 encoder frames
    ("frames4096"), patch-grid M-RoPE ids ("grid") or one row of 4096
    positions ("rep5-hd128-4096"). Kept, so a case two tests share is run
    once."""
    jc, tc, jp, tp = _weights(arch, over)
    if extra == "frames4096":
        batch = _batch(jc, 1, 8, 21, frames=4096)
    elif extra == "rep5-hd128-4096":
        batch = _batch(jc, 1, 4096, 21)
    else:
        batch = _batch(jc, 2, 16, 21, grid=extra == "grid")
    return check_grads(jc, tc, jp, tp, batch, remat)


@pytest.mark.parametrize(
    "arch,remat,extra", GRAD_CASES,
    ids=[f"{a}-{'remat' if r else 'plain'}" + (f"-{e}" if e else "")
         for a, r, e in GRAD_CASES])
def test_loss_gradients_match_jax(arch, remat, extra):
    grad_case(arch, case_over(arch, extra), remat, extra)


ROUTER_CASES = [(JAMBA, JAMBA_OVER), (KIMI, (("num_experts", 16),
                                             ("experts_per_token", 8)))]


@pytest.mark.parametrize("arch,over", ROUTER_CASES,
                         ids=["jamba-top2", "kimi-k2-16e-top8"])
def test_router_backward_matches_jax_where_it_is_not_zero(arch, over):
    """With k >= 2 the renormalised gates depend on the router: its
    gradient is not zero, and each router leaf is within GRAD_TOL of its
    own norm (no floor)."""
    jg, tg = grad_case(arch, over, True, None)
    whole = math.sqrt(sum(float(np.square(w).sum()) for _, w in jg))
    routers = [(p, w, g) for (p, w), g in zip(jg, tg) if "router" in p]
    assert routers
    for path, w, g in routers:
        assert float(np.linalg.norm(w)) > GRAD_FLOOR * whole, path
        err = float(np.linalg.norm(g - w)) / float(np.linalg.norm(w))
        assert err <= GRAD_TOL, f"{path}: {err:.2e}"


# ------------------------------------------------------------ the presets

@pytest.mark.parametrize("arch", ARCHS)
def test_presets_match_jax(arch, monkeypatch):
    monkeypatch.delenv("REPRO_MICRO", raising=False)
    for over in ({}, dict(microbatch=2, warmup=2, total_steps=10)):
        want = dataclasses.asdict(JPRE.train_config(arch, **over))
        assert dataclasses.asdict(TPRE.train_config(arch, **over)) == want
    monkeypatch.setenv("REPRO_MICRO", "4")
    assert TPRE.train_config(arch).microbatch == \
        JPRE.train_config(arch).microbatch == 4


# ------------------------------------------------- train steps at the preset

def probe_runtimes(cfg):
    """A JAX and a port runtime with launch/train.TRAIN_PROBES on the
    fused lane, the layer counters at `block_targets(cfg)`."""
    jrt, trt = JRuntime(), TRuntime()
    for name, text, spec, ptype, target in TL.TRAIN_PROBES:
        targets = block_targets(cfg) if target == "uprobe:block" \
            else [target]
        jspec = [] if spec is None else [JM.MapSpec(
            spec[0], JM.MapKind(spec[1]), spec[2], rec_width=spec[3])]
        tspec = [] if spec is None else [TM.MapSpec(
            spec[0], TM.MapKind(spec[1]), spec[2], rec_width=spec[3])]
        jpid = jrt.load_asm(name, text, jspec, ptype)
        tpid = trt.load_asm(name, text, tspec, ptype)
        for target in targets:
            jrt.attach(jpid, target, mode="fused")
            trt.attach(tpid, target, mode="fused")
    return jrt, trt


def record_tapes(rt):
    """Keep every tape the JAX runtime's probe stage runs over (a host
    callback inside the jitted step)."""
    tapes, orig = [], rt.probe_stage

    def probe_stage(rows, maps, aux, mode=None):
        jax.debug.callback(lambda r: tapes.append(np.asarray(r)), rows)
        return orig(rows, maps, aux, mode=mode)
    rt.probe_stage = probe_stage
    return tapes


def preset_batches(jc, tcfg, rt, n, seed=3):
    """n batches of the data pipeline (global batch 4, seq 16); the VLM's
    carry patch-grid M-RoPE ids, laid out as the tokens are."""
    data = JData(jc, JShape("t", 16, 4, "train"), tcfg, seed=seed,
                 runtime=rt)
    out = []
    for _ in range(n):
        b = data.next()
        if jc.rope_kind == "mrope":
            lead = b["tokens"].shape[:-1]
            pos = TLY.mrope_grid_positions(
                *GRID, b["tokens"].shape[-1], math.prod(lead)).numpy()
            b["positions"] = pos.reshape(lead + pos.shape[1:])
        out.append(b)
    return out


def run_both(arch, over, steps, warmup):
    """`steps` probed train steps (fused lane) at the arch's preset with
    `over`ridden fields, from the same weights and batches, in both
    packages. Returns (configs, tcfg, the JAX and the port's (state,
    tapes, metrics), the port's parameters before the steps)."""
    jc, tc, jp, tp = _weights(arch, over)
    kw = dict(microbatch=2, warmup=warmup, total_steps=10)
    jt, tt = JPRE.train_config(arch, **kw), TPRE.train_config(arch, **kw)
    jrt, trt = probe_runtimes(jc)
    jtapes = record_tapes(jrt)
    jstate = j_init(jax.random.PRNGKey(0), jc, jt, jrt)
    jstep = jax.jit(j_make(jc, jt, jrt, probe_mode="fused"))
    tstate = t_init(tc, tt, trt, device=CPU, params=tp)
    before = tstate["params"]
    tstep = t_make(tc, tt, trt, probe_mode="fused")
    jm, tm, ttapes = [], [], []
    for b in preset_batches(jc, jt, jrt, steps):
        jstate, m = jstep(jstate, b)
        jm.append(m)
        tstate, m = tstep(tstate, b)
        tm.append(m)
        ttapes.append(tstep.last_tape.numpy().copy())
    jax.effects_barrier()
    return (jc, tc), tt, (jstate, jtapes, jm), (tstate, ttapes, tm), before


def bf16_apart(got, want, sum_lr):
    """Entries of bf16 leaves (as f32) more than one bf16 ulp of the larger
    magnitude apart (a rounding of the f32 update on either side); fails
    where one is also more than BF16_LR_FRAC of the steps' summed learning
    rate apart. Returns their count."""
    mag = np.maximum(np.abs(got), np.abs(want)).astype(np.float32)
    ulp = np.spacing(mag) * 2.0 ** 16           # f32 spacing x 2^(23 - 7)
    diff = np.abs(got - want)
    assert (diff <= np.maximum(ulp, BF16_LR_FRAC * sum_lr)).all(), \
        float((diff / np.maximum(ulp, BF16_LR_FRAC * sum_lr)).max())
    return int((diff > ulp).sum())


def check_state(tstate, jstate, tt, sum_lr, skip=()):
    """Parameters (bf16 as `bf16_apart` holds them, and at most
    BF16_APART_SHARE of all their entries more than one ulp apart; f32
    within STEP_TOL) and the optimizer state (f32, within STEP_TOL), but
    the leaves in `skip`."""
    bf16 = tt.param_dtype == "bfloat16"
    apart = total = 0
    for what in ("params", "opt"):
        jl = _paths(jstate[what])
        tl = jax.tree.leaves(_np(tstate[what]))
        assert len(tl) == len(jl) > 0
        for (path, w), g in zip(jl, tl):
            if any(s in path for s in skip):
                continue
            if what == "params" and bf16:
                apart += bf16_apart(g, w, sum_lr)
                total += g.size
            else:
                np.testing.assert_allclose(g, w, rtol=STEP_TOL,
                                           atol=STEP_TOL, err_msg=path)
    assert apart <= BF16_APART_SHARE * total, (apart, total)


def check_maps_and_tapes(tstate, ttapes, jstate, jtapes):
    """Maps bit for bit, but the loss ring's mean lane within 1 (of 2^16):
    it is the Q47.16 of the f32 loss, which the two frameworks compute in
    different orders (check_metrics holds the loss within STEP_TOL), as
    tests/test_torch_encdec.py holds a ring's stat lanes; the tapes'
    integer lanes bit for bit."""
    jm = jax.tree.map(np.asarray, jstate["maps"])
    tm = to_numpy(tstate["maps"])
    assert set(tm) == set(jm)
    for name in jm:
        for f in jm[name]:
            t, j = tm[name][f], jm[name][f]
            if (name, f) == ("tr_loss_rb", "data"):
                np.testing.assert_allclose(t[:, 2], j[:, 2], rtol=0, atol=1,
                                           err_msg="tr_loss_rb.data mean")
                t, j = np.delete(t, 2, axis=1), np.delete(j, 2, axis=1)
            np.testing.assert_array_equal(t, j, err_msg=f"{name}.{f}")
    assert len(jtapes) == len(ttapes)
    for jt, tt in zip(jtapes, ttapes):
        assert jt.shape == tt.shape
        np.testing.assert_array_equal(tt[:, INT_LANES], jt[:, INT_LANES])
    return tm


def check_metrics(tm, jm):
    for t, j in zip(tm, jm):
        np.testing.assert_allclose(float(t["loss"]), float(j["loss"]),
                                   rtol=STEP_TOL)
        np.testing.assert_allclose(float(t["grad_norm"]),
                                   float(j["grad_norm"]), rtol=STEP_TOL)
        assert int(t["vetoed"]) == int(j["vetoed"]) == 0


def layer_events(cfg) -> int:
    """Layer-counter events of one microbatch: one a layer, and in the
    encoder-decoder one an encoder and one a decoder layer."""
    return cfg.enc_layers + cfg.dec_layers if cfg.family == "encdec" \
        else cfg.num_layers


@pytest.mark.parametrize("arch", [MAMBA2, SEAMLESS, QWEN2_VL, JAMBA])
def test_three_preset_steps_match_jax(arch):
    """mamba2 and seamless at AdamW in f32; qwen2-vl (patch-grid ids) and
    jamba (the top-2 MoE, one superblock) at Adafactor with bf16
    parameters; all in two microbatches of 2, accumulated in f32.
    Parameters within one bf16 ulp or STEP_TOL, optimizer state within
    STEP_TOL, maps and the tapes' integer lanes as check_maps_and_tapes
    holds them."""
    (jc, tc), tt, (js, jtapes, jm), (ts, ttapes, tm), _ = run_both(
        arch, case_over(arch), 3, warmup=2)
    assert int(ts["step"]) == 3
    check_state(ts, js, tt, sum(float(m["lr"]) for m in tm))
    maps = check_maps_and_tapes(ts, ttapes, js, jtapes)
    check_metrics(tm, jm)
    # per step and microbatch: the layers' events and a loss, then the
    # gradient norm
    per_step = 2 * layer_events(tc) + 2 + 1
    assert [t.shape[0] for t in ttapes] == [per_step] * 3
    assert int(maps["tr_loss_rb"]["head"][0]) == 2 * 3
    assert int(maps["tr_gnorm_hist"]["bins"].sum()) == 3


def test_llama4_preset_step_matches_jax_but_for_its_noise_trained_router():
    """llama4-scout routes each token to one expert, and the gates are
    renormalised over the chosen experts (src/repro/models/moe.py:58), so
    every gate is exactly 1 and no loss term depends on the router: its
    gradient is zero in exact arithmetic, and each package holds only
    rounding noise there (|g| < NOISE_GRAD). Adafactor divides a gradient
    by its own RMS, so that noise moves the router by up to its step's
    bound, in directions no two implementations share. So: one step at the
    preset (from step 0 at full lr: warmup 0), every other leaf held as in
    the three-step test, the router's gradient below NOISE_GRAD in both
    packages and its move within Adafactor's bound
    (optim/optimizers.adafactor_move_bound)."""
    (jc, tc), tt, (js, jtapes, jm), (ts, ttapes, tm), before = run_both(
        LLAMA4, (), 1, warmup=0)
    assert tc.experts_per_token == 1 and tt.optimizer == "adafactor"
    check_state(ts, js, tt, float(tm[0]["lr"]), skip=("router",))
    check_maps_and_tapes(ts, ttapes, js, jtapes)
    check_metrics(tm, jm)
    # the router's gradient in both packages, on the step's first
    # microbatch
    b = preset_batches(jc, JPRE.train_config(LLAMA4, microbatch=2), None,
                       1)[0]
    mb = {k: v[0] for k, v in b.items()}
    jp = j_init(jax.random.PRNGKey(0), jc, tt, None)["params"]
    jg = _jax_grads(jc, jp, mb, True)[1]
    tg = _torch_grads(tc, before, mb, True)[1]
    lr = float(tm[0]["lr"])
    assert lr == pytest.approx(tt.lr)
    jpar = _paths(js["params"])
    tpar = jax.tree.leaves(_np(ts["params"]))
    tbef = jax.tree.leaves(_np(before))
    routers = [i for i, (p, _) in enumerate(jg) if "router" in p]
    assert routers
    for i in routers:
        path = jg[i][0]
        assert float(np.abs(jg[i][1]).max()) < NOISE_GRAD, path
        assert float(np.abs(tg[i]).max()) < NOISE_GRAD, path
        for name, after in (("port", tpar[i]), ("jax", jpar[i][1])):
            assert after.shape == tbef[i].shape, path
            rms, bound = TO.adafactor_move_bound(
                torch.tensor(tbef[i]), torch.tensor(after), lr,
                getattr(torch, tt.param_dtype), weight_decay=tt.weight_decay)
            assert rms <= bound, f"{name} {path}: move {rms:.3e} > {bound}"
