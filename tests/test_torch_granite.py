"""granite-4.0-h-small in the port against the benchmark's plain float32
reference (`portbench/reference/granite.py`), on the CPU at the
configuration's own smoke cut (one period of ten positions, top-10 of 16
experts, SSD chunk 8) on the benchmark's seeded weights: serving (prefill,
then decoding through the cache) and one training step's loss and
gradients; the SSD prefill at lengths that end mid-chunk; the dropless
router and its fixed combine order; and the presets the new fields leave
alone, bit for bit. One test runs on the card: flash attention at a
softmax scale of its own."""
import contextlib
import hashlib
import types

import pytest

torch = pytest.importorskip("torch")

from portbench import smoke, weights as W  # noqa: E402
from portbench.reference import granite as REF, mamba2 as RM  # noqa: E402
from portbench.reference.train import flat, unflat  # noqa: E402

from repro_torch import telemetry  # noqa: E402
from repro_torch.configs import registry as TCFG  # noqa: E402
from repro_torch.configs.base import ModelConfig  # noqa: E402
from repro_torch.core import events as E  # noqa: E402
from repro_torch.core.runtime import BpftimeRuntime  # noqa: E402
from repro_torch.launch import serve as LS  # noqa: E402
from repro_torch.models import (layers as L, moe as MOE,  # noqa: E402
                                registry as MR, ssm as SSM)
from repro_torch.serve import decode_graph as DG  # noqa: E402

CELL = "granite-4.0-h-small.serve_chat"
SEED = 2**31 + 29
CPU = "cpu"
# float32 on both sides: the port's SSD dual form against the reference's
# recurrence, its capacity-slot experts against the reference's gathered
# ones, summed in other orders; a few float32 roundings of logits that are
# about 1e-2 in size (the head's output over 16)
TOL = 1e-5


@pytest.fixture(scope="module")
def model():
    """(model section, port config, params) at the smoke cut, float32."""
    c = smoke.small_cell(CELL)
    m = dict(c.config["model"], dtype="float32")
    return m, ModelConfig(**m), W.make_params(SEED, {**c.config, "model": m},
                                               CPU)


def _tokens(m, shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, m["vocab_size"], shape, generator=g)


def test_the_smoke_cut_keeps_the_pattern_and_the_routing(model):
    m, cfg, params = model
    assert cfg.superblock == cfg.num_layers == 10
    assert [cfg.block_kind(j) for j in range(10)] == \
        ["mamba"] * 5 + ["attn"] + ["mamba"] * 4
    assert all(cfg.ffn_kind(j) == "moe" for j in range(10))
    assert cfg.experts_per_token == 10 and cfg.moe_dropless
    port = {"/".join(map(str, k)): tuple(v.shape) for k, v in flat(
        MR.init_params(cfg, device=CPU)).items()}
    ours = {"/".join(map(str, k)): tuple(v.shape)
            for k, v in flat(params).items()}
    assert ours == port


# prompts that end mid-chunk (two chunks and a part), at a whole chunk
# (two), and under one chunk
@pytest.mark.parametrize("S", [13, 16, 5])
def test_prefill_then_decode_matches_the_reference(model, S):
    """A batch of 2 prefilled through `prefill_fn`, then 3 tokens decoded
    through the cache by `decode_fn`: every position's logits against the
    reference's full forward pass over the whole sequence."""
    m, cfg, params = model
    toks = _tokens(m, (2, S + 3), S)
    cache = MR.make_cache(cfg, 2, 32, torch.float32, CPU)
    with torch.no_grad():
        got, cache = MR.prefill_fn(params, {"tokens": toks[:, :S]}, cache,
                                   cfg)
        steps = [got]
        for t in range(S, S + 3):
            lg, cache = MR.decode_fn(params, toks[:, t:t + 1], cache, cfg)
            steps.append(lg)
        want = REF.forward(params, toks, m)
    got = torch.cat(steps, 1)
    assert got.shape == want.shape
    torch.testing.assert_close(got, want, rtol=TOL, atol=TOL)
    # the logits are the head's over 16: not all alike
    assert float(want.std()) > 1e-3


def test_a_training_step_matches_the_reference(model):
    """The loss and every gradient leaf of one step of the superblock
    (`loss_fn`, the training mode: the SSD dual form at 12 positions, a
    chunk and a half, and the dropless experts) against the reference's
    `loss`; each leaf within TOL of its own norm, floored at 1e-3 of the
    whole gradient's."""
    m, cfg, params = model
    toks = _tokens(m, (2, 13), 3)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    leaves = {k: v.clone().requires_grad_(True)
              for k, v in flat(params).items()}
    tree = unflat(leaves)
    loss, _ = MR.loss_fn(tree, batch, cfg)
    grads = torch.autograd.grad(loss, list(leaves.values()))
    ref_leaves = {k: v.detach().clone().requires_grad_(True)
                  for k, v in leaves.items()}
    ref_loss = REF.loss(unflat(ref_leaves), batch["tokens"],
                        batch["labels"], m)
    ref_grads = torch.autograd.grad(ref_loss, list(ref_leaves.values()))
    assert abs(float(loss.detach()) - float(ref_loss.detach())) <= \
        TOL * float(ref_loss.detach())
    whole = float(torch.sqrt(sum(g.square().sum() for g in ref_grads)))
    for k, g, r in zip(leaves, grads, ref_grads):
        err = float((g - r).norm())
        assert err <= TOL * max(float(r.norm()), 1e-3 * whole), (k, err)


def _ssd_inputs(cfg, S, seed=0):
    g = torch.Generator().manual_seed(seed)
    H, P = cfg.ssm_heads(), cfg.ssm_headdim
    G, N = cfg.ssm_ngroups, cfg.ssm_state
    xh = torch.randn(2, S, H, P, generator=g)
    dt = torch.nn.functional.softplus(torch.randn(2, S, H, generator=g))
    A = -torch.exp(torch.rand(H, generator=g) * 2.7)
    Bv, Cv = (torch.randn(2, S, G, N, generator=g) for _ in range(2))
    return xh, dt, A, Bv, Cv


@pytest.mark.parametrize("S", [5, 13, 20, 24])
def test_ragged_ssd_matches_the_recurrence(model, S):
    """`ssd_chunked` at chunk 8, its last chunk padded where S is no
    multiple of it: outputs and final state against the token-by-token
    recurrence (the reference's)."""
    _, cfg, _ = model
    xh, dt, A, Bv, Cv = _ssd_inputs(cfg, S)
    y, h = SSM.ssd_chunked(xh, dt, A, Bv, Cv, cfg)
    wy, wh = RM.ssm_recurrent(xh, Bv, Cv, dt, A, return_state=True)
    assert y.shape == xh.shape
    torch.testing.assert_close(y, wy, rtol=1e-4, atol=1e-4)
    torch.testing.assert_close(h, wh, rtol=1e-4, atol=1e-4)


def test_a_padded_chunk_is_a_chunk_of_dt_zero(model):
    """13 positions give, bit for bit, the first 13 outputs and the final
    state of the same inputs padded to 16 with dt 0 (and zeros)."""
    _, cfg, _ = model
    args = _ssd_inputs(cfg, 13)
    y, h = SSM.ssd_chunked(*args, cfg)
    xh, dt, A, Bv, Cv = (torch.nn.functional.pad(
        t, (0, 0) * (t.ndim - 2) + (0, 3)) if t.ndim > 1 else t
        for t in args)
    py, ph = SSM.ssd_chunked(xh, dt, A, Bv, Cv, cfg)
    assert torch.equal(y, py[:, :13]) and torch.equal(h, ph)


def _digest(*ts):
    h = hashlib.sha256()
    for t in ts:
        h.update(t.detach().contiguous().numpy().tobytes())
    return h.hexdigest()


# sha256 of the outputs below as the port computed them before the fields
# of granite (embedding, residual and logit scalars, the attention scale,
# the shared expert's width, the dropless router, the fixed combine order,
# the padded SSD chunk) were added, on one CPU thread
FROZEN = {
    "qwen2-0.5b":
        "034cd91d7a89a27b99e1f9e03b2fd21dcc6d36ed201b297091ce3782eaff462f",
    "jamba-v0.1-52b":
        "7c6096b47e062f2e0810cd999a189236f28ef22efda48466db2c3dbca6086165",
    "llama4-scout-17b-a16e":
        "75e1759779e684dfe1eb50637fcda78b35d64d9f1a62a7010bc50d33ca6b547f",
    "ssd": "703716ae69e2833ebeaac0a8a4372ac40a71f66a70ffa33b1ee2fbd1b213cf8d",
}


@pytest.fixture
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("name", sorted(FROZEN))
def test_other_configs_keep_their_bits(name, one_thread):
    """At the new fields' defaults the qwen2, jamba and llama4-scout smoke
    presets give the logits they gave before, bit for bit (the training
    forward, a prefill of 10 tokens and one decode step), and the SSD at
    whole chunks (10 positions at chunk 2) its outputs and state."""
    if name == "ssd":
        cfg = TCFG.smoke("mamba2-780m")
        g = torch.Generator().manual_seed(9)
        H, P = cfg.ssm_heads(), cfg.ssm_headdim
        G, N = cfg.ssm_ngroups, cfg.ssm_state
        xh = torch.randn(2, 10, H, P, generator=g)
        dt = torch.nn.functional.softplus(torch.randn(2, 10, H, generator=g))
        A = -torch.exp(torch.rand(H, generator=g) * 2.7)
        Bv, Cv = (torch.randn(2, 10, G, N, generator=g) for _ in range(2))
        assert _digest(*SSM.ssd_chunked(xh, dt, A, Bv, Cv, cfg)) == \
            FROZEN[name]
        return
    cfg = TCFG.smoke(name)
    p = MR.init_params(cfg, generator=torch.Generator().manual_seed(7),
                       device=CPU)
    tok = torch.randint(0, cfg.vocab_size, (2, 10),
                        generator=torch.Generator().manual_seed(8))
    with torch.no_grad():
        train, _ = MR.TF.forward(p, tok, cfg, mode="train")
        cache = MR.make_cache(cfg, 2, 16, torch.float32, CPU)
        pre, cache = MR.prefill_fn(p, {"tokens": tok}, cache, cfg)
        dec, _ = MR.decode_fn(p, tok[:, -1:], cache, cfg)
    assert _digest(train, pre, dec) == FROZEN[name]


def test_dropless_routing_and_a_fixed_combine(model):
    """At the smoke cut's top-10 of 16: capacity is the token count and no
    assignment drops; the combine, 10 contributions a token, gives the same
    bits on a second run and, row for row, for the batch permuted."""
    m, cfg, params = model
    p = {k: v[0] for k, v in params["stack"]["blocks"][0]["moe"].items()}
    x = torch.randn(3, 7, m["d_model"], generator=torch.Generator()
                    .manual_seed(5))
    assert MOE.capacity(cfg, 21) == 21
    _, info = MOE.route(p, x, cfg)
    assert bool(info["keep"].all())
    assert int((~info["keep"]).sum()) == 0
    out = MOE.apply_moe(p, x, cfg)
    assert torch.equal(out, MOE.apply_moe(p, x, cfg))
    perm = torch.randperm(21, generator=torch.Generator().manual_seed(6))
    flat_x = x.reshape(1, 21, -1)
    permuted = MOE.apply_moe(p, flat_x[:, perm], cfg)
    assert torch.equal(permuted[0], out.reshape(21, -1)[perm])


class _Graph:
    """A CUDA graph whose capture and replay do nothing: the capture call
    then runs the model's work eagerly, and a replay runs no Python of
    the model."""

    def capture_begin(self, **kwargs):
        pass

    def capture_end(self):
        pass

    def replay(self):
        pass


@pytest.fixture
def no_card_graphs(monkeypatch):
    stream = types.SimpleNamespace(wait_stream=lambda other: None)
    for name, value in (("CUDAGraph", _Graph),
                        ("graph_pool_handle", lambda: None),
                        ("Stream", lambda device=None: stream),
                        ("stream", lambda s: contextlib.nullcontext()),
                        ("current_stream", lambda device=None: stream),
                        ("synchronize", lambda device=None: None),
                        ("empty_cache", lambda: None)):
        monkeypatch.setattr(torch.cuda, name, value)


@pytest.mark.parametrize("name", ["granite", "qwen2-0.5b"])
def test_a_replay_opens_the_spans_and_counts_the_records_again(
        model, name, no_card_graphs, monkeypatch):
    """The graphed decode step (CUDA graphs stubbed) of a probed step:
    captured once, then replayed with telemetry on. Each replayed segment
    that opened one span while it was captured runs inside a span of that
    name, and its records are counted again: granite's 9 `ssm.mixer` and
    10 `moe.routed` spans and 10 `moe.routed` records a step, as the eager
    step opens and counts them; qwen2's segments open none."""
    if name == "granite":
        _, cfg, params = model
    else:
        cfg = TCFG.smoke(name)
        params = MR.init_params(cfg, device=CPU)
    rt = BpftimeRuntime()
    LS.attach_serve_probes(rt, LS.family_probes(cfg))
    wanted = rt.wanted_sites()
    opened = []
    span = telemetry.span

    def noted(name):
        # the model's spans (the emits open theirs, replayed or eager)
        if name in ("moe.routed", "ssm.mixer"):
            opened.append(name)
        return span(name)
    monkeypatch.setattr(telemetry, "span", noted)
    graphs = DG.DecodeGraphs(cfg, wanted, True)
    tokens = torch.tensor([[3], [5]])
    cache = MR.make_cache(cfg, 2, 16, torch.float32, CPU)

    def step(cache):
        with E.Collector(wanted) as col:
            return graphs(params, tokens, cache, col)
    with torch.no_grad():
        _, cache = step(cache)                  # a capture each direction
        _, cache = step(cache)
        with telemetry.recording():
            opened.clear()
            step(cache)                         # a replay
            replayed = telemetry.records()["keyed"]
        spans = sorted(opened)
        with telemetry.recording():
            opened.clear()
            with E.Collector(wanted):
                MR.decode_fn(params, tokens, cache, cfg)
            eager = telemetry.records()["keyed"]
    assert replayed["decode.graph"] == {"replay": 1}
    assert {k: v for k, v in replayed.items() if k != "decode.graph"} == \
        eager
    assert spans == sorted(opened)
    if name == "granite":
        assert spans == ["moe.routed"] * 10 + ["ssm.mixer"] * 9
        assert eager == {"moe.routed": {(16, 10, cfg.d_model, 32, 2, 4): 10}}
    else:
        assert spans == [] and eager == {}


@pytest.mark.cuda
def test_flash_at_a_scale_of_its_own_on_the_card():
    """The bf16 flash kernels at softmax scale 1/128 (granite's
    attention_multiplier, not 1/sqrt(128)) at (B 1, H 32, KH 8, S 4096,
    hd 128) causal, against `full_attention` at that scale (f32 scores on
    the same bf16 inputs) and its autograd gradients, within the route's
    tolerances (`flash_attention.TOL_*`)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels run only on the card)")
    from repro_torch.kernels import flash_attention as FA
    cuda = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    H, KH, S, hd, scale = 32, 8, 4096, 128, 1 / 128
    g = torch.Generator(device=cuda).manual_seed(11)
    q, k, v, do = (torch.randn(n, S, hd, generator=g, device=cuda)
                   .to(torch.bfloat16) for n in (H, KH, KH, H))
    o, lse = FA.flash_fwd_cuda(q, k, v, True, scale)
    dq, dk, dv = FA.flash_bwd_cuda(q, k, v, o, lse, do, True, scale)

    def model_layout(t):                 # [heads, S, hd] -> [1, S, heads, hd]
        return t.permute(1, 0, 2)[None].detach().requires_grad_(True)
    mq, mk, mv = map(model_layout, (q, k, v))
    wo = L.full_attention(mq, mk, mv, causal=True, scale=scale)
    want = torch.autograd.grad(wo, (mq, mk, mv), model_layout(do))
    torch.testing.assert_close(o.float(), wo[0].permute(1, 0, 2).float(),
                               rtol=FA.TOL_BF16_O[0], atol=FA.TOL_BF16_O[1])
    for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        g32, w32 = got.float(), w[0].permute(1, 0, 2).float()
        lim = max(1.0, float(w32.abs().max()))
        torch.testing.assert_close(g32, w32, rtol=FA.TOL_BF16_GRAD[0],
                                   atol=FA.TOL_BF16_GRAD[1] * lim,
                                   msg=name)
        rel = float((g32 - w32).norm() / w32.norm())
        assert rel <= FA.TOL_BF16_NORM, (name, rel)
