"""The plain reference held against the port at smoke width on the CPU,
both in float32: qwen2's logits, loss and gradients; mamba2's logits and
the SSD's output and last state; the training steps' readings; and the
maps the probe programs leave, against what reference/probes.py says
they must hold. (The reference itself imports nothing of the port.)"""
import pytest

torch = pytest.importorskip("torch")

from portbench import smoke, train_cell, weights as W  # noqa: E402
from portbench.reference import mamba2 as RM, model, probes as RP  # noqa: E402
from portbench.reference.train import flat  # noqa: E402

SEED = 2**31 + 11


def f32_cell(name):
    c = smoke.small_cell(name)
    c.config["model"]["dtype"] = "float32"
    c.config["train"]["compute_dtype"] = "float32"
    return c


def port_cfg(m):
    from repro_torch.configs.base import ModelConfig
    return ModelConfig(**m)


@pytest.mark.parametrize("name,S", [("qwen2-0.5b.train_4k", 48),
                                    ("mamba2-780m.train_4k", 48)])
def test_logits_match_the_port(name, S):
    from repro_torch.models import transformer as TF
    c = f32_cell(name)
    m = c.config["model"]
    params = W.make_params(SEED, c.config, "cpu")
    toks = torch.randint(0, m["vocab_size"], (2, S),
                         generator=torch.Generator().manual_seed(1))
    want, _ = TF.forward(params, toks, port_cfg(m), mode="train")
    got = model(c.config["reference"]).forward(params, toks, m)
    scale = want.abs().max()
    assert (got - want).abs().max() <= 1e-4 * scale


def test_qwen2_loss_and_gradients_match_the_port():
    from repro_torch.models import registry as MR
    c = f32_cell("qwen2-0.5b.train_4k")
    m = c.config["model"]
    params = W.make_params(SEED, c.config, "cpu")
    g = torch.Generator().manual_seed(2)
    seq = torch.randint(0, m["vocab_size"], (2, 33), generator=g)
    toks, labels = seq[:, :-1], seq[:, 1:]
    leaves = {k: v.clone().requires_grad_(True)
              for k, v in flat(params).items()}
    from portbench.reference.train import unflat
    lp, _ = MR.loss_fn(unflat(leaves), {"tokens": toks, "labels": labels},
                       port_cfg(m))
    gp = torch.autograd.grad(lp, list(leaves.values()))
    leaves_r = {k: v.clone().requires_grad_(True)
                for k, v in flat(params).items()}
    lr_ = model("qwen2").loss(unflat(leaves_r), toks, labels, m)
    gr = torch.autograd.grad(lr_, list(leaves_r.values()))
    lp, lr_ = float(lp.detach()), float(lr_.detach())
    assert abs(lp - lr_) <= 1e-5 * abs(lr_)
    total = torch.sqrt(sum(x.square().sum() for x in gr))
    for k, a, b in zip(leaves, gp, gr):
        assert (a - b).norm() <= 1e-4 * max(float(b.norm()),
                                            1e-3 * float(total)), k


def test_ssd_output_and_state_match_the_port():
    from repro_torch.models import ssm
    c = f32_cell("mamba2-780m.train_4k")
    cfg = port_cfg(c.config["model"])
    g = torch.Generator().manual_seed(3)
    B, S, H, P, N = 2, 32, cfg.ssm_heads(), cfg.ssm_headdim, cfg.ssm_state
    x = torch.randn(B, S, H, P, generator=g)
    Bm = torch.randn(B, S, 1, N, generator=g)
    Cm = torch.randn(B, S, 1, N, generator=g)
    dt = torch.rand(B, S, H, generator=g) * 0.2
    A = -1 - 15 * torch.rand(H, generator=g)
    y, h = ssm.ssd_chunked(x, dt, A, Bm, Cm, cfg)
    yr, hr = RM.ssm_recurrent(x, Bm, Cm, dt, A, return_state=True)
    assert (y - yr).abs().max() <= 1e-4 * yr.abs().max()
    assert (h - hr).abs().max() <= 1e-4 * hr.abs().max()
    yq = RM.ssm_quadratic(x, Bm, Cm, dt, A, torch.matmul, rows=8)
    assert (yq - yr).abs().max() <= 1e-5 * yr.abs().max()


@pytest.mark.parametrize("name", ["qwen2-0.5b.train_4k",
                                  "mamba2-780m.train_4k"])
def test_training_readings_match_the_port(name):
    """The train cell's check at float32: the port's first steps against
    the reference's, every number far under its limit."""
    import time
    c = f32_cell(name)
    _, values, steps, vetoed = train_cell.run(
        c, SEED, 0.5, False, torch.device("cpu"), time.perf_counter())
    assert vetoed == 0 and steps >= c.traffic["check_steps"]
    assert values["loss_gap"] < 1e-5
    assert values["grad_gap"] < 1e-3
    assert values["update_gap"] < 1e-3
    for k in ("counter_errors", "hist_count_error", "ring_head_error"):
        assert values[k] == 0, k


def test_probe_maps_match_the_reference_semantics():
    """A few probed decode steps of the port's engine leave the counts
    reference/probes.py works out: per layer one entry a step in the
    ARRAY and HASH counters and the histograms, one ring record a step."""
    from repro_torch.core.runtime import to_numpy
    from portbench import serve_cell
    c = smoke.small_cell("mamba2-780m.serve_chat")
    engine, reqs, _ = serve_cell.build(c, SEED, torch.device("cpu"))
    engine.submit_all(reqs[:6])
    maps = to_numpy(engine.maps)
    steps, L = engine.step_count, c.config["model"]["num_layers"]
    assert steps > 0
    assert RP.counter_errors(maps["sv_layer_counts"], steps, L, "array") == 0
    assert RP.counter_errors(maps["sv_key_hash"], steps, L, "hash") == 0
    assert RP.hist_total_error(maps["sv_rms_hist"], steps * L) == 0
    assert RP.hist_total_error(maps["ssm_rms_hist"], steps * L) == 0
    assert RP.ring_head_error(maps["sv_logits_rb"], steps) == 0
    # one more step is one more everywhere
    assert RP.counter_errors(maps["sv_layer_counts"], steps + 1, L,
                             "array") == L


@pytest.mark.parametrize("name", ["qwen2-0.5b.serve_chat",
                                  "mamba2-780m.serve_chat"])
def test_probe_expectations_come_from_the_configuration(name):
    """serve_cell's map and event checks read the sites' events from the
    configuration's probe_sites, with no family named in the harness:
    the port's own maps after a few steps read no error, and one step
    more than it took reads one everywhere."""
    from repro_torch.core.runtime import to_numpy
    from repro_torch.launch import serve as L
    from portbench import serve_cell
    c = smoke.small_cell(name)
    engine, reqs, _ = serve_cell.build(c, SEED, torch.device("cpu"))
    engine.submit_all(reqs[:6])
    maps = to_numpy(engine.maps)
    probes = {p[2][0]: (p[2][1], p[3]) for p in L.family_probes(engine.cfg)}
    steps = engine.step_count
    assert steps > 0
    assert engine.events == steps * serve_cell.events_per_step(probes,
                                                               c.config)
    errs = serve_cell.map_errors(maps, probes, steps, c.config)
    assert errs == {"counter_errors": 0, "hist_count_error": 0,
                    "ring_head_error": 0}
    more = serve_cell.map_errors(maps, probes, steps + 1, c.config)
    assert more["ring_head_error"] == 1
    assert more["hist_count_error"] > 0 and more["counter_errors"] > 0


def test_loss_records_hold_the_loss():
    recs = torch.tensor([[0, 1, round(11.5 * RP.FX_ONE), 0],
                         [0, 1, round(12.0 * RP.FX_ONE), 0]]).numpy()
    assert RP.loss_record_gap(recs, [11.5, 12.0]) == 0
    assert RP.loss_record_gap(recs, [11.5, 12.6]) == pytest.approx(
        0.6 / 12.6)
