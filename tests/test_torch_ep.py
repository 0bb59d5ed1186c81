"""Expert parallelism (`repro_torch.dist.expert_parallel.apply_moe_ep`)
on the CPU: gloo process groups of 1, 2 and 4 ranks on a (1, m) mesh,
against the port's `apply_moe` and the JAX package's.

The layer cases are smoke llama4-scout (4 experts, top-1) and kimi-k2 at
16 experts and k = 8, both at capacity factor 0.5 (the capacity drops);
weights and x come from the JAX package's initialiser and a numpy seed,
carried across as numpy arrays. The workers (`torch_dist_workers.py`)
import no JAX.

Tolerances: each expert's product on a rank is the same GEMM as that
expert's slice of `apply_moe`'s batched product, and the gather and the
slices copy bits, so the outputs and the gradients of every expert
weight are held bit for bit against the port's `apply_moe`; against JAX's
`apply_moe`, within `test_torch_moe.py`'s one-layer TOL (1e-5). The
gradient of x is bit for bit at k = 1; at k = 8 the backward of the
dispatch's gather adds a token's eight contributions in an order that
depends on the CPU's threads (`apply_moe` run twice differs), so there it
is held within TOL.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

import torch_dist_workers as W  # noqa: E402
from repro.configs import registry as JCFG  # noqa: E402
from repro.models import moe as JMOE  # noqa: E402

from repro_torch.configs import registry as TCFG  # noqa: E402
from repro_torch.dist import expert_parallel as EP, sharding as SH  # noqa: E402,E501
from repro_torch.models import moe as TMOE  # noqa: E402

TOL = 1e-5
LLAMA4 = "llama4-scout-17b-a16e"
KIMI = "kimi-k2-1t-a32b"
CASES = [dict(name="llama4", arch=LLAMA4, over=dict(capacity_factor=0.5)),
         dict(name="kimi_k8", arch=KIMI,
              over=dict(capacity_factor=0.5, num_experts=16,
                        experts_per_token=8))]
INFO_INTS = ("gids", "sort_idx", "sorted_eids", "pos_c", "tok_idx", "keep")
WORLDS = (1, 2, 4)


def _inputs(case):
    jc = dataclasses.replace(JCFG.smoke(case["arch"]), **case["over"])
    npp = {k: np.array(v) for k, v in
           JMOE.init_moe(jax.random.PRNGKey(1), jc).items()}
    rng = np.random.default_rng(7)
    x = rng.normal(size=(2, 32, jc.d_model)).astype(np.float32)
    g = rng.normal(size=x.shape).astype(np.float32)
    return jc, npp, x, g


@pytest.fixture(scope="module")
def jax_ref():
    out = {}
    for case in CASES:
        jc, npp, x, g = _inputs(case)
        _, info = JMOE.route(npp, jnp.asarray(x), jc)
        out[case["name"]] = {
            "y": np.asarray(JMOE.apply_moe(npp, jnp.asarray(x), jc)),
            "ints": {k: np.asarray(info[k]) for k in INFO_INTS}}
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """One gloo job per world size, every case and both smoke models."""
    res = {}
    for world in WORLDS:
        d = tmp_path_factory.mktemp(f"ep{world}")
        for case in CASES:
            _, npp, x, g = _inputs(case)
            np.savez(d / f"{case['name']}.npz", x=x, g=g, **npp)
        res[world] = W.launch("ep", world, d, cases=CASES,
                              models=[LLAMA4, "jamba-v0.1-52b"])
    return res


def _bits(a, b, what):
    assert torch.equal(a, b), f"{what}: not bit for bit"


def _dx(case, got, what):
    if case == "llama4":
        _bits(got["dx_ep"], got["dx"], what)
    else:                                       # k = 8: see the docstring
        np.testing.assert_allclose(got["dx_ep"].numpy(), got["dx"].numpy(),
                                   rtol=TOL, atol=TOL, err_msg=what)


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("case", [c["name"] for c in CASES])
def test_ep_route_and_output_match_apply_moe_and_jax(runs, jax_ref, world,
                                                     case):
    ref = jax_ref[case]
    for r, out in enumerate(runs[world]):
        got = out["layers"][case]
        for k in INFO_INTS:
            np.testing.assert_array_equal(got["ints"][k].numpy(),
                                          ref["ints"][k], err_msg=k)
        _bits(got["y_ep"], got["y"], f"rank {r} output")
        _bits(got["y_dtensor"], got["y"], f"rank {r} DTensor weights")
        np.testing.assert_allclose(got["y_ep"].numpy(), ref["y"], rtol=TOL,
                                   atol=TOL)
        assert got["gathers"] == 1, "one expert gather per layer"
    # every rank ends with the same output
    for out in runs[world][1:]:
        _bits(out["layers"][case]["y_ep"], runs[world][0]["layers"][case]
              ["y_ep"], "ranks disagree")


@pytest.mark.parametrize("case", [c["name"] for c in CASES])
def test_ep_gradients_at_two_ranks_match_apply_moe(runs, case):
    for r, out in enumerate(runs[2]):
        got = out["layers"][case]
        _dx(case, got, f"rank {r} dx")
        for k in ("router", "w_in", "w_gate", "w_out"):
            _bits(got["dw_ep"][k], got["dw"][k], f"rank {r} d{k}")
        assert float(got["dw"]["w_in"].abs().sum()) > 0


@pytest.mark.parametrize("world", (2, 4))
def test_ep_gradients_hold_at_four_ranks_too(runs, world):
    got = runs[world][-1]["layers"]["kimi_k8"]
    _dx("kimi_k8", got, "dx")
    _bits(got["dw_ep"]["w_out"], got["dw"]["w_out"], "dw_out")


@pytest.mark.parametrize("world", WORLDS)
@pytest.mark.parametrize("arch", [LLAMA4, "jamba-v0.1-52b"])
def test_switch_routes_a_smoke_model_through_the_expert_gather(runs, world,
                                                               arch):
    for out in runs[world]:
        got = out["models"][arch]
        _bits(got["on"], got["off"], "REPRO_MOE_EP=1 logits")
        assert got["gathers"] == got["moe_layers"] > 0
        assert got["gathers_off"] == 0


def test_ep_falls_back_when_model_does_not_divide_the_experts(monkeypatch):
    class FakeMesh:
        axis_names = ("data", "model")
        shape = {"data": 1, "model": 3}
    cfg = TCFG.smoke(LLAMA4)            # 4 experts over 3 ranks
    p = TMOE.init_moe(torch.Generator().manual_seed(0), cfg, "cpu")
    x = torch.randn(2, 8, cfg.d_model,
                    generator=torch.Generator().manual_seed(1))
    g0 = EP.GATHERS
    with SH.use_mesh(FakeMesh()):
        y = EP.apply_moe_ep(p, x, cfg)
    assert EP.GATHERS == g0
    _bits(y, TMOE.apply_moe(p, x, cfg), "fallback")
    # no mesh, and a mesh without 'model'
    _bits(EP.apply_moe_ep(p, x, cfg), y, "no mesh")

    class DataOnly:
        axis_names = ("data",)
        shape = {"data": 2}
    with SH.use_mesh(DataOnly()):
        _bits(EP.apply_moe_ep(p, x, cfg), y, "no model axis")
    assert EP.GATHERS == g0


def test_moe_dispatch_reads_the_switch_on_every_call(monkeypatch):
    from repro_torch.models import transformer as TF

    class FakeMesh:
        axis_names = ("data", "model")
        shape = {"data": 1, "model": 2}
    cfg = TCFG.smoke(LLAMA4)
    called = []
    monkeypatch.setattr("repro_torch.dist.expert_parallel.apply_moe_ep",
                        lambda p, x, c: called.append("ep") or x)
    monkeypatch.setattr(TF.MOE, "apply_moe",
                        lambda p, x, c: called.append("gspmd") or x)
    x = torch.zeros(1, 2, cfg.d_model)
    with SH.use_mesh(FakeMesh()):
        monkeypatch.setenv("REPRO_MOE_EP", "1")
        TF._moe_dispatch({}, x, cfg)
        monkeypatch.setenv("REPRO_MOE_EP", "0")
        TF._moe_dispatch({}, x, cfg)
    monkeypatch.setenv("REPRO_MOE_EP", "1")
    TF._moe_dispatch({}, x, cfg)                 # no mesh
    assert called == ["ep", "gspmd", "gspmd"]
