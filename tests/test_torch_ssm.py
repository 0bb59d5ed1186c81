"""The port's Mamba-2 (SSD) block and the SSM and hybrid families against
the JAX package, on the CPU: the init's constant leaves bit for bit, the
chunked dual form at four and more chunks, the prefill and decode branches
of apply_mamba with their states, the reference's chunk-length limit and
the port's padded last chunk; then
mamba2 and jamba at smoke width (f32) through prefill, decode, the loss
and serving with the SSM (and, for jamba, the MoE) probes."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import registry as JCFG  # noqa: E402
from repro.models import ssm as JSSM  # noqa: E402

from repro_torch.configs import registry as TCFG  # noqa: E402
from repro_torch.launch import serve as TL  # noqa: E402
from repro_torch.models import registry as TMR, ssm as TSSM  # noqa: E402

from test_torch_moe import (CPU, check_family_forward, check_served,  # noqa: E402,E501
                            family_weights, serve_both)

TOL = 1e-4
MAMBA2 = "mamba2-780m"
JAMBA = "jamba-v0.1-52b"
CONSTANTS = ("conv_b", "A_log", "D", "dt_bias", "norm_scale")


def both_cfgs(arch, **over):
    return (dataclasses.replace(JCFG.smoke(arch), **over),
            dataclasses.replace(TCFG.smoke(arch), **over))


@pytest.mark.parametrize("width", ["smoke", "full"])
@pytest.mark.parametrize("arch", [MAMBA2, JAMBA])
def test_init_constants_equal_jax_bit_for_bit(arch, width):
    """A_log (the log of a linspace), D, dt_bias, conv_b and norm_scale are
    constants: the port's equal the JAX package's to the bit, at the smoke
    head count (8) and the published ones (mamba2 48, jamba 128; a narrow
    model with those heads, headdim 1)."""
    over = {}
    if width == "full":
        nh = JCFG.get(arch).ssm_heads()
        over = dict(d_model=nh // 2, ssm_expand=2, ssm_headdim=1)
    jc, tc = both_cfgs(arch, **over)
    jp = JSSM.init_mamba(jax.random.PRNGKey(0), jc)
    tp = TSSM.init_mamba(torch.Generator().manual_seed(0), tc, CPU,
                         lead=(2,))
    assert tp["A_log"].shape == (2, tc.ssm_heads())
    for k in jp:
        assert tp[k].shape == (2,) + jp[k].shape, k
    for k in CONSTANTS:
        for row in tp[k]:
            np.testing.assert_array_equal(row.numpy(), np.asarray(jp[k]),
                                          err_msg=k)


def _ssd_inputs(cfg, S, seed=0):
    rng = np.random.default_rng(seed)
    H, P = cfg.ssm_heads(), cfg.ssm_headdim
    G, N = cfg.ssm_ngroups, cfg.ssm_state
    f = np.float32
    xh = rng.normal(size=(2, S, H, P)).astype(f)
    dt = np.log1p(np.exp(rng.normal(size=(2, S, H)))).astype(f)
    A = -np.exp(rng.uniform(0, 2.7, H)).astype(f)
    Bv, Cv = (rng.normal(size=(2, S, G, N)).astype(f) for _ in range(2))
    return xh, dt, A, Bv, Cv


@pytest.mark.parametrize("S", [8, 10, 16])
def test_ssd_chunked_matches_jax(S):
    """The dual form at chunk 2: 4, 5 and 8 chunks through the loop."""
    jc, tc = both_cfgs(MAMBA2)
    args = _ssd_inputs(jc, S)
    jy, jh = JSSM.ssd_chunked(*map(jnp.asarray, args), jc)
    ty, th = TSSM.ssd_chunked(*map(torch.as_tensor, args), tc)
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy), rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=TOL,
                               atol=TOL)


def test_both_packages_raise_on_a_partial_chunk():
    """The reference's limit: S must be a multiple of min(ssm_chunk, S),
    and the JAX package raises on 7 positions at chunk 2. The port takes
    them, its last chunk padded with dt 0 (models/ssm.py): its 7 outputs
    and final state are the JAX package's over the same inputs padded to
    8 positions with dt 0."""
    jc, tc = both_cfgs(MAMBA2)
    args = _ssd_inputs(jc, 7)
    with pytest.raises(AssertionError):
        JSSM.ssd_chunked(*map(jnp.asarray, args), jc)
    xh, dt, A, Bv, Cv = (np.concatenate([t, np.zeros_like(t[:, :1])], 1)
                         if t.ndim > 1 else t for t in args)
    jy, jh = JSSM.ssd_chunked(*map(jnp.asarray, (xh, dt, A, Bv, Cv)), jc)
    ty, th = TSSM.ssd_chunked(*map(torch.as_tensor, args), tc)
    assert ty.shape[1] == 7
    np.testing.assert_allclose(ty.numpy(), np.asarray(jy)[:, :7], rtol=TOL,
                               atol=TOL)
    np.testing.assert_allclose(th.numpy(), np.asarray(jh), rtol=TOL,
                               atol=TOL)


def test_apply_mamba_prefill_and_decode_match_jax():
    """The prefill branch with return_state, then three recurrent steps
    from that state: outputs and (conv, ssm) states."""
    jc, tc = both_cfgs(MAMBA2)
    jp = JSSM.init_mamba(jax.random.PRNGKey(2), jc)
    tp = TMR.params_from_numpy(jax.tree.map(np.asarray, jp), CPU)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(2, 6, jc.d_model)).astype(np.float32)
    jy, jcache = JSSM.apply_mamba(jp, jnp.asarray(x), jc, return_state=True)
    ty, tcache = TSSM.apply_mamba(tp, torch.as_tensor(x), tc,
                                  return_state=True)
    assert TSSM.apply_mamba(tp, torch.as_tensor(x), tc)[1] is None

    def close(t, j):
        np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=TOL,
                                   atol=TOL)
    close(ty, jy)
    for _ in range(3):
        for f in ("conv", "ssm"):
            close(tcache[f], jcache[f])
        x1 = rng.normal(size=(2, 1, jc.d_model)).astype(np.float32)
        jy, jcache = JSSM.apply_mamba(jp, jnp.asarray(x1), jc, cache=jcache)
        ty, tcache = TSSM.apply_mamba(tp, torch.as_tensor(x1), tc,
                                      cache=tcache)
        close(ty, jy)
    empty = TSSM.init_mamba_cache(tc, 2, torch.float32, CPU)
    jempty = JSSM.init_mamba_cache(jc, 2, jnp.float32)
    for f in ("conv", "ssm"):
        assert empty[f].shape == jempty[f].shape
        assert empty[f].dtype == getattr(torch, str(jempty[f].dtype))


def test_the_decode_step_keeps_conv_in_the_compute_dtype():
    """A bf16 model's conv state becomes bf16 after a step, whatever the
    cache held; the ssm state stays f32 (as in JAX)."""
    _, tc = both_cfgs(MAMBA2, dtype="bfloat16")
    tp = TSSM.init_mamba(torch.Generator().manual_seed(0), tc, CPU)
    cache = TSSM.init_mamba_cache(tc, 2, torch.float32, CPU)
    x = torch.randn(2, 1, tc.d_model).to(torch.bfloat16)
    y, cache = TSSM.apply_mamba(tp, x, tc, cache=cache)
    assert y.dtype == torch.bfloat16
    assert cache["conv"].dtype == torch.bfloat16
    assert cache["ssm"].dtype == torch.float32


# ------------------------------------------------------------ whole families

@pytest.fixture(scope="module", params=[MAMBA2, JAMBA])
def family(request):
    return request.param, family_weights(request.param)


def test_family_forward_decode_and_loss_match_jax(family):
    check_family_forward(family[1])


def test_family_serves_as_jax_with_its_probes(family):
    arch, weights = family
    tc = weights[1]
    per_layer = {MAMBA2: 3, JAMBA: None}[arch]
    if per_layer is None:
        # jamba's 8-layer superblock: block entry and exit and the mixer's
        # ssm.out on its 7 mamba layers; moe.load and moe.drops on its 4
        # MoE layers
        n_super = tc.num_layers // tc.superblock
        per_step = n_super * (2 * 8 + 7 + 2 * 4) + 1
    else:
        per_step = per_layer * tc.num_layers + 1
    tm = check_served(serve_both(weights), per_step)
    steps = tm["sv_logits_rb"]["head"][0]
    n_mamba = sum(tc.block_kind(j) == "mamba" for j in range(tc.superblock))
    assert tm["ssm_rms_hist"]["bins"].sum() == \
        steps * n_mamba * tc.num_layers // tc.superblock


def test_launcher_stops_where_the_reference_does(capsys):
    """With the default requests the third prompt has 3 tokens, not a
    multiple of the smoke SSD chunk: the JAX package's SSD stops there
    (the launcher's AssertionError). The port's prefill pads the last
    chunk, so its launcher serves all eight requests."""
    jc, _ = both_cfgs(MAMBA2)
    with pytest.raises(AssertionError):
        JSSM.ssd_chunked(*map(jnp.asarray, _ssd_inputs(jc, 3)), jc)
    TL.main(["--arch", MAMBA2, "--device", CPU])
    assert "served 8, rejected 0" in capsys.readouterr().out
