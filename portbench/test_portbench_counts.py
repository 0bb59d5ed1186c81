"""The benchmark's operation and byte counts, held to hand-worked cases,
and to what the algorithms they count must at least do."""
import json
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from portbench.counts import dense, flash, probes, ssm  # noqa: E402

HERE = Path(__file__).resolve().parent
PEAK_FLOPS, PEAK_BYTES = 989e12, 3.35e12


def model(name):
    return json.loads((HERE / "configs" / f"{name}.json").read_text())["model"]


def test_qwen2_matmul_params_by_hand():
    # per layer: q 896x896, k and v 896x128 each, o 896x896, MLP 3 x
    # 896x4864; 24 layers; the tied head 896 x 151936
    layer = 802_816 + 2 * 114_688 + 802_816 + 13_074_432
    assert layer == 14_909_440
    assert dense.matmul_params(model("qwen2-0.5b")) == \
        24 * layer + 136_134_656 == 493_961_216


def test_qwen2_train_flops_per_token_by_hand():
    m = model("qwen2-0.5b")
    # attention: 4 x 14 heads x 64 x (4096 + 1) / 2 positions x 24
    # layers forward, 3x that for forward and backward
    attn = 3 * 4 * 14 * 64 * 4097 / 2 * 24
    assert dense.train_flops_per_token(m, 4096) == \
        pytest.approx(6 * 493_961_216 + attn)
    assert 3.4e9 < dense.train_flops_per_token(m, 4096) < 3.6e9


def test_mamba2_matmul_params_by_hand():
    # in_proj 1536 x (2 x 3072 + 2 x 128 + 48), out_proj 3072 x 1536;
    # 48 layers; the tied head 1536 x 50288 (50277 padded to 16)
    layer = 1536 * 6448 + 3072 * 1536
    assert ssm.matmul_params(model("mamba2-780m")) == \
        48 * layer + 1536 * 50288 == 779_132_928


def test_flash_forward_bound_by_hand():
    # (B 2, 14 q heads over 2 kv heads, S 4096, hd 64, causal): 4 x 64 x
    # 4096 x 4097 / 2 x 28 FLOP at 989 TFLOP/s, against 34 MB at 3.35 TB/s
    fl = flash.fwd_flops(28, 4096, 64, True)
    assert fl == 4 * 64 * 8_390_656 * 28
    by = flash.fwd_bytes(28, 4, 4096, 64)
    assert flash.bound_s(fl, by, PEAK_FLOPS, PEAK_BYTES) * 1e3 == \
        pytest.approx(0.0608, abs=5e-5)
    assert flash.bwd_flops(28, 4096, 64, True) == 2.5 * fl


@pytest.mark.parametrize("BH,BKH,S,hd,causal", [(28, 4, 4096, 64, True),
                                                (28, 4, 4096, 64, False),
                                                (14, 2, 512, 64, True)])
def test_flash_counts_never_exceed_the_plain_algorithm(BH, BKH, S, hd,
                                                       causal):
    """A share over 100 % would need counts above the work the plain
    algorithm does: q k^T and p v over every pair, 4 hd FLOP a pair and
    head, and at least the inputs read and the output written."""
    plain = 4.0 * hd * S * S * BH
    assert flash.fwd_flops(BH, S, hd, causal) <= plain
    assert flash.bwd_flops(BH, S, hd, causal) <= 2.5 * plain
    least = 2.0 * (2 * BH + 2 * BKH) * S * hd
    assert flash.fwd_bytes(BH, BKH, S, hd) >= least


@pytest.mark.parametrize("name,fam,seq", [("qwen2-0.5b", dense, 4096),
                                          ("mamba2-780m", ssm, 4096)])
def test_model_flops_never_exceed_dense_work(name, fam, seq):
    """mfu counts no more than 6 FLOP a parameter and token plus every
    token attending (or carrying state) at full length."""
    m = model(name)
    per_token = fam.train_flops_per_token(m, seq)
    assert 6 * fam.matmul_params(m) <= per_token
    if fam is dense:
        assert per_token <= 6 * fam.matmul_params(m) + \
            3 * fam.attention_flops(m, seq)
    else:
        assert per_token <= 6 * fam.matmul_params(m) + \
            3 * fam.ssd_flops_chunked(m, seq)


def test_serving_flops_by_hand():
    m = model("qwen2-0.5b")
    # a decode token at position 99 attends to 100 positions
    assert dense.forward_flops(m, [99]) == \
        2 * 493_961_216 + 4 * 14 * 64 * 100 * 24
    s = model("mamba2-780m")
    assert ssm.forward_flops(s, [5], decode=True) == \
        2 * 779_132_928 + 48 * 4 * 48 * 64 * 128


@pytest.mark.parametrize("name,fam", [("qwen2-0.5b", dense),
                                      ("mamba2-780m", ssm)])
def test_serve_flops_add_prefills_and_decode_steps(name, fam):
    """Every family counts serving through one call: a prefill of n
    tokens and decode steps over the positions each decoded at."""
    m = model(name)
    assert fam.serve_flops(m, [], []) == 0
    step = fam.serve_flops(m, [], [[5, 99]])
    assert step == fam.serve_flops(m, [], [[5]]) + \
        fam.serve_flops(m, [], [[99]])
    assert fam.serve_flops(m, [300], [[5, 99]]) == \
        fam.serve_flops(m, [300], []) + step
    # a prefill costs each of its tokens at least its matrix products
    assert fam.serve_flops(m, [300], []) >= 300 * 2 * fam.matmul_params(m)


def test_probe_bytes_read_and_write_each_once():
    x = torch.zeros(32, 1, 896, dtype=torch.bfloat16)
    assert probes.tensor_stats_row(x) == 32 * 896 * 2 + 128
    y = torch.zeros(4, 1, 152064)
    assert probes.tensor_stats_row(y) == 4 * 152064 * 4 + 128
    # integers reach the kernel as float32
    assert probes.tensor_stats_row(torch.zeros(8, dtype=torch.int64)) == \
        8 * 4 + 128
    t = torch.zeros(256, dtype=torch.int64)
    k = torch.zeros(49, dtype=torch.int64)
    v = torch.zeros(49, dtype=torch.bool)
    assert probes.hash_fetch_add_batch(t, t, t, k, k, v) == \
        2 * 3 * 256 * 8 + 2 * 49 * 8 + 49
    ring = torch.zeros(64, 4, dtype=torch.int64)
    one = torch.zeros(1, dtype=torch.int64)
    rows = torch.zeros(2, 4, dtype=torch.int64)
    assert probes.ringbuf_emit_batch(ring, one, one, rows,
                                     torch.zeros(2, dtype=torch.bool)) == \
        2 * (64 * 4 * 8 + 16) + 2 * 4 * 8 + 2
