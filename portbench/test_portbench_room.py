"""Room for a configuration with layers of several kinds, MoE probes and
its own spans, with no card: the weights drawn by superblock position
(today's two configurations keep every leaf and every bit), the layer
pattern read as the port reads it, probe expectations by layer kind and
by map, a hybrid MoE configuration added by files and entries alone and
served by the port, and the reduction of a trace with the port's spans
in it, on synthetic profiler events."""
import hashlib
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from portbench import (cell as C, pattern as P, profiling as PR,  # noqa: E402
                       serve_cell, smoke, weights as W)
from portbench.reference.train import flat  # noqa: E402
from portbench.test_portbench_harness import _copy_tree  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

# leaf_specs of the two configurations as the harness drew them before it
# drew by superblock position: (path, shape, kind, scale)
FROZEN_SPECS = {
    "qwen2-0.5b.serve_chat": [
        (("embed", "embedding"), (152064, 896), "normal", 0.02),
        (("stack", "blocks", 0, "norm1", "scale"), (24, 896), "one_plus",
         0.05),
        (("stack", "blocks", 0, "attn", "wq"), (24, 896, 896), "normal",
         0.03340765523905305),
        (("stack", "blocks", 0, "attn", "wk"), (24, 896, 128), "normal",
         0.03340765523905305),
        (("stack", "blocks", 0, "attn", "wv"), (24, 896, 128), "normal",
         0.03340765523905305),
        (("stack", "blocks", 0, "attn", "wo"), (24, 896, 896), "normal",
         0.03340765523905305),
        (("stack", "blocks", 0, "attn", "bq"), (24, 896), "normal", 0.02),
        (("stack", "blocks", 0, "attn", "bk"), (24, 128), "normal", 0.02),
        (("stack", "blocks", 0, "attn", "bv"), (24, 128), "normal", 0.02),
        (("stack", "blocks", 0, "norm2", "scale"), (24, 896), "one_plus",
         0.05),
        (("stack", "blocks", 0, "mlp", "wi"), (24, 896, 4864), "normal",
         0.03340765523905305),
        (("stack", "blocks", 0, "mlp", "wg"), (24, 896, 4864), "normal",
         0.03340765523905305),
        (("stack", "blocks", 0, "mlp", "wo"), (24, 4864, 896), "normal",
         0.014338483366910109),
        (("final_norm", "scale"), (896,), "one_plus", 0.05)],
    "mamba2-780m.serve_chat": [
        (("embed", "embedding"), (50432, 1536), "normal", 0.02),
        (("stack", "blocks", 0, "norm1", "scale"), (48, 1536), "one_plus",
         0.05),
        (("stack", "blocks", 0, "mamba", "in_proj"), (48, 1536, 6448),
         "normal", 0.025515518153991442),
        (("stack", "blocks", 0, "mamba", "conv_w"), (48, 4, 3328), "normal",
         0.1),
        (("stack", "blocks", 0, "mamba", "conv_b"), (48, 3328), "normal",
         0.02),
        (("stack", "blocks", 0, "mamba", "A_log"), (48, 48), "a_log", 0.0),
        (("stack", "blocks", 0, "mamba", "D"), (48, 48), "one_plus", 0.05),
        (("stack", "blocks", 0, "mamba", "dt_bias"), (48, 48), "dt_bias",
         0.0),
        (("stack", "blocks", 0, "mamba", "out_proj"), (48, 3072, 1536),
         "normal", 0.018042195912175808),
        (("stack", "blocks", 0, "mamba", "norm_scale"), (48, 3072),
         "one_plus", 0.05),
        (("final_norm", "scale"), (1536,), "one_plus", 0.05)],
}
# sha256 over every (path, bytes) of make_params(2**31 + 11) at smoke
# width on the CPU, as drawn before
FROZEN_BITS = {
    "qwen2-0.5b.serve_chat":
        "5c77bc9755da1e16c05954162ccc964da031ebaf2de70c60e2742e4507795748",
    "mamba2-780m.serve_chat":
        "ef7150cafe2b985ff6bd5a74718274208327f3d49c05d4cf5e6757f2318b4d90",
}


@pytest.mark.parametrize("name", sorted(FROZEN_SPECS))
def test_leaf_specs_keep_their_order_and_shapes(name):
    got = [(p, tuple(s), k, sc) for p, s, k, sc in
           W.leaf_specs(smoke.any_cell(name).config)]
    assert got == FROZEN_SPECS[name]


@pytest.mark.parametrize("name", sorted(FROZEN_BITS))
def test_weights_keep_their_bits(name):
    params = W.make_params(2**31 + 11, smoke.small_cell(name).config, "cpu")
    h = hashlib.sha256()
    for k, v in flat(params).items():
        h.update(repr(k).encode())
        h.update(v.numpy().tobytes())
    assert h.hexdigest() == FROZEN_BITS[name]


def _port_archs():
    from repro_torch.configs import registry
    return [a for a, c in sorted(registry.ARCHS.items())
            if c.family != "encdec"]


@pytest.mark.parametrize("arch", _port_archs())
def test_the_layer_pattern_is_the_ports(arch):
    """pattern.py's rules, read from a model section, give the port's
    block_kind and ffn_kind at every superblock position of its preset."""
    import dataclasses
    from repro_torch.configs import registry
    cfg = registry.get(arch)
    m = dataclasses.asdict(cfg)
    for j in range(cfg.superblock):
        assert P.block_kind(m, j) == cfg.block_kind(j), j
        assert P.ffn_kind(m, j) == cfg.ffn_kind(j), j
    assert P.stacked(m) == cfg.num_layers // cfg.superblock


def test_site_counts_by_layer_kind():
    m = {"family": "hybrid", "num_layers": 16, "superblock": 8,
         "attn_every": 8, "attn_offset": 4, "num_experts": 4,
         "moe_every": 2, "moe_offset": 1, "d_model": 8}
    config = {"model": m, "probe_sites": {
        "uprobe:block": "num_layers", "probe:attn.out": "attn_layers",
        "probe:ssm.out": "mamba_layers", "probe:moe.load": "moe_layers",
        "probe:logits": 1, "probe:x": "d_model"}}
    got = {s: P.site_layout(config, s) for s in config["probe_sites"]}
    # two superblocks; their rows carry ids 0 and 1
    assert got == {"uprobe:block": (2, 8), "probe:attn.out": (2, 1),
                   "probe:ssm.out": (2, 7), "probe:moe.load": (2, 4),
                   "probe:logits": (1, 1), "probe:x": (8, 1)}
    # one layer a superblock: one event at each layer's id, as before
    dense = {"model": {"family": "dense", "num_layers": 24},
             "probe_sites": {"uprobe:block": "num_layers"}}
    assert P.site_layout(dense, "uprobe:block") == (24, 1)
    with pytest.raises(ValueError):
        P.stacked(dict(m, num_layers=12))


def _array(values):
    return {"values": np.asarray(values, np.int64)}


def test_a_stated_map_is_held_to_its_number():
    config = {"model": {"family": "moe", "num_layers": 2,
                        "num_experts": 4},
              "probe_sites": {"uprobe:block": "num_layers",
                              "probe:moe.drops": "moe_layers"},
              "map_expect": {"total_drops": 0}}
    probes = {"counts": ("array", "uprobe:block"),
              "total_drops": ("array", "probe:moe.drops")}
    maps = {"counts": _array([3, 3, 0, 0]), "total_drops": _array([0] * 4)}
    assert serve_cell.map_errors(maps, probes, 3, config)[
        "counter_errors"] == 0
    # drops at key 0 are one entry off; a per-layer reading of the same
    # map would have wanted 3 a layer
    maps["total_drops"] = _array([5, 0, 0, 0])
    assert serve_cell.map_errors(maps, probes, 3, config)[
        "counter_errors"] == 1
    # a stated map that the run does not produce fails
    del maps["total_drops"], probes["total_drops"]
    assert serve_cell.map_errors(maps, probes, 3, config)[
        "counter_errors"] == 1


# ------------------------------------------ a hybrid MoE configuration

TINY_HYBRID_REFERENCE = '''"""A plain float32 reference of a hybrid stack after
jamba-v0.1 (arXiv:2403.19887): at each superblock position a Mamba-2 mixer
(mamba2.py's) or grouped-query attention with no positions, then a SwiGLU
MLP or a top-k mixture of SwiGLU experts (every expert computed, the k
largest gates renormalised), each with its norm and residual add; an
untied output head."""
import math

import torch
import torch.nn.functional as F

from . import mamba2 as M
from .lowp import FLOAT32
from .qwen2 import rms_norm

CHECK_BATCH = 0


def _attn_at(m, j):
    return bool(m["attn_every"]) and j % m["attn_every"] == m["attn_offset"]


def _moe_at(m, j):
    return bool(m["num_experts"]) and j % m["moe_every"] == m["moe_offset"]


def block_leaves(m, j):
    D, n = m["d_model"], m["num_layers"] // m["superblock"]
    s = 1 / math.sqrt(D)
    if _attn_at(m, j):
        H, KH, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
        out = [(("attn", "wq"), (n, D, H * hd), "normal", s),
               (("attn", "wk"), (n, D, KH * hd), "normal", s),
               (("attn", "wv"), (n, D, KH * hd), "normal", s),
               (("attn", "wo"), (n, H * hd, D), "normal", s)]
    else:
        out = M.block_leaves(m, j)
    out.append((("norm2", "scale"), (n, D), "one_plus", 0.05))
    if _moe_at(m, j):
        E, Fe = m["num_experts"], m["moe_d_ff"]
        return out + [(("moe", "router"), (n, D, E), "normal", s),
                      (("moe", "w_in"), (n, E, D, Fe), "normal", s),
                      (("moe", "w_gate"), (n, E, D, Fe), "normal", s),
                      (("moe", "w_out"), (n, E, Fe, D), "normal",
                       1 / math.sqrt(Fe))]
    Fd = m["d_ff"]
    return out + [(("mlp", "wi"), (n, D, Fd), "normal", s),
                  (("mlp", "wg"), (n, D, Fd), "normal", s),
                  (("mlp", "wo"), (n, Fd, D), "normal", 1 / math.sqrt(Fd))]


def _swiglu(h, wi, wg, wo, mm):
    return mm(F.silu(mm(h, wg)) * mm(h, wi), wo)


def _attention(x, p, i, m, pr):
    B, S, _ = x.shape
    H, KH, hd = m["num_heads"], m["num_kv_heads"], m["head_dim"]
    a, mm = p["attn"], pr.mm
    h = rms_norm(x, p["norm1"]["scale"][i], m["norm_eps"])
    q = mm(h, a["wq"][i]).reshape(B, S, H, hd).transpose(1, 2)
    k, v = (mm(h, a[w][i]).reshape(B, S, KH, hd).transpose(1, 2)
            .repeat_interleave(H // KH, 1) for w in ("wk", "wv"))
    s = mm(q, k.transpose(-1, -2)) / math.sqrt(hd)
    causal = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    o = mm(torch.softmax(s.masked_fill(~causal, float("-inf")), -1), v)
    return pr.act(x + mm(o.transpose(1, 2).reshape(B, S, H * hd),
                         a["wo"][i]))


def _ffn(x, p, i, j, m, pr):
    h = rms_norm(x, p["norm2"]["scale"][i], m["norm_eps"])
    if not _moe_at(m, j):
        f = p["mlp"]
        return pr.act(x + _swiglu(h, f["wi"][i], f["wg"][i], f["wo"][i],
                                  pr.mm))
    e, k = p["moe"], m["experts_per_token"]
    gates = torch.softmax(pr.mm(h, e["router"][i]), -1)
    top, ids = torch.sort(gates, dim=-1, descending=True, stable=True)
    top = top[..., :k] / top[..., :k].sum(-1, keepdim=True)
    w = torch.zeros_like(gates).scatter(-1, ids[..., :k], top)
    f = sum(w[..., n:n + 1] * _swiglu(h, e["w_in"][i, n], e["w_gate"][i, n],
                                      e["w_out"][i, n], pr.mm)
            for n in range(gates.shape[-1]))
    return pr.act(x + f)


def forward(params, tokens, m, pr=FLOAT32):
    x = pr.act(params["embed"]["embedding"][tokens])
    sb = m["superblock"]
    for i in range(m["num_layers"] // sb):
        for j in range(sb):
            p = params["stack"]["blocks"][j]
            x = _attention(x, p, i, m, pr) if _attn_at(m, j) else \\
                M.layer(x, p, i, m, pr, False)
            x = _ffn(x, p, i, j, m, pr)
    x = rms_norm(x, params["final_norm"]["scale"], m["norm_eps"])
    return pr.mm(x, params["embed"]["lm_head"])
'''

# after the port's jamba-v0.1-52b preset; the smoke section cuts it to one
# superblock of 8 positions at smoke width, with a capacity at which no
# assignment drops (each expert takes every token: 2.0 x 2 / 4)
TINY_HYBRID = {
    "source": "arXiv:2403.19887", "reduced": [], "assumed": [],
    "family": "hybrid", "reference": "tiny_hybrid",
    "model": {"name": "tiny-hybrid", "family": "hybrid", "num_layers": 32,
              "d_model": 4096, "num_heads": 32, "num_kv_heads": 8,
              "head_dim": 128, "d_ff": 14336, "vocab_size": 65536,
              "rope_kind": "none", "norm_eps": 1e-05, "num_experts": 16,
              "experts_per_token": 2, "moe_d_ff": 14336, "moe_every": 2,
              "moe_offset": 1, "attn_every": 8, "attn_offset": 4,
              "superblock": 8, "ssm_state": 16, "ssm_expand": 2,
              "ssm_headdim": 64, "ssm_ngroups": 1, "ssm_chunk": 256,
              "capacity_factor": 8.0, "dtype": "bfloat16"},
    "train": {},
    "program_limits": {"prefill_multiple_above": 256},
    "probe_sites": {"uprobe:block": "num_layers",
                    "uretprobe:block": "num_layers", "probe:logits": 1,
                    "probe:ssm.out": "mamba_layers",
                    "probe:moe.load": "moe_layers",
                    "probe:moe.drops": "moe_layers"},
    "map_expect": {"total_drops": 0},
    "smoke": {"model": {"num_layers": 8, "d_model": 64, "num_heads": 4,
                        "num_kv_heads": 2, "head_dim": 16, "d_ff": 128,
                        "vocab_size": 512, "num_experts": 4,
                        "moe_d_ff": 128, "ssm_state": 16,
                        "ssm_headdim": 16, "ssm_chunk": 8,
                        "capacity_factor": 2.0},
              "program_limits": {"prefill_multiple_above": 8}},
    "peak": {"bf16_flops_per_s": 1.0, "hbm_bytes_per_s": 1.0},
}

PROOF = """
import json, time
import torch
from portbench import serve_cell, smoke, weights as W
from portbench.reference.train import flat
from portbench.run import run_cell
from repro_torch.configs.base import ModelConfig
from repro_torch.models import transformer as TF

NAME = "tiny-hybrid.serve_chat"


def cell(**model):
    c = smoke.small_cell(NAME)
    c.config["model"].update(dtype="float32", **model)
    return c


def shapes(tree):
    return {"/".join(map(str, k)): list(v.shape)
            for k, v in flat(tree).items()}


c = cell()
m = c.config["model"]
out = {"ours": shapes(W.make_params(5, c.config, "cpu")),
       "port": shapes(TF.init_params(ModelConfig(**m), device="cpu"))}
engine, _, _ = serve_cell.build(c, 5, torch.device("cpu"))
out["maps"] = sorted(engine.maps)
del engine
out["sound"] = run_cell(c, 2**32 + 21, 1.0, False, torch.device("cpu"),
                        time.perf_counter())
# the least capacity, 8 slots of an expert, under 16 slots' 32 assignments
c = cell(capacity_factor=0.05)
c.traffic["slots"] = 16
out["dropping"] = run_cell(c, 2**32 + 21, 1.0, False, torch.device("cpu"),
                           time.perf_counter())
print(json.dumps(out))
"""


def test_a_hybrid_moe_configuration_needs_no_edit(tmp_path):
    """A configuration with Mamba and attention positions in one
    superblock and MoE every other layer, added to a copy of the tree by
    files and entries alone (its configuration with a smoke section and
    map_expect, a reference module that gives leaves by position, a
    limits file, BENCHMARK.json entries), runs through the harness at
    smoke width on the CPU: its weights take the port's paths and shapes,
    the port's engine serves it with the family's probes, and its check
    passes; with a capacity that drops assignments, total_drops fails
    it."""
    root = _copy_tree(tmp_path)
    pb = root / "portbench"
    before = {p.relative_to(pb): p.read_bytes() for p in pb.rglob("*.py")}
    (pb / "reference" / "tiny_hybrid.py").write_text(TINY_HYBRID_REFERENCE)
    (pb / "configs" / "tiny-hybrid.json").write_text(
        json.dumps(TINY_HYBRID, indent=2))
    (pb / "limits" / "tiny-hybrid.serve_chat.json").write_bytes(
        (pb / "limits" / "qwen2-0.5b.serve_chat.json").read_bytes())
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-hybrid", "source": "x",
                             "file": "portbench/configs/tiny-hybrid.json",
                             "reduced": [], "why": "x"})
    bench["workloads"].append({"name": "tiny-hybrid.serve_chat",
                               "config": "tiny-hybrid",
                               "traffic": "serve_chat", "chips": 1,
                               "why": "x"})
    (root / "BENCHMARK.json").write_text(json.dumps(bench, indent=2))
    out = subprocess.run([sys.executable, "-c", PROOF], cwd=root,
                         capture_output=True, text=True, timeout=600,
                         env={"PYTHONPATH": f"{root}:{ROOT / 'src'}",
                              "PATH": "/usr/bin:/bin", "HOME": str(root),
                              "OMP_NUM_THREADS": "1"})
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["ours"] == got["port"]
    assert any(k.startswith("stack/blocks/7/") for k in got["ours"])
    assert {"total_drops", "load_hist", "ssm_rms_hist",
            "sv_layer_counts"} <= set(got["maps"])
    sound = got["sound"]["checks"]
    assert got["sound"]["correct"], sound
    for k in ("counter_errors", "hist_count_error", "ring_head_error",
              "events_per_step_error"):
        assert sound[k]["value"] == 0, k
    dropping = got["dropping"]["checks"]
    assert not got["dropping"]["correct"]
    assert dropping["counter_errors"]["value"] > 0
    assert dropping["events_per_step_error"]["value"] == 0
    # nothing of the harness was edited in the copy
    assert before == {p.relative_to(pb): p.read_bytes()
                      for p in pb.rglob("*.py")
                      if p.name != "tiny_hybrid.py"}


# --------------------------------------------- a trace with the port's spans

class _Ev:
    """A profiler event as profiling.Trace reads one."""

    def __init__(self, name, a, b, device=False, corr=0, thread=1):
        self._n, self._a, self._b = name, a, b
        self._dev, self._corr, self._thread = device, corr, thread

    def name(self):
        return self._n

    def device_type(self):
        return "DeviceType.CUDA" if self._dev else "DeviceType.CPU"

    def start_ns(self):
        return self._a

    def end_ns(self):
        return self._b

    def correlation_id(self):
        return self._corr

    def start_thread_id(self):
        return self._thread


def _synthetic_trace():
    span = PR.SPAN_PREFIX
    return PR.Trace([
        _Ev("portbench.window", 0, 1000),
        _Ev("portbench.decode", 100, 600),
        _Ev(span + "decode.step", 110, 590),
        _Ev(span + "decode.model", 120, 400),
        _Ev(span + "probe.emit", 200, 250),
        _Ev(span + "probe.emit", 450, 480),
        _Ev(span + "probe.stage", 500, 580),
        # a span of another thread holds none of these
        _Ev(span + "decode.model", 440, 490, thread=2),
        _Ev("cudaLaunchKernel", 130, 140, corr=1),
        _Ev("cudaLaunchKernel", 460, 470, corr=2),
        _Ev("gemm_kernel", 300, 500, device=True, corr=1),
        _Ev("stats_kernel", 520, 560, device=True, corr=2),
        # the profiler's mirrors of host intervals on the device timeline
        _Ev(span + "decode.step", 300, 900, device=True),
        _Ev("portbench.decode", 290, 950, device=True),
    ])


def test_device_annotations_are_no_work():
    t = _synthetic_trace()
    assert [op[0] for op in t.ops] == ["gemm_kernel", "stats_kernel"]
    assert t.busy_s() == pytest.approx(240e-9)
    assert t.window_s == pytest.approx(1000e-9)


def test_spans_and_ranges_are_kept_apart():
    t = _synthetic_trace()
    assert set(t.ranges) == {"window", "decode"}
    assert set(t.spans) == {"decode.step", "decode.model", "probe.emit",
                            "probe.stage"}
    # the innermost range ignores the spans open inside it
    assert t.host_label(210) == "decode"
    assert t.host_label(50) == "outside every range"
    assert t.span_label(210) == "probe.emit"
    assert t.span_label(505) == "probe.stage"
    # host time, calls and launches read ranges and spans alike
    assert t.host_s("decode") == pytest.approx(500e-9)
    assert t.host_s("decode.step") == pytest.approx(480e-9)
    assert t.calls("probe.emit") == 2
    # a launch is placed by the host's clock: the one at 460 started
    # inside thread 2's decode.model
    assert t.launched_in(("decode.model",)) == pytest.approx(240e-9)
    assert t.launched_in(("probe.emit",)) == pytest.approx(40e-9)
    assert t.launched_in(("decode",)) == pytest.approx(240e-9)


def test_a_spans_parents_are_known():
    t = _synthetic_trace()
    assert t.nested("probe.emit", "decode.model") == [(200, 250)]
    assert t.nested("probe.emit", "decode.step") == [(200, 250),
                                                     (450, 480)]
    assert t.nested("probe.stage", "decode.model") == []
    run = C.Run(mode="serve", config={}, traffic={}, trace=t)
    # decode.model's 280 + 50 ns (both threads), less the one emit inside
    # it (50), for one decode.step
    assert C.metric_reader("decode_model_host_ms.serve")(run) == \
        pytest.approx(280e-6)
    assert C.metric_reader("emit_host_us.serve")(run) == \
        pytest.approx(40e-3)


def test_idle_gaps_by_range_and_by_span():
    b = _synthetic_trace().breakdown()
    assert set(b) == {"device_ops", "idle_gaps", "idle_gaps_by_span"}
    assert dict(b["idle_gaps"]) == pytest.approx(
        {"outside every range": 300e-9, "decode": 460e-9})
    assert dict(b["idle_gaps_by_span"]) == pytest.approx(
        {"outside every span": 300e-9, "probe.stage": 460e-9})
