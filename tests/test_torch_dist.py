"""The port's distribution layer and launch tooling against the JAX
package on the CPU: the sharding rules (`dist/sharding.py`) for every
leaf of every arch's train state on three meshes, the twins of
`tests/test_dist.py`, the input stand-ins and their shardings
(`launch/specs.py`), `model_flops`, the op counter (`launch/op_cost.py`),
one dry-run cell end to end, and the DTensor paths at gloo world size 2:
elastic restore onto (2, 1) and (1, 2), a save of DTensor leaves, and
`constrain`.

Every comparison here is exact: specs, shapes, dtypes, flop counts and
checkpoint bytes are integers or bit patterns.
"""
import dataclasses
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

import torch_dist_workers as W  # noqa: E402
from repro.configs import SHAPES as JSHAPES, registry as JCFG  # noqa: E402
from repro.dist import sharding as JSH  # noqa: E402
from repro.launch import analysis as JAN, presets as JPRE, specs as JSP  # noqa: E402,E501
from repro.train.train_step import abstract_train_state as j_state  # noqa: E402,E501

from repro_torch.ckpt import checkpoint as CK  # noqa: E402
from repro_torch.configs import SHAPES, registry as TCFG  # noqa: E402
from repro_torch.dist import sharding as SH  # noqa: E402
from repro_torch.dist.sharding import PartitionSpec as P  # noqa: E402
from repro_torch.launch import analysis as AN, op_cost, presets, specs as SP  # noqa: E402,E501
from repro_torch.optim import tree_leaves  # noqa: E402
from repro_torch.train.train_step import abstract_train_state as t_state  # noqa: E402,E501

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "int32": torch.int32, "int64": torch.int64}


class FakeMesh:
    def __init__(self, shape, axes):
        self.axis_names = axes
        self.shape = dict(zip(axes, shape))


MESHES = {"1x1": FakeMesh((1, 1), ("data", "model")),
          "16x16": FakeMesh((16, 16), ("data", "model")),
          "2x16x16": FakeMesh((2, 16, 16), ("pod", "data", "model"))}


def _jax_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return [([str(getattr(p, "key", getattr(p, "idx", ""))) for p in path],
             leaf) for path, leaf in flat]


def _same_leaf(t, j, what):
    assert tuple(t.shape) == tuple(j.shape), what
    assert t.dtype == DTYPES[str(j.dtype)], what


# ------------------------------------------------------------ sharding rules

@pytest.mark.parametrize("arch", sorted(TCFG.ARCHS))
def test_spec_for_matches_jax_on_every_state_leaf(arch):
    """Every leaf of the arch's train state, with the Adafactor and the
    AdamW state, on (1, 1), (16, 16) and (2, 16, 16)."""
    for opt in ("adafactor", "adamw"):
        jt = dataclasses.replace(JPRE.train_config(arch), optimizer=opt)
        tt = dataclasses.replace(presets.train_config(arch), optimizer=opt)
        jl = _jax_paths(j_state(JCFG.get(arch), jt))
        tl = SP.leaf_paths(t_state(TCFG.get(arch), tt))
        assert [k for k, _ in jl] == [list(k) for k, _ in tl]
        for (keys, j), (_, t) in zip(jl, tl):
            _same_leaf(t, j, "/".join(keys))
            for name, mesh in MESHES.items():
                assert tuple(SH.spec_for(keys, t.shape, mesh)) == \
                    tuple(JSH.spec_for(keys, j.shape, mesh)), \
                    (opt, name, "/".join(keys))


@pytest.fixture(scope="module")
def host_mesh():
    from repro_torch.launch.mesh import make_host_mesh
    return make_host_mesh((1, 1), device="cpu")


def test_spec_rules_single_device_mesh(host_mesh):
    mesh = host_mesh
    assert mesh.axis_names == ("data", "model")
    assert mesh.shape == {"data": 1, "model": 1}
    # dims divisible by 1 -> axes kept
    assert SH.spec_for(["embed", "embedding"], (1024, 64), mesh) == \
        P("model", "data")
    assert SH.spec_for(["a", "wq"], (64, 128), mesh) == P("data", "model")
    assert SH.spec_for(["n", "scale"], (64,), mesh) == P(None)
    # stacked leading dim padded with None
    assert SH.spec_for(["stack", "wq"], (4, 64, 128), mesh) == \
        P(None, "data", "model")


def test_divisibility_fallback():
    m = MESHES["16x16"]
    # 14 heads * 64 = 896 divides; but a 14-dim would not
    assert SH.spec_for(["x", "wq"], (896, 896), m) == P("data", "model")
    assert SH.spec_for(["x", "wq"], (896, 14), m) == P("data", None)


def test_adafactor_moment_rules():
    m = MESHES["16x16"]
    # w_in [E, D, F] -> (model, fsdp, None); vr drops last -> (model, fsdp)
    assert SH.spec_for(["f", "w_in", "vr"], (384, 7168), m) == \
        P("model", "data")
    # vc drops second-to-last -> (model, None)
    assert SH.spec_for(["f", "w_in", "vc"], (384, 2048), m) == \
        P("model", None)


def test_fit_spec_drops_nondividing():
    m = MESHES["16x16"]
    assert SH.fit_spec(P(None, "data"), (1, 1), m) == P(None, None)
    assert SH.fit_spec(P("data", None), (32, 7), m) == P("data", None)
    mp = MESHES["2x16x16"]
    assert SH.fit_spec(P(("pod", "data"), None), (64, 3), mp) == \
        P(("pod", "data"), None)
    assert SH.fit_spec(P(("pod", "data"), None), (48, 3), mp) == \
        P(None, None)


def test_constrain_noop_without_mesh(host_mesh):
    x = torch.ones((4, 4))
    assert SH.constrain(x, "batch", None) is x
    with SH.use_mesh(host_mesh):          # not a DTensor: unchanged
        assert SH.constrain(x, "batch", None) is x
        assert SH.active_mesh() is host_mesh
    assert SH.active_mesh() is None


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard
    mp = MESHES["2x16x16"]
    assert SH.placements(P(("pod", "data"), "model"), mp) == \
        (Shard(0), Shard(0), Shard(1))
    assert SH.placements(P(None, "data"), mp) == \
        (Replicate(), Shard(1), Replicate())
    assert SH.replicated(mp) == (Replicate(),) * 3


# -------------------------------------------------------- specs, model flops

@pytest.fixture
def plain_jax_shardings(monkeypatch):
    """JAX's specs functions with NamedSharding(mesh, spec) -> spec, so
    they run on a FakeMesh of any shape (the package is not edited)."""
    monkeypatch.setattr(JSP, "NamedSharding", lambda mesh, spec: spec)


@pytest.mark.parametrize("shape_name", sorted(SHAPES))
@pytest.mark.parametrize("arch", sorted(TCFG.ARCHS))
def test_specs_stand_ins_and_shardings_match_jax(arch, shape_name,
                                                 plain_jax_shardings):
    jc, tc = JCFG.get(arch), TCFG.get(arch)
    js, ts = JSHAPES[shape_name], SHAPES[shape_name]
    jt, tt = JPRE.train_config(arch), presets.train_config(arch)
    j0 = JPRE.train_config(arch, microbatch=0)
    t0 = presets.train_config(arch, microbatch=0)
    cases = [(JSP.train_batch_specs(jc, js, jt),
              SP.train_batch_specs(tc, ts, tt), jt, tt),
             (JSP.prefill_batch_specs(jc, js),
              SP.prefill_batch_specs(tc, ts), j0, t0)]
    for jb, tb, jtc, ttc in cases:
        assert sorted(jb) == sorted(tb)
        for k in jb:
            _same_leaf(tb[k], jb[k], k)
        for name, mesh in MESHES.items():
            jsh = JSP.batch_shardings(jb, mesh, jc, js, jtc)
            tsh = SP.batch_shardings(tb, mesh, tc, ts, ttc)
            assert {k: tuple(v) for k, v in tsh.items()} == \
                {k: tuple(v) for k, v in jsh.items()}, name
    jd = JSP.decode_specs(jc, js, jt.param_dtype)
    td = SP.decode_specs(tc, ts, tt.param_dtype)
    _same_leaf(td["tokens"], jd["tokens"], "tokens")
    _same_leaf(td["step"], jd["step"], "step")
    jl, tl = _jax_paths(jd["cache"]), SP.leaf_paths(td["cache"])
    assert [k for k, _ in jl] == [list(k) for k, _ in tl]
    for (keys, j), (_, t) in zip(jl, tl):
        _same_leaf(t, j, "/".join(keys))
    for name, mesh in MESHES.items():
        jsh = [s for _, s in _jax_paths(
            JSP.cache_shardings(jd["cache"], mesh, jc, js))]
        tsh = [s for _, s in SP.leaf_paths(
            SP.cache_shardings(td["cache"], mesh, tc, ts))]
        assert [tuple(s) for s in tsh] == [tuple(s) for s in jsh], name


@pytest.mark.parametrize("arch", sorted(TCFG.ARCHS))
def test_abstract_params_match_jax(arch):
    for pdt in ("float32", "bfloat16"):
        jl = _jax_paths(JSP.abstract_params(JCFG.get(arch), pdt))
        tl = SP.leaf_paths(SP.abstract_params(TCFG.get(arch), pdt))
        assert [k for k, _ in jl] == [list(k) for k, _ in tl]
        for (keys, j), (_, t) in zip(jl, tl):
            _same_leaf(t, j, "/".join(keys))
            assert t.device.type == "meta"


def test_model_flops_match_jax_exactly():
    for arch in TCFG.ARCHS:
        for name in SHAPES:
            assert AN.model_flops(TCFG.get(arch), SHAPES[name]) == \
                JAN.model_flops(JCFG.get(arch), JSHAPES[name]), (arch, name)


# ------------------------------------------------------------------- op_cost

def test_op_cost_chained_products():
    """hlo_cost's scan test: five chained 64x64 products, exactly."""
    def f(x):
        for _ in range(5):
            x = x @ x
        return x
    c = op_cost.analyze(f, torch.ones((64, 64)))
    assert c.flops == 5 * 2 * 64 ** 3
    assert c.op_counts == {"aten::mm": 5}
    assert c.bytes == 5 * 3 * 64 * 64 * 4


def test_op_cost_plain_matmul():
    c = op_cost.analyze(lambda a, b: a @ b, torch.ones((32, 128)),
                        torch.ones((128, 16)))
    assert c.flops == 2 * 32 * 128 * 16
    assert c.bytes == (32 * 128 + 128 * 16 + 32 * 16) * 4


def test_op_cost_flash_operators_and_interior():
    from repro_torch.kernels import ops
    q = torch.randn(2, 64, 4, 16, requires_grad=True)
    kv = torch.randn(2, 64, 2, 16, requires_grad=True)

    def f(q, kv):
        ops.flash_attention(q, kv, kv, causal=True).sum().backward()
    c = op_cost.analyze(f, q, kv)
    assert c.op_counts["repro_torch::flash_fwd"] == 1
    assert c.op_counts["repro_torch::flash_bwd"] == 1
    pairs = 8 * 64 * 65 // 2
    assert c.flops == (4 + 10) * 16 * pairs
    assert c.bytes_flash_interior == ((8 + 2 * 4) + (8 + 5 * 4)) * pairs
    assert c.bytes_fused == c.bytes - c.bytes_flash_interior
    assert q.grad is None           # ran on fake copies


_COLLECTIVES_CHILD = """
import sys
sys.modules["jax"] = None
import torch, torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.launch import op_cost
dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=4)
def f(x):
    dist.all_reduce(x)
    return torch.ops._c10d_functional.all_reduce(x * 2, "sum", "0")
c = op_cost.analyze(f, torch.ones(1024))
assert c.collective_counts == {"all-reduce": 2}, c.collective_counts
assert c.collective_bytes == {"all-reduce": 2 * 4096.0}
assert c.coll_wire == 2 * 2 * 4096.0
dist.destroy_process_group()
print("OK")
"""


def test_op_cost_collectives_on_a_fake_group():
    """An all_reduce on a 4-rank fake group is counted (a subprocess, so
    this process keeps no group)."""
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    r = subprocess.run([sys.executable, "-c", _COLLECTIVES_CHILD],
                       capture_output=True, text=True, env=env, timeout=300)
    assert "OK" in r.stdout, r.stderr[-2000:]


def test_no_f64_in_counted_train_step():
    """x64-free compute: no float64 result anywhere in the smoke
    llama3.2-1b train step (the twin of test_no_f64_in_lowered_train_step)."""
    from repro_torch.configs.base import ShapeConfig, TrainConfig
    from repro_torch.train.train_step import make_train_step
    cfg = TCFG.smoke("llama3.2-1b")
    tcfg = TrainConfig()
    state = t_state(cfg, tcfg, device="cpu")
    batch = SP.train_batch_specs(cfg, ShapeConfig("t", 16, 4, "train"),
                                 tcfg, device="cpu")
    c = op_cost.analyze(make_train_step(cfg, tcfg), state, batch)
    assert c.flops > 0 and torch.float32 in c.dtypes
    assert torch.float64 not in c.dtypes, c.dtypes


# ------------------------------------------------------------------- dry run

def _dryrun(out, *extra):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"),
               CUDA_VISIBLE_DEVICES="")
    return subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
         "qwen2-0.5b", "--out", str(out), *extra], capture_output=True,
        text=True, env=env, timeout=600, cwd=ROOT)


def test_dryrun_cell_end_to_end(tmp_path, capsys):
    r = _dryrun(tmp_path, "--shape", "decode_32k", "--probes",
                "--probe-mode", "fused")
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    with open(tmp_path / "qwen2-0.5b__decode_32k__sp__probes.json") as f:
        d = json.load(f)
    assert "error" not in d, d.get("traceback")
    assert d["mesh"] == [16, 16] and d["roofline"]["chips"] == 256
    assert d["memory_analysis"] == {"error": "eager PyTorch has no "
                                             "compiled artifact"}
    assert d["roofline"]["card"] == "NVIDIA H100 80GB HBM3, 700.00 W"
    for k in ("analytic_state_bytes_global", "collectives", "roofline",
              "roofline_unfused_attention", "total_s", "trace_s"):
        assert k in d, k
    rf = d["roofline"]
    assert rf["dominant"] == "memory" and rf["memory_s"] > 0
    assert rf["model_flops_total"] == JAN.model_flops(
        JCFG.get("qwen2-0.5b"), JSHAPES["decode_32k"])
    sys.path.insert(0, ROOT)
    try:
        from benchmarks import roofline_report_torch as RR
        rows = RR.main(str(tmp_path))
    finally:
        sys.path.remove(ROOT)
    assert [row["status"] for row in rows] == ["ok"]
    assert "| qwen2-0.5b | decode_32k | 16x16 |" in capsys.readouterr().out


def test_dryrun_refuses_the_scan_lane(tmp_path):
    r = _dryrun(tmp_path, "--shape", "decode_32k", "--probes",
                "--probe-mode", "scan")
    assert r.returncode != 0
    with open(tmp_path / "qwen2-0.5b__decode_32k__sp__probes.json") as f:
        d = json.load(f)
    assert "scan lanes read the event tape on the host" in d["error"]


def test_production_mesh_needs_the_dry_run():
    from repro_torch.launch.mesh import make_production_mesh
    with pytest.raises(RuntimeError, match="dryrun"):
        make_production_mesh(multi_pod=True)


# ---------------------------------------------------- DTensors at 2 ranks

@pytest.fixture(scope="module")
def dtensors(tmp_path_factory):
    d = tmp_path_factory.mktemp("dtensors")
    CK.save(str(d / "ckpt"), 1, W._state())
    return W.launch("dtensors", 2, d), d


@pytest.mark.parametrize("shape", [(2, 1), (1, 2)])
def test_elastic_restore_onto_two_ranks(dtensors, shape):
    res, _ = dtensors
    want = tree_leaves(W._state())
    sharded = 0
    for out in res:
        got = out[shape]
        for i, w in enumerate(want):
            assert _bits(got["full"][i], w), f"leaf {i} full_tensor"
            local = w
            for axis, dim in enumerate(got["placements"][i]):
                if dim is not None and shape[axis] > 1:
                    local = torch.chunk(local, shape[axis], dim=dim)[
                        got["coord"][axis]]
                    sharded += 1
            assert _bits(got["local"][i], local), f"leaf {i} local shard"
    assert sharded > 0, "some leaf should be sharded on this mesh"


def test_elastic_restore_specs_follow_spec_for(dtensors):
    res, _ = dtensors
    specs = res[0][(1, 2)]["specs"]
    names = [n for n, _ in CK._flatten(W._state())]
    got = dict(zip(names, specs))
    assert got["params/embed/embedding"] == ("model", "data")
    assert got["params/moe/w_in"] == ("model", "data", None)
    assert got["step"] == ()


def test_save_of_dtensor_leaves_restores_bit_for_bit(dtensors):
    res, d = dtensors
    want = tree_leaves(W._state(seed=1))
    for out in res:                  # every rank read rank 0's files
        for a, b in zip(out["saved"]["back"], want):
            assert _bits(a, b)
    back = CK.restore(str(d / "ckpt_dt"), 2, W._state(), device="cpu")
    for a, b in zip(tree_leaves(back), want):
        assert _bits(a, b)
    assert sorted(os.listdir(d / "ckpt_dt")) == ["step_2"]


def test_constrain_redistributes_a_dtensor_at_two_ranks(dtensors):
    res, _ = dtensors
    full = torch.arange(24.).reshape(4, 6)
    for r, out in enumerate(res):
        c = out["constrain"]
        assert c["y_placements"] == [None, 1]
        assert _bits(c["y_local"], full[:, 3 * r:3 * r + 3])
        assert _bits(c["y_full"], full)
        # 'batch' resolves to the fsdp axis 'data' (size 1): the dim stays
        assert c["z_placements"] == [0, None]


def _bits(a, b) -> bool:
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype == torch.bfloat16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return torch.equal(a, b)
