"""The port's durable training against the JAX package's, on the CPU: the
int8 gradient round trip bit for bit, a train step with int8 compression,
the checkpoint layout (tree.json and every .npy file byte for byte),
restores across the two packages, and the port's counterparts of the
checkpoint tests of test_train.py, the checkpoint and training-loop drills
of test_syscall_drills.py and the supervisor restart of test_ft.py."""
import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.ckpt import checkpoint as JCK  # noqa: E402
from repro.configs import registry as JCFG  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.core import maps as JM  # noqa: E402
from repro.core.runtime import BpftimeRuntime as JRuntime  # noqa: E402
from repro.dist import compression as JC  # noqa: E402
from repro.models import registry as JMR  # noqa: E402
from repro.train.train_step import (init_train_state as j_init,  # noqa: E402
                                    make_train_step as j_make)

from repro_torch.ckpt import checkpoint as CK  # noqa: E402
from repro_torch.configs import base as TB, registry as TCFG  # noqa: E402
from repro_torch.configs.base import ShapeConfig  # noqa: E402
from repro_torch.core import faults as F, maps as TM  # noqa: E402
from repro_torch.core.runtime import BpftimeRuntime as TRuntime, to_numpy  # noqa: E402,E501
from repro_torch.data.pipeline import SyntheticDataset as TData  # noqa: E402
from repro_torch.dist import compression as TC  # noqa: E402
from repro_torch.ft import fault_tolerance as FT  # noqa: E402
from repro_torch.launch import train as TL  # noqa: E402
from repro_torch.optim import global_norm, tree_leaves  # noqa: E402
from repro_torch.train import train_step as TS  # noqa: E402
from repro_torch.train.train_step import (init_train_state as t_init,  # noqa: E402,E501
                                          make_train_step as t_make)

from test_torch_train import (ARCH, COUNT_BLOCKS, CPU, JCFG_, SHAPE,  # noqa: E402,E501
                              STEP_TOL, TCFG_, VETO_ALWAYS, _assert_trees_close,
                              _np)


def _t(tree):
    """A numpy tree as tensors (bf16 arrays, ml_dtypes in numpy, by their
    bits)."""
    if isinstance(tree, dict):
        return {k: _t(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_t(v) for v in tree]
    a = np.array(tree, copy=True)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _bits(x) -> np.ndarray:
    """The bytes of a leaf (tensor or array), for bit-for-bit compares."""
    if isinstance(x, torch.Tensor):
        if x.dtype == torch.bfloat16:
            x = x.view(torch.int16)
        x = x.detach().cpu().numpy()
    return np.ascontiguousarray(np.asarray(x)).reshape(-1).view(np.uint8)


# ----------------------------------------------------------- int8 round trip

def _grad_case(name, rng):
    """(numpy array, bf16?) of one gradient leaf."""
    if name == "f32":
        return (rng.standard_normal(20_000) * 1e-3).astype(np.float32), False
    if name == "ties":
        # absmax 127 -> scale 1.0: x.5 sits exactly half a quantum from two
        # grid points, so round-half-to-even decides
        return np.array([127.0, 0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 126.5,
                         -125.5, 3.4999998], np.float32), False
    if name == "bf16":
        return (rng.standard_normal(4_000) * 3).astype(np.float32), True
    if name == "bf16_ties":
        return np.array([-127.0, 0.5, 1.5, 2.5, -3.5, 4.5, 100.5],
                        np.float32), True
    if name == "zeros":
        return np.zeros(33, np.float32), False
    assert name == "int"
    return np.arange(-8, 9, dtype=np.int32), False


@pytest.mark.parametrize("case", ["f32", "ties", "bf16", "bf16_ties",
                                  "zeros", "int"])
def test_int8_roundtrip_bit_equal_to_jax(case):
    arr, bf16 = _grad_case(case, np.random.default_rng(7))
    j = jnp.asarray(arr)
    t = torch.from_numpy(arr.copy())
    if bf16:
        j, t = j.astype(jnp.bfloat16), t.to(torch.bfloat16)
    jtree, ttree = {"g": j, "n": [j]}, {"g": t, "n": [t]}
    jr, tr = JC.int8_roundtrip(jtree), TC.int8_roundtrip(ttree)
    for jl, tl in zip(jax.tree.leaves(jr), tree_leaves(tr)):
        assert tl.dtype == t.dtype
        np.testing.assert_array_equal(_bits(tl), _bits(np.asarray(jl)))
    if case == "int":
        assert tr["g"] is t                       # passes through
    np.testing.assert_allclose(float(TC.compression_error(ttree)),
                               float(JC.compression_error(jtree)),
                               rtol=0, atol=1e-6)


def test_int8_train_step_matches_jax(monkeypatch):
    """One smoke-width step with grad_compression="int8": the step calls
    the round trip once, on the clipped gradients (the gradient-norm probe
    sees the norm from before compression), the update takes its output,
    and it matches JAX's."""
    jp = JMR.init_params(jax.random.PRNGKey(0), JCFG_)
    jrt, trt = JRuntime(), TRuntime()
    for rt, Mod in ((jrt, JM), (trt, TM)):
        rt.attach(rt.load_asm("blk", COUNT_BLOCKS, [Mod.MapSpec(
            "blk_counts", Mod.MapKind.ARRAY, max_entries=64)], "uprobe"),
            "uprobe:block")
    jt = JTrainConfig(warmup=1, total_steps=10, grad_compression="int8")
    tt = TB.TrainConfig(warmup=1, total_steps=10, grad_compression="int8")
    js = j_init(jax.random.PRNGKey(0), JCFG_, jt, jrt)
    js["params"] = jp
    ts = t_init(TCFG_, tt, trt, device=CPU,
                params=_t(jax.tree.map(np.asarray, jp)))
    jstep, tstep = jax.jit(j_make(JCFG_, jt, jrt)), t_make(TCFG_, tt, trt)
    calls = []

    def recording(tree):
        out = TC.int8_roundtrip(tree)
        calls.append((tree, out))
        return out
    monkeypatch.setattr(TS, "int8_roundtrip", recording)
    data = TData(TCFG_, SHAPE, tt, seed=3)
    for _ in range(2):
        b = data.next()
        js, jm = jstep(js, b)
        ts, tm = tstep(ts, b)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]),
                                   rtol=STEP_TOL)
        np.testing.assert_allclose(float(tm["grad_norm"]),
                                   float(jm["grad_norm"]), rtol=STEP_TOL)
        # one call, on the clipped gradients; its output is compressed
        assert len(calls) == 1
        g, out = calls.pop()
        np.testing.assert_allclose(
            float(global_norm(g)),
            min(float(tm["grad_norm"]), tt.clip_norm), rtol=1e-5)
        assert any(not torch.equal(a, b) for a, b in zip(
            tree_leaves(g), tree_leaves(out)))
    _assert_trees_close(ts["params"], js["params"], STEP_TOL, "params")
    _assert_trees_close(ts["opt"], js["opt"], STEP_TOL, "opt")
    np.testing.assert_array_equal(to_numpy(ts["maps"])["blk_counts"]
                                  ["values"], np.asarray(js["maps"]
                                                         ["blk_counts"]
                                                         ["values"]))


# ------------------------------------------------------------ the layout

def _np_state(param_dtype):
    """A JAX train state with probe maps, as numpy."""
    rt = JRuntime()
    rt.attach(rt.load_asm("blk", COUNT_BLOCKS, [JM.MapSpec(
        "blk_counts", JM.MapKind.ARRAY, max_entries=8)], "uprobe"),
        "uprobe:block")
    rt.create_map(JM.MapSpec("rb", JM.MapKind.RINGBUF, 4, rec_width=3))
    st = j_init(jax.random.PRNGKey(1), JCFG_,
                JTrainConfig(param_dtype=param_dtype), rt)
    st = jax.tree.map(np.asarray, st)
    st["step"] = np.asarray(5, np.int32)
    return st


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_save_layout_matches_jax(tmp_path, param_dtype):
    st = _np_state(param_dtype)
    jd, td = str(tmp_path / "j"), str(tmp_path / "t")
    JCK.save(jd, 5, st)
    CK.save(td, 5, _t(st))
    assert CK.latest(td) == JCK.latest(jd) == 5
    with open(os.path.join(jd, "step_5", "tree.json")) as f:
        jmeta = json.load(f)
    with open(os.path.join(td, "step_5", "tree.json")) as f:
        tmeta = json.load(f)
    assert tmeta == jmeta
    assert "maps/blk_counts/values" in tmeta["names"]
    assert sorted(os.listdir(os.path.join(td, "step_5"))) == \
        sorted(os.listdir(os.path.join(jd, "step_5")))
    for i in range(jmeta["n"]):
        with open(os.path.join(jd, "step_5", f"{i}.npy"), "rb") as f:
            jb = f.read()
        with open(os.path.join(td, "step_5", f"{i}.npy"), "rb") as f:
            tb = f.read()
        assert tb == jb, f"leaf {i} ({jmeta['names'][i]}) differs"
    i = jmeta["names"].index("params/final_norm/scale")
    with open(os.path.join(td, "step_5", f"{i}.npy"), "rb") as f:
        head = f.read(128)
    want = "'<V2'" if param_dtype == "bfloat16" else "'<f4'"
    assert f"'descr': {want}".encode() in head


def test_jax_restores_a_torch_checkpoint(tmp_path):
    st = _np_state("float32")
    CK.save(str(tmp_path), 5, _t(st))
    out = JCK.restore(str(tmp_path), 5, st)
    for a, b in zip(jax.tree.leaves(out), jax.tree.leaves(st)):
        np.testing.assert_array_equal(_bits(np.asarray(a)), _bits(b))


@pytest.mark.parametrize("param_dtype", ["float32", "bfloat16"])
def test_torch_restores_a_jax_checkpoint(tmp_path, param_dtype):
    st = _np_state(param_dtype)
    JCK.save(str(tmp_path), 5, st)
    like = _t(st)
    out = CK.restore(str(tmp_path), 5, like, device=CPU)
    got, want = tree_leaves(out), jax.tree.leaves(st)
    assert len(got) == len(want)
    for a, b, ref in zip(got, want, tree_leaves(like)):
        assert a.dtype == ref.dtype and a.shape == ref.shape
        np.testing.assert_array_equal(_bits(a), _bits(b))
    if param_dtype == "bfloat16":
        # a deliberate difference: the JAX package cannot restore the bf16
        # leaves it saved (np.load gives raw '|V2' bytes, which jnp rejects)
        with pytest.raises(TypeError, match="V2"):
            JCK.restore(str(tmp_path), 5, st)


def test_live_table_saved_as_its_fields_and_rebuilt(tmp_path):
    """A runtime's live table is saved as JAX holds it (its fields, no
    packed buffer) and restored as a packed buffer its fields view."""
    rt = TRuntime()
    rt.create_map(TM.MapSpec("c", TM.MapKind.ARRAY, 4))
    rt.enable_live_attach(max_programs=2, max_insns=16)
    pid = rt.load_asm("p", COUNT_BLOCKS.replace("blk_counts", "c"),
                      [TM.MapSpec("c", TM.MapKind.ARRAY, 4)])
    rt.attach(pid, "uprobe:block", mode="table")
    st = {"maps": rt.init_device_maps(CPU), "step": torch.tensor(3)}
    st["maps"] = rt.sync_live_table(st["maps"])
    CK.save(str(tmp_path), 3, st)
    with open(tmp_path / "step_3" / "tree.json") as f:
        names = json.load(f)["names"]
    assert "maps/__live_table__/packed" not in names
    assert "maps/__live_table__/gen" in names
    like = {"maps": rt.init_device_maps(CPU), "step": torch.tensor(0)}
    out = CK.restore(str(tmp_path), 3, like, device=CPU)
    tbl = out["maps"]["__live_table__"]
    assert torch.equal(tbl["packed"], st["maps"]["__live_table__"]["packed"])
    tbl["gen"][0] = 99                  # the fields view the packed buffer
    assert int(tbl["packed"][-1]) == 99


def test_restore_refuses_a_mesh_and_asks_for_cuda(tmp_path):
    """A mesh with shardings restores (elastic restore; it was refused
    before dist/sharding.py existed); a mesh without shardings, or
    shardings without a mesh, is refused; the default device asks for
    CUDA."""
    from torch.distributed.tensor import DTensor
    from repro_torch.dist.sharding import PartitionSpec as P, use_mesh
    from repro_torch.launch.mesh import make_host_mesh
    w = torch.arange(6.).reshape(2, 3)
    CK.save(str(tmp_path), 1, {"w": w})
    mesh = make_host_mesh((1, 1), device=CPU)
    got = CK.restore(str(tmp_path), 1, {"w": torch.zeros(2, 3)}, mesh=mesh,
                     shardings={"w": P("data", "model")})
    assert isinstance(got["w"], DTensor)
    assert torch.equal(got["w"].full_tensor(), w)
    with use_mesh(mesh):                 # the active mesh stands in
        got = CK.restore(str(tmp_path), 1, {"w": w}, shardings={"w": P()})
    assert torch.equal(got["w"].to_local(), w)
    with pytest.raises(ValueError, match="needs shardings"):
        CK.restore(str(tmp_path), 1, {"w": w}, mesh=mesh)
    with pytest.raises(ValueError, match="needs a mesh"):
        CK.restore(str(tmp_path), 1, {"w": w}, shardings={"w": P()})
    if not torch.cuda.is_available():
        CK.save(str(tmp_path), 1, {"w": torch.ones(2)})
        with pytest.raises(RuntimeError, match="device='cpu'"):
            CK.restore(str(tmp_path), 1, {"w": torch.ones(2)})


def test_elastic_reshard_restore(tmp_path):
    """test_ft.py's elastic reshard: a state saved without a mesh restores
    onto a 1x1 mesh, replicated, with identical values; `like` is the
    abstract state (meta tensors), as JAX's is an eval_shape."""
    from repro_torch.dist.sharding import PartitionSpec as P
    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.optim import tree_map
    tcfg = TB.TrainConfig()
    gen = torch.Generator().manual_seed(0)
    state = t_init(TCFG_, tcfg, None, gen, CPU)
    CK.save(str(tmp_path), 1, state)
    like = TS.abstract_train_state(TCFG_, tcfg)
    mesh = make_host_mesh((1, 1), device=CPU)
    shardings = tree_map(lambda _: P(), like)
    restored = CK.restore(str(tmp_path), 1, like, mesh=mesh,
                          shardings=shardings)
    for a, b in zip(tree_leaves(state["params"]),
                    tree_leaves(restored["params"])):
        np.testing.assert_array_equal(a.numpy(), b.full_tensor().numpy())
    assert int(restored["step"].full_tensor()) == 0


# -------------------------------------------------- test_train.py's checks

def _state_and_step(tcfg, rt=None):
    gen = torch.Generator().manual_seed(0)
    return (t_init(TCFG_, tcfg, rt, gen, CPU),
            t_make(TCFG_, tcfg, rt))


def test_checkpoint_save_restore_resume(tmp_path):
    tcfg = TB.TrainConfig(warmup=2, lr=1e-3)
    state, step = _state_and_step(tcfg)
    data = TData(TCFG_, SHAPE, tcfg, seed=3)
    batches = [data.next() for _ in range(6)]
    for b in batches[:3]:
        state, _ = step(state, b)
    CK.save(str(tmp_path), 3, state)
    assert CK.latest(str(tmp_path)) == 3
    ref = state
    for b in batches[3:]:
        ref, _ = step(ref, b)
    like, _ = _state_and_step(tcfg)
    restored = CK.restore(str(tmp_path), 3, like, device=CPU)
    assert int(restored["step"]) == 3
    for b in batches[3:]:
        restored, _ = step(restored, b)
    for a, b_ in zip(tree_leaves(ref["params"]),
                     tree_leaves(restored["params"])):
        assert torch.equal(a, b_)


def test_async_checkpoint_copies_before_returning(tmp_path):
    state, _ = _state_and_step(TB.TrainConfig())
    want = state["params"]["final_norm"]["scale"].clone()
    t = CK.save(str(tmp_path), 1, state, blocking=False)
    state["params"]["final_norm"]["scale"].add_(1.0)   # the next step
    t.join(timeout=60)
    assert not t.is_alive()
    assert CK.latest(str(tmp_path)) == 1
    like, _ = _state_and_step(TB.TrainConfig())
    out = CK.restore(str(tmp_path), 1, like, device=CPU)
    assert torch.equal(out["params"]["final_norm"]["scale"], want)


def test_checkpoint_veto_via_filter(tmp_path):
    rt = TRuntime()
    rt.attach(rt.load_asm("nockpt", VETO_ALWAYS, [], "filter"),
              "filter:sys_checkpoint_save")
    state, _ = _state_and_step(TB.TrainConfig())
    CK.save(str(tmp_path), 1, state, runtime=rt)
    assert CK.latest(str(tmp_path)) is None      # vetoed


# ------------------------------------------- test_syscall_drills.py's drills

def _tiny_state(step=1):
    return {"step": np.int64(step), "w": np.arange(6, dtype=np.float32)}


def _veto_filter(rt, sys_name, code=0):
    pid = rt.load_asm(f"veto_{sys_name}", f"""
        mov r1, {code}
        call override_return
        mov r0, 0
        exit
    """, [], "filter")
    return rt.attach(pid, f"filter:{sys_name}")


def test_checkpoint_save_survives_transient_eio(tmp_path):
    rt = TRuntime()
    F.arm_syscall_fault(rt, "sys_checkpoint_save", budget=2)
    d = str(tmp_path)
    CK.save(d, 1, _tiny_state(1), runtime=rt, blocking=True)
    assert CK.latest(d) == 1                       # committed despite 2 EIOs
    assert rt.syscalls.counts["sys_checkpoint_save"] == 3
    assert F.drill_remaining(rt) <= 0


def test_checkpoint_save_degrades_on_persistent_eio(tmp_path):
    rt = TRuntime()
    d = str(tmp_path)
    CK.save(d, 1, _tiny_state(1), runtime=rt, blocking=True)
    F.arm_syscall_fault(rt, "sys_checkpoint_save", budget=100)
    n0 = rt.syscalls.counts["sys_checkpoint_save"]
    CK.save(d, 2, _tiny_state(2), runtime=rt, blocking=True,
            fault_retries=3)
    assert rt.syscalls.counts["sys_checkpoint_save"] - n0 == 4   # bounded
    assert CK.latest(d) == 1                       # previous commit stays


def test_checkpoint_save_veto_skips_without_retry(tmp_path):
    rt = TRuntime()
    _veto_filter(rt, "sys_checkpoint_save")
    CK.save(str(tmp_path), 1, _tiny_state(1), runtime=rt, blocking=True)
    assert rt.syscalls.counts["sys_checkpoint_save"] == 1    # no retry
    assert CK.latest(str(tmp_path)) is None


def test_checkpoint_restore_survives_transient_eio(tmp_path):
    rt = TRuntime()
    d = str(tmp_path)
    st = _tiny_state(3)
    CK.save(d, 3, st, runtime=rt, blocking=True)
    F.arm_syscall_fault(rt, "sys_checkpoint_restore", budget=2)
    out = CK.restore(d, 3, st, runtime=rt, device=CPU)
    assert out is not None
    np.testing.assert_array_equal(out["w"].numpy(), st["w"])
    assert int(out["step"]) == 3
    F.arm_syscall_fault(rt, "sys_checkpoint_restore", budget=100)
    assert CK.restore(d, 3, st, runtime=rt, device=CPU) is None   # degrade


def test_train_loop_survives_ckpt_and_data_eio(tmp_path):
    """run_training with both drills armed: transient data-read faults and
    checkpoint-write faults are absorbed by bounded retries -- every step
    runs, the checkpoint still commits."""
    rt = TRuntime()
    F.arm_syscall_fault(rt, "sys_data_fetch", budget=2)
    F.arm_syscall_fault(rt, "sys_checkpoint_save", budget=1,
                        map_name="ckpt_budget")
    ckpt = str(tmp_path / "ckpt")
    os.makedirs(ckpt)
    state, hist = TL.run_training(
        ARCH, steps=3, runtime=rt, ckpt_dir=ckpt, save_every=2, seq_len=16,
        batch=2, log_every=0, device=CPU)
    assert len(hist) == 3                          # no step lost to EIO
    assert CK.latest(ckpt) == 2
    assert F.drill_remaining(rt) <= 0
    assert F.drill_remaining(rt, "ckpt_budget") <= 0


# ---------------------------------------------------- test_ft.py's restart

def test_supervisor_restart_from_checkpoint(tmp_path):
    """Inject a failure mid-training; the supervisor restores the latest
    checkpoint and training completes with the right final step."""
    tcfg = TB.TrainConfig(warmup=2)
    state, step = _state_and_step(tcfg)
    data = TData(TCFG_, ShapeConfig("f", 32, 4, "train"), tcfg)
    like, _ = _state_and_step(tcfg)
    d = str(tmp_path)
    sup = FT.TrainSupervisor(d, save_every=5, max_restarts=2)
    CK.save(d, 0, state)
    fails = {12}

    def failure_hook(step_no):
        if step_no in fails:
            fails.discard(step_no)
            raise FT._Injected(f"host died at step {step_no}")

    final = sup.run(
        state, step, data.next, total_steps=20,
        save_fn=lambda s, st: CK.save(d, s, st),
        restore_fn=lambda: CK.restore(d, CK.latest(d), like, device=CPU),
        failure_hook=failure_hook)
    assert int(final["step"]) == 20
    assert sup.restarts == 1
    assert CK.latest(d) == 20
    assert all(np.isfinite(_np(final["params"])["final_norm"]["scale"]))
