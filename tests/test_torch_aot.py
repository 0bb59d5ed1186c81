"""The port's `log2_histogram`, its probe kernels as custom operators, and
its cached exported step (`BpftimeRuntime.aot_step`,
`ArtifactCache.put_step/get_step`) against the JAX package's, on the CPU,
bit for bit: the histogram over seeded and special inputs; each probe
operator against its plain version; the probe stage of an ARRAY, a HASH, a
LOG2HIST and a RINGBUF program exported, stored, loaded in a fresh runtime
(for one program in a fresh process), corrupted and rebuilt, with the map
states of every route equal to the eager stage's and to JAX's
`probe_stage`; the steps that cannot be exported; and the device in the
key. Runtime and tape helpers are tests/test_torch_live.py's."""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.core import faults as JF, jit as JJ  # noqa: E402
from repro.kernels import ref as JREF  # noqa: E402
from repro_torch.core import events as TE, faults as TF, jit as TJ  # noqa: E402
from repro_torch.kernels import ops, ref as TREF  # noqa: E402

from test_torch_live import (CPU, PROGS, ROOT, SPEC_OF, SPECS, Pair,  # noqa: E402,E501
                             assert_aux_equal, assert_maps_equal, make_tape)

SITE = "uprobe:lv_block"


# ------------------------------------------------------------ log2_histogram

def _hist_input(case: str) -> np.ndarray:
    """Seeded f32 values over many octaves, or the specials: 0, -0,
    negatives, NaN, +-Inf, subnormals, the smallest and largest values
    whose Q47.16 value is nonzero or below the 2**62 clip, and values past
    2**46 that clip."""
    rng = np.random.default_rng(11)
    x = (rng.standard_normal(4099) * np.exp2(rng.integers(-30, 60, 4099))
         ).astype(np.float32)
    if case == "seeded":
        return x
    tiny = np.float32(np.finfo(np.float32).tiny)
    specials = np.array(
        [0.0, -0.0, -1.0, -3e9, np.nan, np.inf, -np.inf, tiny, tiny / 8,
         -tiny / 3, 2.0**-16, 2.0**-17, 1.5 * 2.0**-16, 1.0, 2.0**45,
         2.0**46, 2.0**46 * 1.5, 2.0**47, 2.0**60, 3.4e38, -3.4e38],
        np.float32)
    return np.concatenate([specials, x[:500]])


@pytest.mark.parametrize("case,dtype,n_bins", [
    ("seeded", "float32", 64), ("specials", "float32", 64),
    ("seeded", "bfloat16", 64), ("specials", "bfloat16", 64),
    ("seeded", "float32", 16), ("specials", "bfloat16", 16),
    ("specials", "float32", 1), ("seeded", "bfloat16", 1),
])
def test_log2_histogram_matches_jax(case, dtype, n_bins):
    x = _hist_input(case)
    tx = torch.from_numpy(x).to(getattr(torch, dtype))
    jx = jnp.asarray(x).astype(getattr(jnp, dtype))
    got = ops.log2_histogram(tx, n_bins)
    want = np.asarray(JREF.log2_histogram(jx, n_bins))
    assert got.dtype == torch.int64 and tuple(got.shape) == (n_bins,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert int(got.sum()) == x.size


# ------------------------------------------------------------ custom ops

def _op_case(name: str):
    """(operator, plain version, args) at a probe path's shapes."""
    rng = np.random.default_rng(3)
    if name == "hash_fetch_add_batch":
        n, b = 64, 49
        used = torch.from_numpy((rng.random(n) < 0.3).astype(np.int64))
        keys_tbl = torch.from_numpy(rng.integers(0, 40, n)) * used
        args = (keys_tbl, used, torch.from_numpy(rng.integers(0, 9, n)),
                torch.from_numpy(rng.integers(0, 40, b)),
                torch.from_numpy(rng.integers(-3, 9, b)),
                torch.from_numpy(rng.random(b) < 0.8))
        return (torch.ops.repro_torch.hash_fetch_add_batch,
                TREF.hash_fetch_add_batch, args)
    if name == "ringbuf_emit_batch":
        cap, w, b = 16, 4, 49
        args = (torch.from_numpy(rng.integers(0, 99, (cap, w))),
                torch.tensor([13]), torch.tensor([2]),
                torch.from_numpy(rng.integers(0, 99, (b, w))),
                torch.from_numpy(rng.random(b) < 0.7))
        return (torch.ops.repro_torch.ringbuf_emit_batch,
                TREF.ringbuf_emit_batch, args)
    x = torch.from_numpy(rng.standard_normal((4, 1, 96)).astype(np.float32))
    x[0, 0, :3] = torch.tensor([float("nan"), float("inf"), -float("inf")])
    return (torch.ops.repro_torch.tensor_stats_row, TREF.tensor_stats_row,
            (x, 5, 1, 7))


@pytest.mark.parametrize("name", ["hash_fetch_add_batch",
                                  "ringbuf_emit_batch", "tensor_stats_row"])
def test_probe_custom_ops_match_plain(name):
    """Each operator's CPU implementation is the plain version, and the
    registration (fake implementation, schema, no aliasing) passes
    torch.library.opcheck."""
    op, plain, args = _op_case(name)
    got, want = op(*args), plain(*args)
    for g, w in zip(*(t if isinstance(t, tuple) else (t,)
                      for t in (got, want))):
        assert torch.equal(g, w)
    torch.library.opcheck(op, args)


def test_eager_calls_skip_the_dispatcher(monkeypatch):
    """Outside an export the wrappers call the plain version (or the
    kernel) directly: the operators are not reached."""
    def boom(*a, **k):
        raise AssertionError("operator reached in an eager call")
    monkeypatch.setattr(torch.ops.repro_torch, "hash_fetch_add_batch", boom)
    _op, _plain, args = _op_case("hash_fetch_add_batch")
    kt, _, _ = ops.hash_fetch_add_batch(*args)
    assert kt.shape == args[0].shape


# ------------------------------------------------------------ aot_step

def _pair(prog: str, **kw) -> Pair:
    p = Pair(live=False)
    p.attach(prog, SITE, mode="fused", **kw)
    return p


def _stage_factory(rt):
    return lambda: (lambda r, m, a: rt.probe_stage(r, m, a))


def _args(rt, rows):
    return (torch.as_tensor(rows), rt.init_device_maps(CPU),
            TJ.make_aux(device=CPU))


def _jax_boot(p: Pair, cache_dir: str, rows):
    """JAX's aot_step over its probe stage on the same tape: (maps, aux,
    hit, counters)."""
    from test_torch_live import jax_sites
    j = p.j
    j.enable_artifact_cache(cache_dir)
    jr = jnp.asarray(jax_sites(rows))
    jm0 = j.init_device_maps()
    step, hit = j.aot_step(
        lambda: jax.jit(lambda r, m: j.probe_stage(r, m, JJ.make_aux())),
        (jr, jm0), extra_key=("aot", len(rows)))
    jm, ja = step(jr, jm0)
    return jm, ja, hit, dict(j.artifact_cache.counters)


def _counters(c: dict) -> dict:
    return {k: v for k, v in c.items() if k != "unexportable"}


CHILD = r"""
import json, sys
import numpy as np, torch
from repro_torch.core import jit as TJ, maps as TM
from repro_torch.core.events import SITES
from repro_torch.core.runtime import BpftimeRuntime, to_numpy
cfg = json.load(open(sys.argv[1]))
for name in cfg["sites"]:                 # the parent's site ids
    SITES.get_or_create(name)
rt = BpftimeRuntime()
for s in cfg["specs"]:
    rt.create_map(TM.MapSpec(s[0], TM.MapKind(s[1]), s[2], rec_width=s[3],
                             num_shards=s[4]))
spec = cfg["spec"]
pid = rt.load_asm(cfg["prog"], cfg["text"],
                  [TM.MapSpec(spec[0], TM.MapKind(spec[1]), spec[2],
                              rec_width=spec[3], num_shards=spec[4])],
                  "uprobe")
rt.attach(pid, cfg["site"], mode="fused")
rt.enable_artifact_cache(cfg["cache"])
rows = torch.from_numpy(np.load(cfg["tape"]))
args = (rows, rt.init_device_maps("cpu"), TJ.make_aux(device="cpu"))
step, hit = rt.aot_step(lambda: (lambda r, m, a: rt.probe_stage(r, m, a)),
                        args, extra_key=("aot", len(rows)))
maps, _ = step(*args)
np.savez(cfg["out"], **{f"{n}.{f}": v for n, st in to_numpy(maps).items()
                        for f, v in st.items()})
print(json.dumps({"hit": hit, "counters": rt.artifact_cache.counters}))
"""


def _boot_in_child(tmp_path, prog, rows, cache_dir):
    """A fresh process builds the same runtime and boots the stage through
    the same cache directory; returns (hit, counters, maps)."""
    tape, out, cfg = (str(tmp_path / n) for n in ("tape.npy", "maps.npz",
                                                  "cfg.json"))
    np.save(tape, rows)
    text, m = PROGS[prog]
    with open(cfg, "w") as f:
        known = TE.SITES.known()
        json.dump({"sites": sorted(known, key=known.get),
                   "specs": SPECS, "spec": SPEC_OF[m], "prog": prog,
                   "text": text, "site": SITE, "cache": cache_dir,
                   "tape": tape, "out": out}, f)
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    res = subprocess.run([sys.executable, "-c", CHILD, cfg], env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    info = json.loads(res.stdout.strip().splitlines()[-1])
    with np.load(out) as z:
        maps = {}
        for k in z.files:
            n, f = k.split(".")
            maps.setdefault(n, {})[f] = z[k]
    return info["hit"], info["counters"], maps


@pytest.mark.parametrize("prog", ["count", "hash", "hist", "rb"])
def test_aot_step_fused_lane_matches_eager_and_jax(tmp_path, prog):
    rows = make_tape(48)
    p = _pair(prog)
    jm0, tm0 = p.maps()
    jm, ja, tm, ta = p.stage(rows, jm0, tm0)          # JAX's and eager

    # miss: traced, stored, and the program runs the probe operators
    cache_dir = str(tmp_path / "cache")
    c = p.t.enable_artifact_cache(cache_dir)
    args = _args(p.t, rows)
    step, hit = p.t.aot_step(_stage_factory(p.t), args, extra_key=("aot", 48))
    assert not hit and p.t.last_export_error is None
    assert c.counters["stores"] == 1 and c.counters["misses"] == 1
    assert [r["kind"] for r in c.ls()] == ["step"]
    graph = str(step.graph)
    for name, op in (("hash", "hash_fetch_add_batch"),
                     ("rb", "ringbuf_emit_batch")):
        assert (f"repro_torch.{op}" in graph) == (prog == name), graph
    sm, sa = step(*args)
    assert_maps_equal(jm, sm)
    assert_aux_equal(ja, sa)
    assert_maps_equal(jm, tm)

    # hit: a fresh runtime on the same directory (a fresh process for one)
    if prog == "hist":
        hit2, counters, maps2 = _boot_in_child(tmp_path, prog, rows,
                                               cache_dir)
        assert hit2 and counters["hits"] == 1 and counters["stores"] == 0
        for name in maps2:
            for f in maps2[name]:
                np.testing.assert_array_equal(maps2[name][f],
                                              np.asarray(jm[name][f]))
    else:
        q = _pair(prog)
        c2 = q.t.enable_artifact_cache(cache_dir)
        step2, hit2 = q.t.aot_step(_stage_factory(q.t), _args(q.t, rows),
                                   extra_key=("aot", 48))
        assert hit2 and c2.counters["hits"] == 1
        assert c2.counters["stores"] == 0
        assert_maps_equal(jm, step2(*_args(q.t, rows))[0])

    # a corrupted entry is detected, dropped and rebuilt, with JAX's
    # counters on every boot of the same drill
    drill = str(tmp_path / "drill")
    boots = []
    for k in range(3):
        q = _pair(prog)
        if k == 0:
            with TF.plan(TF.FaultPlan(seed=0,
                                      rates={"corrupt_artifact": 1.0})):
                q.t.enable_artifact_cache(drill + "_t")
                step_k, hit_k = q.t.aot_step(_stage_factory(q.t), _args(q.t, rows),
                                             extra_key=("aot", 48))
            with JF.plan(JF.FaultPlan(seed=0,
                                      rates={"corrupt_artifact": 1.0})):
                jboot = _jax_boot(q, drill + "_j", rows)
        else:
            q.t.enable_artifact_cache(drill + "_t")
            step_k, hit_k = q.t.aot_step(_stage_factory(q.t), _args(q.t, rows),
                                         extra_key=("aot", 48))
            jboot = _jax_boot(q, drill + "_j", rows)
        assert hit_k == jboot[2] == (k == 2)
        assert _counters(q.t.artifact_cache.counters) == jboot[3]
        assert q.t.artifact_cache.counters["unexportable"] == 0
        assert_maps_equal(jboot[0], step_k(*_args(q.t, rows))[0])
        boots.append(jboot[3])
    assert boots[1]["corrupt"] == 1 and boots[1]["stores"] == 1


@pytest.mark.parametrize("lane", ["scan", "live"])
def test_aot_step_unexportable_stage_runs_eagerly(tmp_path, lane):
    """The scan lane reads the tape on the host and the live lane's
    interpreter runs outside the operators: (build_fn(), False), nothing
    stored, `unexportable` counted, maps still JAX's."""
    rows = make_tape(48)
    if lane == "scan":
        p = _pair("loop")                  # a loop: the scan lane
    else:
        p = Pair(live=True)
        p.attach("count", SITE, mode="table", promote=False)
    jm0, tm0 = p.maps()
    if lane == "live":
        jm0, tm0 = p.j.sync_live_table(jm0), p.t.sync_live_table(tm0)
    jm, ja, _, _ = p.stage(rows, jm0, tm0)
    c = p.t.enable_artifact_cache(str(tmp_path / "cache"))
    args = (torch.as_tensor(rows), tm0, TJ.make_aux(device=CPU))
    built = []

    def build():
        built.append(lambda r, m, a: p.t.probe_stage(r, m, a))
        return built[-1]
    step, hit = p.t.aot_step(build, args, extra_key=("aot", 48))
    assert not hit and step is built[0] and len(built) == 1
    assert c.counters["unexportable"] == 1 and c.counters["stores"] == 0
    assert c.ls() == [] and p.t.last_export_error
    sm, sa = step(*args)
    assert_maps_equal(jm, sm, names=[s[0] for s in SPECS])
    assert_aux_equal(ja, sa)


def test_aot_step_key_keeps_devices_apart(tmp_path):
    """The device type and torch's version are in the key: a program
    traced on the CPU is never served under a card worker's key."""
    rows = make_tape(48)
    p = _pair("count")
    c = p.t.enable_artifact_cache(str(tmp_path / "cache"))
    p.t.aot_step(_stage_factory(p.t), _args(p.t, rows), extra_key=("aot", 48))
    cpu_key = p.t.step_key(("aot", 48), "cpu")
    cuda_key = p.t.step_key(("aot", 48), "cuda")
    assert cpu_key != cuda_key
    assert [r["key"] for r in c.ls()] == [cpu_key]
    assert c.get_step(cuda_key) is None
    assert c.counters["misses"] == 2 and c.counters["hits"] == 0
