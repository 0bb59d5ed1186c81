"""Helpers of the card tests (`tests/test_torch_card_*.py`).

This module imports only torch, numpy and the port, so a card test never
imports JAX, which the card's machine does not have. Nothing here touches a
device when it is imported.
"""
from __future__ import annotations

import contextlib

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

SEED = 0
# the probe kernels every probed serving step launches
SERVING_KERNELS = ("tensor_stats", "hash_fetch_add_batch",
                   "ringbuf_emit_batch")
# operators that allocate or alias and launch no device work
NO_WORK = ("empty", "detach", "view", "alias", "as_strided", "_reshape_alias",
           "_unsafe_view", "reshape", "slice", "select", "unsqueeze",
           "squeeze", "expand", "t", "permute", "transpose", "flatten",
           "lift_fresh")
STATS_TOL = 2e-5
LOGIT_TOL = 1e-4


class Dispatched(TorchDispatchMode):
    """The names of the PyTorch operators dispatched while it is on."""

    def __init__(self):
        super().__init__()
        self.names = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self.names.append(func.overloadpacket.__name__)
        return func(*args, **(kwargs or {}))


def device_work(names) -> list:
    """Those of `names` that may launch device work."""
    return [n for n in names if not n.startswith(NO_WORK)]


@contextlib.contextmanager
def emits_counted():
    """Every collector event run under `Dispatched`: yields a dict whose
    "events" counts the events and "work" lists the operators they
    dispatched that may launch device work (the tensor_stats kernel is a
    ctypes launch, which dispatches none)."""
    from repro_torch.core import events as E
    seen = {"events": 0, "work": []}
    emit = E.Collector.emit_tensor_event

    def counted(self, site_id, kind, tensor):
        with Dispatched() as mode:
            emit(self, site_id, kind, tensor)
        seen["events"] += 1
        seen["work"] += device_work(mode.names)
    E.Collector.emit_tensor_event = counted
    try:
        yield seen
    finally:
        E.Collector.emit_tensor_event = emit


@contextlib.contextmanager
def tf32_off():
    """f32 matmuls in full precision, so card and CPU compare."""
    was = torch.backends.cuda.matmul.allow_tf32, \
        torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, \
            torch.backends.cudnn.allow_tf32 = was


def to_device(tree, device):
    from repro_torch.optim import tree_map
    return tree_map(lambda t: t.to(device), tree)


def init_params(cfg, device):
    from repro_torch.models import registry as MR
    return MR.init_params(cfg, torch.Generator(device=device)
                          .manual_seed(SEED), device)


def runtime(cfg, *, admit_limit=12, live=None):
    """The serving runtime: the admission filter at `admit_limit` and the
    family's serving probes on the fused lane. live="loaded" also loads
    LIVE_PROBES, live="armed" also arms the live lane on LIVE_ARM (before
    any engine is built). Returns (runtime, LIVE_PROBES' ids or None)."""
    from repro_torch.core.runtime import BpftimeRuntime
    from repro_torch.launch import serve as L
    rt = BpftimeRuntime()
    pid = rt.load_asm("admit", L.admit_filter_text(admit_limit), [],
                      "filter")
    rt.attach(pid, "filter:sys_serve_admit")
    L.attach_serve_probes(rt, L.family_probes(cfg))
    pids = L.load_live_probes(rt) if live else None
    if live == "armed":
        rt.enable_live_attach(arm=L.LIVE_ARM)
    return rt, pids


def serve(cfg, device, params=None, *, rt=None, shm_dir=None,
          worker_id=None):
    """An engine on `rt` (default `runtime(cfg)`; 4 slots, max_seq 128)
    and 8 requests of 8 new tokens."""
    from repro_torch.launch import serve as L
    from repro_torch.serve.engine import ServeEngine
    rt = rt or runtime(cfg)[0]
    engine = ServeEngine(init_params(cfg, device) if params is None
                         else params, cfg, slots=4, max_seq=128, runtime=rt,
                         shm_dir=shm_dir, worker_id=worker_id, device=device)
    return engine, L.make_requests(8, 8, cfg.vocab_size, SEED)


def layers_of(cfg, pred) -> int:
    """Layers whose superblock position satisfies `pred`."""
    return sum(pred(j) for j in range(cfg.superblock)) * \
        cfg.num_layers // cfg.superblock


def events_per_step(cfg) -> int:
    """Rows a decode step collects for the family's serving probes: block
    entry and exit on every layer, ssm.out on a mamba layer, moe.load and
    moe.drops on a MoE layer, and the logits."""
    per_super = sum(2 + (cfg.block_kind(j) == "mamba")
                    + 2 * (cfg.ffn_kind(j) == "moe")
                    for j in range(cfg.superblock))
    return per_super * cfg.num_layers // cfg.superblock + 1


def differing(a, b) -> list:
    """The fields of map states `b` that differ in `a`."""
    from repro_torch.core.runtime import to_numpy
    a, b = to_numpy(a), to_numpy(b)
    return [f"{m}.{f}" for m in b for f in b[m]
            if not np.array_equal(a[m][f], b[m][f])]


def replay_tape(rt, tape, maps):
    """A step's tape (rows, maps_in, step) through the fused, scan and
    vectorized modes of `rt`: each must end in the map states `maps`."""
    from repro_torch.core import jit as J
    rows, maps_in, step = tape
    for mode in ("fused", "scan", "vectorized"):
        out, _ = rt.probe_stage(
            rows, maps_in, J.make_aux(time_ns=step, device=rows.device),
            mode=mode)
        assert differing(out, maps) == [], mode


def maps_card_vs_cpu(card, cpu, rb_name):
    """Every map bit for bit, but the ring buffer `rb_name`'s two Q47.16
    stat lanes, which sums in another order leave within STATS_TOL
    (relative) or 1."""
    from repro_torch.core.runtime import to_numpy
    g, c = to_numpy(card), to_numpy(cpu)
    rb_g, rb_c = g[rb_name]["data"], c[rb_name]["data"]
    np.testing.assert_allclose(rb_g[:, 2:].astype(np.float64),
                               rb_c[:, 2:].astype(np.float64),
                               rtol=STATS_TOL, atol=1)
    g[rb_name]["data"], c[rb_name]["data"] = rb_g[:, :2], rb_c[:, :2]
    assert set(g) == set(c)
    assert [f"{m}.{f}" for m in c for f in c[m]
            if not np.array_equal(g[m][f], c[m][f])] == []


def logits_close(card, cpu):
    """Card and CPU logits within LOGIT_TOL of the largest magnitude (and
    absolutely below 1)."""
    err = float((card.cpu() - cpu).abs().max())
    assert err <= LOGIT_TOL * (1 + float(cpu.abs().max())), err


def bits_equal(a, b) -> bool:
    """Same dtype, shape and bits (NaNs included)."""
    a, b = a.detach().cpu(), b.detach().cpu()
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.is_floating_point():
        view = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
            a.element_size()]
        a, b = a.view(view), b.view(view)
    return torch.equal(a, b)


def block_targets(cfg) -> list:
    """Where TRAIN_PROBES' layer counters attach: uprobe:block, which every
    decoder layer fires; the encoder-decoder family fires no such site, so
    for it its layers' exits."""
    if cfg.family == "encdec":
        return ["uretprobe:enc.block", "uretprobe:dec.block"]
    return ["uprobe:block"]


def train_runtime(cfg, tape=None):
    """A runtime with TRAIN_PROBES on the fused lane (the layer counters at
    block_targets(cfg)) whose probe stage counts the rows of every call in
    the returned list; with a dict `tape`, tape["last"] is the last
    stage's (rows, a copy of the maps it started from, the step)."""
    from repro_torch.core.maps import MapKind, MapSpec
    from repro_torch.core.runtime import BpftimeRuntime
    from repro_torch.launch import train as T
    rt = BpftimeRuntime()
    for name, text, spec, ptype, target in T.TRAIN_PROBES:
        maps = [] if spec is None else [
            MapSpec(spec[0], MapKind(spec[1]), spec[2], rec_width=spec[3])]
        pid = rt.load_asm(name, text, maps, ptype)
        for tgt in block_targets(cfg) if target == "uprobe:block" \
                else [target]:
            rt.attach(pid, tgt, mode="fused")
    events, stage = [], rt.probe_stage

    def counting_stage(rows, maps, aux, mode=None):
        events.append(int(rows.shape[0]))
        if tape is not None:
            tape["last"] = (rows, {n: {f: a.clone() for f, a in st.items()}
                                   for n, st in maps.items()},
                            aux["time_ns"].clone())
        return stage(rows, maps, aux, mode=mode)
    rt.probe_stage = counting_stage
    return rt, events


@contextlib.contextmanager
def one_card_mesh():
    """A (1, 1) mesh over a world-size-1 NCCL group, which is destroyed
    after, if this made it."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_host_mesh
    made = not dist.is_initialized()
    try:
        yield make_host_mesh((1, 1), device="cuda")
    finally:
        if made and dist.is_initialized():
            dist.destroy_process_group()
