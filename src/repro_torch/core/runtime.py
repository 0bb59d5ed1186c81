"""BpftimeRuntime -- the runtime manager (bpftime's agent + syscall-compat
library rolled into one), device half for PyTorch.

Responsibilities:
  * global map registry (create/bind by name -- objects share maps by name);
  * program load: relocate (CO-RE-lite) -> verify -> store;
  * attachments:
      device:  uprobe:SITE / uretprobe:SITE / probe:SITE   (in the step)
      host:    tracepoint:SYS:enter|exit / filter:SYS      (interpreter)
  * the per-step probe-execution stage, run on the device inside the
    train/serve step; every fused attach/detach bumps `attach_epoch`;
  * attach/detach on a RUNNING step without rebuilding it: the live
    program-table lane (`enable_live_attach` + `attach(mode="table")`)
    encodes verified bytecode into a device-resident table read by one
    interpreter kernel launch per probe stage -- dispatch is data, so a hot
    attach is a buffer write (`attach_live`/`detach_live` remain as
    deprecated shims);
  * ONE attach API over all of it: `attach(pid, target, *, mode, promote)`
    returns a `Link` (lane + slot + promotion state); `mode="auto"` routes
    to the table lane when the program can land on the running step, and
    `promote=True` arms background promotion -- `core/promote.py` builds
    the fused-lane step off the critical path and `sync_live_table` swaps
    it in at the next generation boundary, bit-identical;
  * shm control plane: publish device maps, poll daemon attach requests
    (`setup_shm`, `publish`, `poll_control`); encoded table images are
    shared through the fleet artifact cache.
"""
from __future__ import annotations

import contextlib
import itertools
import threading
import warnings
from dataclasses import dataclass, field

import torch

from . import events as E, jit as J, loader, maps as M, syscalls as S
from . import vectorized as V
from .helpers import HELPERS
from .loader import ProgramObject
from .maps import MapSpec
from .verifier import (CallAnn, COMMUTATIVE_HELPERS as _COMMUTATIVE_HELPERS,
                       VerifiedProgram, footprints_disjoint)

_AUX_RESOURCES = {"trace_printk": "printk", "override_return": "override",
                  "get_prandom_u32": "rand"}

# observability: how often the footprint proofs fired
WIDEN_STATS = {"fused_disjoint_pairs": 0}

# live-table generations whose host snapshot a runtime keeps (live_table_at)
TABLE_SNAPSHOTS = 64

def _ordering_resources(vprog: VerifiedProgram) -> dict:
    """{resource: commutative?} for one program. Two DIFFERENT programs may
    be scheduled on different fused lanes (or reordered within one) only if
    every resource they share is touched commutatively by both; otherwise
    the fused pipeline must keep the scan ordering."""
    out: dict = {}
    for ann in vprog.anns.values():
        if not isinstance(ann, CallAnn):
            continue
        sig = HELPERS[ann.hid]
        comm = sig.name in _COMMUTATIVE_HELPERS
        for i, kind in enumerate(sig.args):
            if kind == "mapfd":
                key = ("map", vprog.map_specs[ann.statics[i]].name)
                out[key] = out.get(key, True) and comm
        if sig.name in _AUX_RESOURCES:
            out[("aux", _AUX_RESOURCES[sig.name])] = False
    return out


def _has_ordering_conflict(vprogs: list) -> bool:
    """True iff any resource is shared non-commutatively across two
    distinct programs (same program attached to several sites is fine --
    its per-attachment order is preserved by the fused scheduler) AND the
    verifier's effect footprints cannot prove the sharing unobservable
    (disjoint static cells on a positional map -- widening rule 1)."""
    res = [_ordering_resources(vp) for vp in vprogs]
    for i in range(len(res)):
        for j in range(i + 1, len(res)):
            for key, comm_i in res[i].items():
                if key not in res[j] or (comm_i and res[j][key]):
                    continue
                if key[0] == "map" and footprints_disjoint(
                        vprogs[i].footprint_of(key[1]),
                        vprogs[j].footprint_of(key[1])):
                    WIDEN_STATS["fused_disjoint_pairs"] += 1
                    continue
                return True
    return False


@dataclass
class LoadedProg:
    pid: int
    name: str
    prog_type: str
    insns: list
    vprog: VerifiedProgram
    # the abstract (pre-relocation) verification, when the program came in
    # through the CO-RE path
    vabs: VerifiedProgram | None = None


class _Step(torch.nn.Module):
    """A step function as the module `torch.export` traces."""

    def __init__(self, fn):
        super().__init__()
        self.fn = fn

    def forward(self, *args):
        return self.fn(*args)


@dataclass(eq=False)
class Link:
    """Handle for one attachment, whatever lane it executes on.

    ``lane`` is where the program runs right now: ``"fused"`` (in the
    step's static lanes), ``"table"`` (live program-table interpreter) or
    ``"host"`` (syscall tracepoints/filters). A table link carries its
    ``slot`` and a ``promotion_state`` driven by core/promote.py:
    ``interp -> compiling -> ready -> fused`` (or ``cancelled``/``failed``).
    The handle coerces to its integer link id, so it can be passed back to
    ``Runtime.detach``."""
    link_id: int
    pid: int
    target: str
    lane: str = "fused"
    slot: int | None = None
    promotion_state: str = "none"
    promote: bool = False
    promotion_error: str | None = None
    _parsed: tuple | None = field(default=None, repr=False)
    _rt: object = field(default=None, repr=False)

    def detach(self) -> None:
        self._rt.detach(self)

    def __int__(self) -> int:
        return self.link_id

    def __index__(self) -> int:
        return self.link_id


class BpftimeRuntime:
    def __init__(self, pid: int = 0):
        self.map_specs: list[MapSpec] = []
        self.fd_of: dict[str, int] = {}
        self.progs: dict[int, LoadedProg] = {}
        self._next_pid = itertools.count(1)
        self._next_link = itertools.count(1)
        self.links: dict[int, Link] = {}
        # device attachments: (site_id, kind) -> [pid]
        self.device_attach: dict[tuple[int, int], list[int]] = {}
        self.attach_epoch = 0
        # host side
        self.host_maps: dict = {}
        self.syscalls = S.SyscallTable(self.host_maps, self.map_specs,
                                       pid=pid)
        self.shm = None
        self._req_cursor = 0
        self._objects: dict[str, str] = {}   # name -> serialized object
        # 'fused' (default): single-pass multi-program dispatch;
        # 'scan' / 'vectorized': the per-attachment paths.
        self.exec_mode = "fused"
        # live program-table lane (enable_live_attach)
        self.live = None
        self._armed: set[tuple[int, int]] = set()
        self._live_slot_of: dict[int, int] = {}   # link_id -> table slot
        self._synced_gen = 0                      # last gen pushed to device
        # host snapshots of the last TABLE_SNAPSHOTS tables written to a
        # device state, by generation, and the generation written last
        self._table_snapshots: dict[int, torch.Tensor] = {}
        self._table_gen = None
        # background promotion (enable_promotion / core/promote.py)
        self._promoter = None
        self._promoted_step = None    # step built by a promotion, for pickup
        self._overlay_tls = threading.local()
        # fleet-wide artifact cache of encoded table images
        # (enable_artifact_cache / core/artifact_cache.py); setup_shm
        # auto-joins <root>/cache
        self.artifact_cache = None
        self.last_export_error = None     # why aot_step ran a step eagerly

    # ---------------------------------------------------------------- maps
    def create_map(self, spec: MapSpec) -> int:
        if spec.name in self.fd_of:
            old = self.map_specs[self.fd_of[spec.name]]
            if (old.kind, old.max_entries, old.rec_width, old.num_shards) != \
               (spec.kind, spec.max_entries, spec.rec_width, spec.num_shards):
                raise loader.LoadError(
                    f"map {spec.name!r} redeclared with incompatible spec")
            return self.fd_of[spec.name]
        fd = len(self.map_specs)
        self.map_specs.append(spec)
        self.fd_of[spec.name] = fd
        self.host_maps[spec.name] = M.init_state_np(spec)
        return fd

    def init_device_maps(self, device="cuda") -> dict:
        """Zeroed device state of every registered map, on `device`, and
        the live table (`__live_table__`) when the live lane is on."""
        st = M.init_states(self.map_specs, device)
        if self.live is not None:
            host = torch.from_numpy(self.live.packed())
            st["__live_table__"] = self.live.views(host.to(device, copy=True))
            self._record_table(host)
        return st

    def _record_table(self, host) -> None:
        gen = int(host[-1])
        self._table_snapshots.pop(gen, None)
        self._table_snapshots[gen] = host
        self._table_gen = gen
        while len(self._table_snapshots) > TABLE_SNAPSHOTS:
            del self._table_snapshots[next(iter(self._table_snapshots))]

    @property
    def table_generation(self):
        """The generation of the live table this runtime last wrote to a
        device state (`init_device_maps` or `sync_live_table`): the one the
        next probe stage runs. None without the live lane."""
        return self._table_gen

    def live_table_at(self, gen: int, device) -> dict:
        """The live table of generation `gen` as it was written, as a new
        device state on `device` -- what a replay of a step that ran it
        takes, since a sync writes the step's own buffer in place. The last
        TABLE_SNAPSHOTS generations are kept."""
        if gen not in self._table_snapshots:
            raise KeyError(f"live table generation {gen} is no longer kept "
                           f"(the last {TABLE_SNAPSHOTS} are)")
        return self.live.views(self._table_snapshots[gen].to(device,
                                                            copy=True))

    # ---------------------------------------------------------------- load
    def load_object(self, obj: ProgramObject) -> int:
        """Verify ONCE against the object's own declared layout (abstract
        mode), then bind to this runtime's registry by relocation -- the
        CO-RE pipeline."""
        from . import reloc
        vabs = reloc.verify_relocatable(obj)
        for spec in obj.map_specs():
            self.create_map(spec)
        vprog = reloc.resolve(vabs, self.fd_of, self.map_specs)
        pid = next(self._next_pid)
        self.progs[pid] = LoadedProg(pid, obj.name, obj.prog_type,
                                     vprog.insns, vprog, vabs=vabs)
        self._objects[obj.name] = obj.to_json()
        if self.shm is not None:
            self.shm.publish_program(obj.to_json(), obj.name)
        return pid

    def load_relocatable(self, vabs: VerifiedProgram, name: str,
                         prog_type: str = "uprobe") -> int:
        """Bind an ALREADY-verified abstract program to this runtime --
        zero verifier work, pure relocation. Declared maps are created on
        demand, like load_object."""
        from . import reloc
        if not vabs.is_abstract:
            raise loader.LoadError("load_relocatable needs an abstract "
                                   "VerifiedProgram (verify_relocatable)")
        for ml in vabs.reloc.map_layouts:
            self.create_map(ml.to_spec())
        vprog = reloc.resolve(vabs, self.fd_of, self.map_specs)
        pid = next(self._next_pid)
        self.progs[pid] = LoadedProg(pid, name, prog_type, vprog.insns,
                                     vprog, vabs=vabs)
        return pid

    def load_asm(self, name: str, text: str, maps: list[MapSpec] = (),
                 prog_type: str = "uprobe", ctx_words: int = 16) -> int:
        obj = loader.build_object(name, text, list(maps), prog_type,
                                  ctx_words=ctx_words)
        return self.load_object(obj)

    # ---------------------------------------------------------------- live lane
    @staticmethod
    def _parse_device_target(target: str):
        """(site_id, event_kind) for a device target, None for host targets."""
        parts = target.split(":")
        if parts[0] not in ("uprobe", "uretprobe", "probe"):
            return None
        ev_kind = {"uprobe": E.KIND_ENTRY, "uretprobe": E.KIND_EXIT,
                   "probe": E.KIND_TRACEPOINT}[parts[0]]
        return E.SITES.get_or_create(parts[1]), ev_kind

    def enable_live_attach(self, max_programs: int = 4, max_insns: int = 64,
                           arm=()):
        """Opt into the program-table interpreter lane. Must run BEFORE the
        step is built (the table joins the map state and the interpreter
        joins probe_stage) -- after which table attaches and detaches never
        rebuild it. `arm` pre-declares device targets whose events are
        collected even with no program attached (the paper's patched-but-
        idle trampoline), since a built step's collector is fixed."""
        from .table_interp import LiveTable
        self.live = LiveTable(list(self.map_specs),
                              ctx_words=E.EVENT_WIDTH,
                              max_programs=max_programs,
                              max_insns=max_insns)
        for target in arm:
            self.arm_site(target)
        self.attach_epoch += 1
        return self.live

    def arm_site(self, target: str) -> None:
        """Collect events for a device target so hot-attached programs can
        consume them. Changes what a step collects (bump epoch); call
        before the step is built."""
        parsed = self._parse_device_target(target)
        if parsed is None:
            raise ValueError(f"cannot arm non-device target {target!r}")
        if parsed not in self._armed:
            self._armed.add(parsed)
            self.attach_epoch += 1

    def attach_live(self, pid: int, target: str) -> Link:
        """Deprecated shim -- use ``attach(pid, target, mode="table")``."""
        warnings.warn(
            "attach_live() is deprecated; use "
            "attach(pid, target, mode='table')", DeprecationWarning,
            stacklevel=2)
        return self.attach(pid, target, mode="table", promote=False)

    def detach_live(self, link_id) -> None:
        """Deprecated shim -- use ``detach(link)`` / ``link.detach()``."""
        warnings.warn("detach_live() is deprecated; use detach()",
                      DeprecationWarning, stacklevel=2)
        self.detach(link_id)

    def _attach_table(self, pid: int, target: str, promote: bool) -> Link:
        """Attach a loaded+verified program to an already-built step via the
        live table: encode into a free slot, bump the generation counter.
        NO attach_epoch bump -- the caller pushes the new table with
        sync_live_table() and keeps using the same step."""
        if self.live is None:
            raise loader.LoadError("enable_live_attach() was not called "
                                   "before the step was built")
        prog = self.progs[pid]
        parsed = self._parse_device_target(target)
        if parsed is None:
            raise ValueError(f"live attach needs a device target, got "
                             f"{target!r}")
        from .verifier import check_table_encodable
        check_table_encodable(prog.vprog, n_maps=self.live.n_maps,
                              max_insns=self.live.max_insns,
                              ctx_words=self.live.ctx_words)
        slot = self.live.free_slot()
        if slot is None:
            raise loader.LoadError(
                f"live table full ({self.live.max_programs} slots)")
        sid, ev_kind = parsed
        # encoded table images are content-addressed in the fleet artifact
        # cache (setup_shm auto-joins <root>/cache): the daemon fanning an
        # attach out to N workers encodes once, N-1 workers reuse the image
        self.live.encode_slot(slot, prog.vprog, sid, ev_kind, pid=pid,
                              cache=self.artifact_cache)
        lid = next(self._next_link)
        link = Link(lid, pid, target, lane="table", slot=slot,
                    promotion_state="interp", promote=promote,
                    _parsed=parsed, _rt=self)
        self.links[lid] = link
        self._live_slot_of[lid] = slot
        if promote and self._promoter is not None:
            self._promoter.schedule(link)
        self.publish_status()
        return link

    def _table_attachable(self, pid: int, parsed) -> bool:
        """mode="auto" heuristic: route through the live table iff it can
        actually execute the program RIGHT NOW without rebuilding the step
        -- the lane exists, the target site's events are already collected
        (armed or statically attached), a slot is free, and the bytecode is
        encodable. Anything else falls back to the fused (epoch-bump) path,
        which can always host the program."""
        if self.live is None or parsed is None:
            return False
        if parsed not in self.wanted_sites():
            return False               # a built collector never fires it
        if self.live.free_slot() is None:
            return False
        from .verifier import VerifierError, check_table_encodable
        try:
            check_table_encodable(self.progs[pid].vprog,
                                  n_maps=self.live.n_maps,
                                  max_insns=self.live.max_insns,
                                  ctx_words=self.live.ctx_words)
        except VerifierError:
            return False
        return True

    def sync_live_table(self, map_states, force: bool = False):
        """Push the host-side table into the step's device table buffers IN
        PLACE: shapes and buffers are unchanged, so the running step picks
        the new programs up on its next call. The copy reads a fresh host
        snapshot that nothing modifies before it lands (pinned, on the
        current stream). Generation-gated: an idle call (no attach/detach
        since the last sync) returns at once, so a loop can call it every
        step. Promotions that are ready swap in first (a generation
        boundary is a promotion boundary). Unlike JAX, which returns a new
        dict, this returns `map_states` itself with its table written; the
        snapshot of each generation pushed is kept for `live_table_at`."""
        if self.live is None or "__live_table__" not in map_states:
            return map_states
        if self._promoter is not None:
            # clears the promoted links' slots, so the gen check below
            # pushes the new table in the same call
            self._promoter.apply_ready()
        gen = int(self.live.host["gen"][0])
        if not force and gen == self._synced_gen:
            return map_states
        self._synced_gen = gen
        dst = map_states["__live_table__"]["packed"]
        host = torch.from_numpy(self.live.packed())
        if dst.is_cuda:
            host = host.pin_memory()
            dst.copy_(host, non_blocking=True)
        else:
            dst.copy_(host)
        self._record_table(host)
        return map_states

    # ---------------------------------------------------------------- attach
    def attach(self, pid: int, target: str, *, mode: str = "auto",
               promote: bool = True) -> Link:
        """Attach a loaded program; ONE entry point for every lane.

        target: uprobe:SITE | uretprobe:SITE | probe:SITE |
        tracepoint:SYS:enter|exit | filter:SYS

        mode:
          * "auto" (default) -- device targets go through the live table
            when that is free (live lane enabled, site armed/collected,
            slot available, bytecode encodable): instant attach, no
            rebuild; otherwise the fused path (attach_epoch bump -> the
            loop rebuilds its step). Host targets always take the host
            lane.
          * "fused" -- force the epoch-bumping path.
          * "table" -- force the live table; raises if unavailable.

        promote: table-lane links are handed to the promotion engine
        (enable_promotion), which builds the fused-lane step in the
        background and swaps it in at the next generation boundary.
        promote=False pins the link to the interpreter.

        Returns a Link handle (``link.lane``, ``link.promotion_state``,
        ``link.detach()``); it coerces to its integer link id."""
        if mode not in ("auto", "fused", "table"):
            raise ValueError(f"bad attach mode {mode!r}")
        prog = self.progs[pid]
        parsed = self._parse_device_target(target)
        if parsed is None:                               # host lane
            if mode == "table":
                raise ValueError(f"live attach needs a device target, got "
                                 f"{target!r}")
            parts = target.split(":")
            if parts[0] == "tracepoint":
                self.syscalls.attach(parts[1], parts[2], prog.name,
                                     prog.insns, self.map_specs)
            elif parts[0] == "filter":
                self.syscalls.attach(parts[1], "enter", prog.name,
                                     prog.insns, self.map_specs)
            else:
                raise ValueError(f"bad attach target {target!r}")
            lid = next(self._next_link)
            link = Link(lid, pid, target, lane="host", _rt=self)
            self.links[lid] = link
            return link
        if mode == "table" or (mode == "auto"
                               and self._table_attachable(pid, parsed)):
            return self._attach_table(pid, target, promote)
        self.device_attach.setdefault(parsed, []).append(pid)
        self.attach_epoch += 1
        lid = next(self._next_link)
        link = Link(lid, pid, target, lane="fused", _parsed=parsed,
                    _rt=self)
        self.links[lid] = link
        return link

    def detach(self, link) -> None:
        """Detach by Link handle or integer link id (any lane)."""
        link_id = int(link)
        lk = self.links.pop(link_id)
        if lk.lane == "table":
            if lk.promotion_state in ("compiling", "ready"):
                lk.promotion_state = "cancelled"   # promotion backs off
            slot = self._live_slot_of.pop(link_id)
            self.live.clear_slot(slot)
            self.publish_status()
            return
        prog = self.progs[lk.pid]
        parts = lk.target.split(":")
        kind = parts[0]
        if kind in ("uprobe", "uretprobe", "probe"):
            sid, ev_kind = lk._parsed or self._parse_device_target(lk.target)
            lst = self.device_attach.get((sid, ev_kind), [])
            if lk.pid in lst:
                lst.remove(lk.pid)
            if not lst:
                self.device_attach.pop((sid, ev_kind), None)
            self.attach_epoch += 1
        elif kind == "tracepoint":
            self.syscalls.detach(parts[1], parts[2], prog.name)
        elif kind == "filter":
            self.syscalls.detach(parts[1], "enter", prog.name)

    # ---------------------------------------------------------------- cache
    def enable_artifact_cache(self, root: str, max_bytes: int | None = None):
        """Join (or create) a fleet artifact cache directory. Encoded table
        images (attach(mode="table")) are stored under their content key;
        any process sharing the directory reuses them instead of encoding
        again. ``max_bytes`` arms the LRU size budget for long-lived fleets
        (see artifact_cache.py)."""
        from .artifact_cache import ArtifactCache
        self.artifact_cache = ArtifactCache(root, max_bytes=max_bytes)
        return self.artifact_cache

    def layout_fingerprint(self, attach_sig: tuple | None = None,
                           extra: tuple = ()) -> str:
        """Canonical key of a step built against THIS runtime's world: map
        registry (fd order), event-row width, live table dims, plus the
        static attach signature the step's lanes read (defaults to the
        current device_attach)."""
        from . import layout as L
        from .promote import attach_signature
        if attach_sig is None:
            attach_sig = attach_signature(self.device_attach)
        dims = ()
        if self.live is not None:
            dims = (self.live.max_programs, self.live.max_insns,
                    self.live.n_maps, self.live.ctx_words)
        return L.layout_fingerprint(self.map_specs, E.EVENT_WIDTH,
                                    table_dims=dims, attach_sig=attach_sig,
                                    extra=extra)

    def step_key(self, extra_key: tuple, device_type: str) -> str:
        """The cache key of a step exported by `aot_step`: the layout
        fingerprint with the caller's facts, the device type the program
        was traced on and this torch's version, so a program traced on the
        CPU is never served to a card worker, nor one of another torch."""
        return self.layout_fingerprint(extra=(
            *extra_key, "torch.export", device_type, torch.__version__))

    def aot_step(self, build_fn, example_args, extra_key: tuple = ()):
        """Consult-or-export-and-store: the worker cold-join fast path.

        Returns ``(step, hit)``. On a warm cache the stored `torch.export`
        program loads in milliseconds (`ArtifactCache.get_step`); on a miss
        (or with no cache enabled) ``build_fn()`` is traced by
        ``torch.export.export(..., strict=False)`` over ``example_args``
        (tensors or trees of them: the program is specialised to their
        shapes and dtypes) and the program is stored for the next joiner.
        ``extra_key`` folds caller facts the trace also depends on (e.g.
        batch geometry) into the key.

        A step that cannot be traced -- the scan lanes read the tape on the
        host, the live lane's table interpreter is a ctypes launch -- comes
        back as ``(build_fn(), False)``: nothing is stored, the cache counts
        ``unexportable`` and `last_export_error` says why."""
        leaves = [t for t in torch.utils._pytree.tree_leaves(example_args)
                  if isinstance(t, torch.Tensor)]
        key = self.step_key(tuple(extra_key),
                            leaves[0].device.type if leaves else "cpu")
        cache = self.artifact_cache
        if cache is not None:
            step = cache.get_step(key)
            if step is not None:
                return step, True
        fn = build_fn()
        try:
            exported = torch.export.export(_Step(fn), tuple(example_args),
                                           strict=False)
        except Exception as e:      # any trace failure: run it eagerly
            self.last_export_error = f"{type(e).__name__}: {e}"
            if cache is not None:
                cache.counters["unexportable"] += 1
            return fn, False
        if cache is not None:
            cache.put_step(key, exported)
        return exported.module(), False

    # ---------------------------------------------------------------- promote
    def enable_promotion(self, step_builder, example_args,
                         background: bool = True):
        """Arm background promotion of table-lane links.

        step_builder() must return a fresh step built against this
        runtime's current attach state; example_args are the arguments the
        loop calls the step with (kept for the signature: eager PyTorch
        has no ahead-of-time lowering, so they are unused). Existing table
        links attached with promote=True are scheduled immediately.
        background=False builds synchronously inside schedule() --
        deterministic, for tests."""
        from .promote import PromotionEngine
        self._promoter = PromotionEngine(self, step_builder, example_args,
                                         background=background)
        for lk in self.links.values():
            if lk.lane == "table" and lk.promote:
                self._promoter.schedule(lk)
        return self._promoter

    def take_promoted_step(self):
        """Hand the loop the step built by the last promotion (or None).
        Pattern: on attach_epoch change, try this before rebuilding."""
        step, self._promoted_step = self._promoted_step, None
        return step

    def _promote_table_link(self, link: Link, compiled) -> None:
        """The atomic swap, called by PromotionEngine.apply_ready at a
        generation boundary: retire the table slot and install the static
        attachment in one host-side critical section, so the very next
        step executes the program on the fused lane exactly once."""
        slot = self._live_slot_of.pop(link.link_id)
        self.live.clear_slot(slot)              # gen bump -> table resync
        self.device_attach.setdefault(link._parsed, []).append(link.pid)
        self.attach_epoch += 1                  # loop picks a new step
        link.lane, link.slot = "fused", None
        link.promotion_state = "fused"
        self._promoted_step = compiled
        self.publish_status()

    @contextlib.contextmanager
    def _attach_overlay(self, extra: dict):
        """Thread-locally overlay extra device attachments -- the promotion
        engine builds the FUTURE attach state through this while the
        foreground step keeps seeing the present."""
        prev = getattr(self._overlay_tls, "extra", None)
        self._overlay_tls.extra = extra
        try:
            yield
        finally:
            self._overlay_tls.extra = prev

    def _effective_attach(self) -> dict:
        extra = getattr(self._overlay_tls, "extra", None)
        if not extra:
            return self.device_attach
        merged = {k: list(v) for k, v in self.device_attach.items()}
        for k, pids in extra.items():
            merged.setdefault(k, []).extend(pids)
        return merged

    # ---------------------------------------------------------------- device
    def wanted_sites(self) -> set[tuple[int, int]]:
        return set(self._effective_attach().keys()) | self._armed

    def collector(self, stats_fn=None) -> E.Collector:
        return E.Collector(self.wanted_sites(), stats_fn=stats_fn)

    def probe_stage(self, event_rows, map_states, aux, mode=None):
        """Run all attached device programs over the step's event tape.
        event_rows: i64[N, 16] on the device of `map_states`.

        'fused' (default) makes ONE pass over the tape: all vector-safe
        programs across all attachments share a single shadow pass whose
        per-program validity is folded into the entry predicate, with side
        effects applied once per call site; the remaining programs share one
        combined scan. 'scan' / 'vectorized' keep the per-attachment
        behaviour (oracle for differential tests). Map states are never
        written in place: new states are returned.

        When the live lane is enabled, a third stage runs after the static
        lanes: one launch of the table interpreter over the tape, whatever
        the synced `__live_table__` holds (the host never reads it)."""
        mode = mode or self.exec_mode
        table = None
        if "__live_table__" in map_states:
            table = map_states["__live_table__"]
            map_states = {k: v for k, v in map_states.items()
                          if k != "__live_table__"}
        map_states, aux = self._static_lanes(event_rows, map_states, aux,
                                             mode)
        if table is not None:
            if self.live is not None and event_rows.shape[0] > 0:
                map_states, aux = self.live.run(table, event_rows,
                                                map_states, aux)
            map_states = {**map_states, "__live_table__": table}
        return map_states, aux

    def _static_lanes(self, event_rows, map_states, aux, mode):
        # a promotion builds through a thread-local overlay that already
        # contains the link being promoted (see _attach_overlay)
        device_attach = self._effective_attach()
        if event_rows.shape[0] == 0 or not device_attach:
            return map_states, aux
        if mode == "fused":
            # ordering guard: distinct programs sharing state
            # non-commutatively (ringbuf streams, rw maps, override/printk/
            # rand aux) would observe a different interleaving across the
            # fused lanes than under the per-attachment order -- fall back to
            # scan mode for exactness (rare; typical instrumentation uses
            # disjoint or fetch-add/hist maps).
            uniq = {pid: self.progs[pid].vprog
                    for pids in device_attach.values() for pid in pids}
            n_attach = {pid: sum(pids.count(pid)
                                 for pids in device_attach.values())
                        for pid in uniq}
            # multi-attached scan-lane programs also lose per-attachment
            # order in the combined scan (the vector lane preserves it)
            self_conflict = any(
                n_attach[pid] > 1 and not V.is_vector_safe(vp)
                and any(not c for c in _ordering_resources(vp).values())
                for pid, vp in uniq.items())
            if not self_conflict and \
                    not _has_ordering_conflict(list(uniq.values())):
                vec, rest = [], []
                for (sid, kind), pids in sorted(device_attach.items()):
                    for pid in pids:
                        vprog = self.progs[pid].vprog
                        lane = vec if V.is_vector_safe(vprog) else rest
                        lane.append((sid, kind, vprog))
                if vec:
                    map_states, aux = V.run_fused_vector(
                        vec, event_rows, map_states, aux)
                if rest:
                    map_states, aux = J.run_fused_scan(
                        rest, event_rows, map_states, aux)
                return map_states, aux
            mode = "scan"
        for (sid, kind), pids in sorted(device_attach.items()):
            valid = ((event_rows[:, 0] == sid) &
                     (event_rows[:, 1] == kind))
            for pid in pids:
                vprog = self.progs[pid].vprog
                if mode == "vectorized" and V.is_vector_safe(vprog):
                    map_states, aux = V.run_vectorized(
                        vprog, event_rows, valid, map_states, aux)
                    continue
                _, map_states, aux = J.run_over_events(
                    vprog, event_rows, valid, map_states, aux)
        return map_states, aux

    # ---------------------------------------------------------------- shm
    def setup_shm(self, root: str, worker_id: str | None = None,
                  group: str | None = None):
        """Join the shm control plane. worker_id=None keeps the
        single-process layout; a worker id places this process's device
        snapshots, host maps, and control queue under
        `<root>/workers/<wid>/` so a fleet daemon can aggregate N such
        processes into one global view. `group` names the node aggregator
        that folds this worker in a hierarchical fleet -- the node claims
        its group members dynamically, so the worker may join before or
        after its node boots. The step stays on its device."""
        import os
        from .shm import ShmRegion
        self.shm = ShmRegion.create(root, self.map_specs,
                                    worker_id=worker_id, group=group)
        # host maps become shm-backed (live for the daemon)
        for spec in self.map_specs:
            self.host_maps[spec.name] = self.shm.host[spec.name]
        for name, obj_json in self._objects.items():
            self.shm.publish_program(obj_json, name)
        # every fleet member shares one artifact cache next to the shm
        # plane -- the Nth joiner reuses the first joiner's table images
        if self.artifact_cache is None:
            self.enable_artifact_cache(os.path.join(root, "cache"))
        self.publish_status()
        return self.shm

    def publish(self, map_states) -> None:
        """Seqlocked snapshot of the device map states into the shm region,
        through sys_shm_publish: one host copy of all of them (`to_numpy`,
        which leaves out the live table). A no-op without shm."""
        if self.shm is None:
            return
        host_states = to_numpy(map_states)
        self.syscalls.invoke(
            "sys_shm_publish", [len(map_states)],
            impl=lambda: self.shm.publish_device(host_states))

    def poll_control(self) -> list[dict]:
        """Pick up daemon attach/detach/load requests (between steps).
        Everything routes through the unified attach(): requests carry
        "mode" ("auto"/"fused"/"table") and "promote"; legacy requests
        with "live": true map to mode="table" (the running step picks them
        up after the loop calls sync_live_table()), legacy requests without
        either map to mode="fused" (the epoch-bumping path). Each applied
        load_attach reports the assigned link id, lane, and promotion
        state so the daemon can detach/confirm it later. A request that
        fails is reported with its "error", never raised."""
        if self.shm is None:
            return []
        reqs, self._req_cursor = self.shm.poll_requests(self._req_cursor)
        applied = []
        for r in reqs:
            try:
                if r["op"] == "load_attach":
                    obj = ProgramObject.from_json(r["object"])
                    pid = self.load_object(obj)
                    tgt = r.get("target") or obj.attach_to
                    mode = r.get("mode") or ("table" if r.get("live")
                                             else "fused")
                    # missing "promote" (hand-rolled/legacy request) pins
                    # the link to its lane -- promotion is strictly opt-in
                    # over the wire
                    link = self.attach(pid, tgt, mode=mode,
                                       promote=bool(r.get("promote", False)))
                    applied.append({**r, "link_id": int(link),
                                    "lane": link.lane,
                                    "promotion": link.promotion_state})
                    continue
                elif r["op"] == "detach":
                    self.detach(int(r["link_id"]))
                applied.append(r)
            except Exception as e:  # control plane must not kill training
                applied.append({**r, "error": str(e)})
        if applied:     # idle polls stay a pure request-counter read
            self.publish_status()
        return applied

    def publish_status(self) -> None:
        """Expose the control plane's view to the daemon: live-table
        generation + active links, so a requester can confirm its program
        went live (or was rejected) without attaching a debugger."""
        if self.shm is None:
            return
        import os
        self.shm.publish_status({
            "worker_id": self.shm.worker_id,
            "pid": os.getpid(),
            "attach_epoch": self.attach_epoch,
            "live_gen": int(self.live.host["gen"][0]) if self.live else 0,
            "live_slots": ({str(p): (self.progs[pid].name
                                     if pid is not None else None)
                            for p, pid in enumerate(self.live.slot_pid)}
                           if self.live else {}),
            "links": {str(lid): lk.target for lid, lk in self.links.items()},
            "promotions": {str(lid): {"lane": lk.lane,
                                      "state": lk.promotion_state}
                           for lid, lk in self.links.items()},
            "cache": (dict(self.artifact_cache.counters)
                      if self.artifact_cache is not None else {}),
        })

    # ---------------------------------------------------------------- misc
    def ringbuf_drain(self, map_states, name: str, cursor: int):
        st = {f: a.cpu().numpy() for f, a in map_states[name].items()}
        return M.n_ringbuf_drain(st, cursor)

    def hist_snapshot(self, map_states, name: str):
        return map_states[name]["bins"].cpu().numpy()


def to_numpy(map_states) -> dict:
    """{map: {field: numpy array}} copy of a device map state (the live
    table, `__live_table__`, is not a map and is left out)."""
    return {name: {f: a.detach().to("cpu", copy=True).numpy()
                   for f, a in st.items()}
            for name, st in map_states.items() if name != "__live_table__"}
