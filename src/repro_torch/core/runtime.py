"""BpftimeRuntime -- the runtime manager (bpftime's agent + syscall-compat
library rolled into one), device half for PyTorch.

Responsibilities:
  * global map registry (create/bind by name -- objects share maps by name);
  * program load: relocate (CO-RE-lite) -> verify -> store;
  * attachments:
      device:  uprobe:SITE / uretprobe:SITE / probe:SITE   (in the step)
      host:    tracepoint:SYS:enter|exit / filter:SYS      (interpreter)
  * the per-step probe-execution stage, run on the device inside the
    train/serve step; every device attach/detach bumps `attach_epoch`.

Not in this package yet: the live program-table lane, background
promotion, the artifact cache and the shm control plane. Their entry
points raise NotImplementedError; `publish` and `poll_control` are no-ops
while no shm region is set up.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass, field

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

_LATER = {
    "live": "the live program-table lane comes with the live-lane slice",
    "promote": "background promotion comes with the live-lane slice",
    "cache": "the AOT artifact cache comes with the live-lane slice",
    "shm": "the shm control plane comes with the fleet slice",
}


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


@dataclass(eq=False)
class Link:
    """Handle for one attachment. ``lane`` is ``"fused"`` (run in the step)
    or ``"host"`` (syscall tracepoints/filters). The handle coerces to its
    integer link id, so it can be passed back to ``Runtime.detach``."""
    link_id: int
    pid: int
    target: str
    lane: str = "fused"
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
        # the live lane, background promotion and the artifact cache come
        # with later slices; the training loop reads these as the JAX
        # runtime's
        self.live = None
        self.artifact_cache = None
        self._promoter = None
        # 'fused' (default): single-pass multi-program dispatch;
        # 'scan' / 'vectorized': the per-attachment paths.
        self.exec_mode = "fused"

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
        """Zeroed device state of every registered map, on `device`."""
        return M.init_states(self.map_specs, device)

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

    # ---------------------------------------------------------------- attach
    @staticmethod
    def _parse_device_target(target: str):
        """(site_id, event_kind) for a device target, None for host targets."""
        parts = target.split(":")
        if parts[0] not in ("uprobe", "uretprobe", "probe"):
            return None
        ev_kind = {"uprobe": E.KIND_ENTRY, "uretprobe": E.KIND_EXIT,
                   "probe": E.KIND_TRACEPOINT}[parts[0]]
        return E.SITES.get_or_create(parts[1]), ev_kind

    def attach(self, pid: int, target: str, *, mode: str = "auto",
               promote: bool = False) -> Link:
        """Attach a loaded program.

        target: uprobe:SITE | uretprobe:SITE | probe:SITE |
        tracepoint:SYS:enter|exit | filter:SYS

        mode "auto" and "fused" put a device target on the fused lane (an
        attach_epoch bump); host targets take the host lane. mode "table"
        and promote=True need the live lane, which this package does not
        have yet."""
        if mode not in ("auto", "fused", "table"):
            raise ValueError(f"bad attach mode {mode!r}")
        if mode == "table":
            raise NotImplementedError(_LATER["live"])
        if promote:
            raise NotImplementedError(_LATER["promote"])
        prog = self.progs[pid]
        parsed = self._parse_device_target(target)
        lid = next(self._next_link)
        if parsed is None:                               # host lane
            parts = target.split(":")
            if parts[0] == "tracepoint":
                self.syscalls.attach(parts[1], parts[2], prog.name,
                                     prog.insns, self.map_specs)
            elif parts[0] == "filter":
                self.syscalls.attach(parts[1], "enter", prog.name,
                                     prog.insns, self.map_specs)
            else:
                raise ValueError(f"bad attach target {target!r}")
            link = Link(lid, pid, target, lane="host", _rt=self)
        else:
            self.device_attach.setdefault(parsed, []).append(pid)
            self.attach_epoch += 1
            link = Link(lid, pid, target, lane="fused", _parsed=parsed,
                        _rt=self)
        self.links[lid] = link
        return link

    def detach(self, link) -> None:
        """Detach by Link handle or integer link id."""
        lk = self.links.pop(int(link))
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

    # ---------------------------------------------------------------- later
    def enable_live_attach(self, *args, **kwargs):
        raise NotImplementedError(_LATER["live"])

    def arm_site(self, target: str) -> None:
        raise NotImplementedError(_LATER["live"])

    def sync_live_table(self, map_states, force: bool = False):
        """Push a live-table change onto the running step. With no live
        lane (always, in this package so far) the states come back
        untouched, as in the JAX runtime."""
        if self.live is None:
            return map_states
        raise NotImplementedError(_LATER["live"])

    def take_promoted_step(self):
        """The step a background promotion compiled, if one is ready:
        never, without promotion."""
        return None

    def enable_promotion(self, *args, **kwargs):
        raise NotImplementedError(_LATER["promote"])

    def enable_artifact_cache(self, *args, **kwargs):
        raise NotImplementedError(_LATER["cache"])

    def setup_shm(self, *args, **kwargs):
        raise NotImplementedError(_LATER["shm"])

    # ---------------------------------------------------------------- device
    def wanted_sites(self) -> set[tuple[int, int]]:
        return set(self.device_attach.keys())

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
        written in place: new states are returned."""
        return self._static_lanes(event_rows, map_states, aux,
                                  mode or self.exec_mode)

    def _static_lanes(self, event_rows, map_states, aux, mode):
        device_attach = self.device_attach
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
    def publish(self, map_states) -> None:
        if self.shm is None:
            return
        raise NotImplementedError(_LATER["shm"])

    def poll_control(self) -> list[dict]:
        if self.shm is None:
            return []
        raise NotImplementedError(_LATER["shm"])

    # ---------------------------------------------------------------- misc
    def ringbuf_drain(self, map_states, name: str, cursor: int):
        st = {f: a.cpu().numpy() for f, a in map_states[name].items()}
        return M.n_ringbuf_drain(st, cursor)

    def hist_snapshot(self, map_states, name: str):
        return map_states[name]["bins"].cpu().numpy()


def to_numpy(map_states) -> dict:
    """{map: {field: numpy array}} copy of a device map state."""
    return {name: {f: a.detach().cpu().numpy() for f, a in st.items()}
            for name, st in map_states.items()}

