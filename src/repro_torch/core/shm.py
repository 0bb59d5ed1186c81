"""mmap-backed shared-memory control plane — bpftime's shm maps + daemon
handshake, adapted to the host side of a trainer and server fleet.

Layout under a shm directory (SP3 segregation: program text, device-map
snapshots, and host-map data live in separate sections; the agent may write
only map-data sections — enforced here by API shape, in production by file
permissions, see DESIGN.md §5):

    <dir>/meta.json                 map specs + layout (written once, shared)
    <dir>/progs/<name>.json         program objects (read-only to agents)

Single-process layout (worker_id=None — the seed shape, unchanged):

    <dir>/host/<map>.<field>.npy    live host-side maps (memmapped, rw)
    <dir>/device/<map>.<field>.npy  per-step snapshots of device maps
    <dir>/device/.seq.npy           seqlock (odd while a publish is in flight)
    <dir>/control/requests.json     daemon -> trainer attach/detach requests
    <dir>/control/.reqseq.npy       request counter
    <dir>/control/status.json       trainer -> daemon control-plane status

Fleet layout (worker_id="w0", "w1", ... — DESIGN.md §10): every worker owns
the SAME section tree under its own base, so one daemon can observe N
train/serve processes as one system:

    <dir>/workers/<wid>/worker.json  pid + boot id (liveness / restart detect)
    <dir>/workers/<wid>/{host,device,control}/...   as above, per worker
    <dir>/global/<map>.<field>.npy   daemon-merged view of the whole fleet
    <dir>/global/.seq.npy            seqlock for the merged view
    <dir>/global/status.json         aggregation status (alive/dead workers,
                                     per-worker heads, merge stats)
"""
from __future__ import annotations

import json
import os
import time
import uuid
import zlib
from dataclasses import dataclass

import numpy as np

from . import faults, maps as M
from .maps import MapKind, MapSpec


class SnapshotCorruption(Exception):
    """A seqlocked section read consistently (even, stable seq) but its
    payload does not match the checksum the publisher wrote: the bytes were
    damaged AFTER the publish. Detect-and-skip, never silent-merge."""


def _memmap(path, shape, mode):
    if mode == "w+":
        return np.lib.format.open_memmap(path, mode="w+", dtype=np.int64,
                                         shape=shape)
    return np.lib.format.open_memmap(path, mode=mode)


def _atomic_json(path: str, obj) -> None:
    tmp = f"{path}.{os.getpid()}.tmp"
    # dumps + one write: json.dump streams thousands of tiny writes per
    # fleet journal, which dominates hot aggregation cycles
    buf = json.dumps(obj)
    with open(tmp, "w") as f:
        f.write(buf)
    os.replace(tmp, path)          # atomic for concurrent readers/writers


def _specs_to_meta(specs: list[MapSpec]) -> dict:
    return {"specs": [{"name": s.name, "kind": s.kind.value,
                       "max_entries": s.max_entries,
                       "rec_width": s.rec_width,
                       "num_shards": s.num_shards,
                       "flags": s.flags} for s in specs],
            "version": 2}


def _specs_from_meta(meta: dict) -> list[MapSpec]:
    return [MapSpec(name=m["name"], kind=MapKind(m["kind"]),
                    max_entries=m["max_entries"],
                    rec_width=m["rec_width"],
                    num_shards=m["num_shards"],
                    flags=m.get("flags", {})) for m in meta["specs"]]


def read_meta_specs(root: str) -> list[MapSpec]:
    with open(os.path.join(root, "meta.json")) as f:
        return _specs_from_meta(json.load(f))


def _worker_base(root: str, worker_id: str | None) -> str:
    if worker_id is None:
        return root
    return os.path.join(root, "workers", str(worker_id))


# --------------------------------------------------------------------------
# seqlocked field sections (shared by per-worker device dirs and global/)
# --------------------------------------------------------------------------

def _create_section(dirpath: str, specs: list[MapSpec]) -> dict:
    """Create (or re-create, on worker restart) a section's field files.
    Existing files are reused IN PLACE ('r+', zeroed) rather than
    truncated: a live reader's mmap of the same inode keeps working and
    simply observes the zeroed state — open_memmap('w+') would shrink the
    inode to 0 bytes for a moment, turning a concurrent read into SIGBUS."""
    os.makedirs(dirpath, exist_ok=True)
    out = {}
    for s in specs:
        tmpl = M.init_state_np(s)
        out[s.name] = {}
        for field, arr in tmpl.items():
            path = os.path.join(dirpath, f"{s.name}.{field}.npy")
            if os.path.exists(path):
                mm = _memmap(path, None, "r+")
            else:
                mm = _memmap(path, arr.shape, "w+")
            mm[...] = 0
            out[s.name][field] = mm
    return out


def _attach_section(dirpath: str, specs: list[MapSpec], mode: str) -> dict:
    out = {}
    for s in specs:
        out[s.name] = {}
        for field in M.init_state_np(s):
            out[s.name][field] = _memmap(
                os.path.join(dirpath, f"{s.name}.{field}.npy"), None, mode)
    return out


def _crc_of(state: dict) -> int:
    """CRC32 over a map state's field bytes, fields in sorted order — the
    per-section corruption check written under the seqlock."""
    c = 0
    for f in sorted(state):
        c = zlib.crc32(np.ascontiguousarray(state[f]).tobytes(), c)
    return c


def _crc_path(dirpath: str) -> str:
    return os.path.join(dirpath, ".crc.npy")


def _crc_create(dirpath: str, n: int) -> np.memmap:
    p = _crc_path(dirpath)
    crc = _memmap(p, None, "r+") if os.path.exists(p) \
        else _memmap(p, (n,), "w+")
    crc[...] = 0
    crc.flush()
    return crc


def _crc_attach(dirpath: str, mode: str) -> np.memmap | None:
    p = _crc_path(dirpath)
    if not os.path.exists(p):
        return None              # pre-checksum region: no validation
    return _memmap(p, None, "r+" if mode != "r" else "r")


# Seqlock backoff defaults (satellite: configurable via AggregatorConfig).
# First retry sleeps BACKOFF_BASE, doubling up to BACKOFF_MAX per attempt:
# the common one-publish-in-flight case resolves in ~50us instead of the
# old fixed 1ms, while a genuinely stuck writer still costs at most
# retries * BACKOFF_MAX before TimeoutError.
BACKOFF_BASE = 5e-5
BACKOFF_MAX = 0.01


def _seq_publish(seq: np.memmap, section: dict, states: dict,
                 crc: np.memmap | None = None,
                 order: list[str] | None = None,
                 role: str = "worker") -> None:
    # parity self-heal: an odd seq here means a prior publisher died (or
    # injected-crashed) mid-publish — we are already "in flight", so don't
    # flip again; completing this publish returns the section to even with
    # fully consistent contents
    # NO msync in the hot path: MAP_SHARED readers on the same host see
    # these stores through the unified page cache immediately — msync only
    # forces disk writeback, and crash durability is the JOURNAL's job
    # (the view is rebuilt from it on restart). Consistency comes from seq
    # parity + the CRC sidecar, never from flush ordering.
    if int(seq[0]) % 2 == 0:
        seq[0] += 1          # odd: write in flight
    # role tags who is publishing: worker-side fault classes (torn/stuck/
    # corrupt/kill/slow) only target "worker" publishes — daemon failures
    # are modeled by the agg:* crash schedule, not by tearing the global
    # view's own seqlocked publish
    faults.fire("shm:publish_begin", role=role)
    for name, st in states.items():
        if name not in section:
            continue
        for field, arr in st.items():
            faults.fire("shm:publish_field", map=name, field=field,
                        role=role)
            section[name][field][...] = np.asarray(arr)
    if crc is not None:
        # recomputed from SECTION content (not `states`): maps skipped
        # this publish keep a checksum matching what is actually on disk
        for i, name in enumerate(order):
            crc[i] = _crc_of(section[name])
    faults.fire("shm:publish_commit", section=section, role=role)
    seq[0] += 1          # even: consistent


def _seq_snapshot(seq: np.memmap, section: dict, name: str, retries: int,
                  backoff_base: float = BACKOFF_BASE,
                  backoff_max: float = BACKOFF_MAX,
                  crc: np.memmap | None = None,
                  crc_idx: int | None = None) -> tuple[dict, int, int]:
    """Returns (state, seq_observed, retries_used). A successful read always
    observes an EVEN sequence number, unchanged across the copy, and (when
    the section carries checksums) a payload matching the publisher's CRC.
    Retries back off exponentially from backoff_base to backoff_max."""
    faults.fire("shm:snapshot_begin", name=name)
    delay = backoff_base
    for attempt in range(retries):
        s0 = int(seq[0])
        if s0 % 2 == 0:
            out = {f: np.array(a) for f, a in section[name].items()}
            want = int(crc[crc_idx]) if crc is not None else None
            if int(seq[0]) == s0:
                # seq 0 = never published: the zeroed crc array is not the
                # crc of the zeroed section, so validation starts at the
                # first real publish
                if want is not None and s0 > 0 and _crc_of(out) != want:
                    raise SnapshotCorruption(
                        f"{name}: checksum mismatch at seq {s0}")
                return out, s0, attempt
        time.sleep(delay)
        delay = min(delay * 2, backoff_max)
    raise TimeoutError("seqlock retry budget exceeded")


@dataclass
class ShmRegion:
    root: str
    specs: list[MapSpec]
    host: dict          # name -> {field: memmap}
    device: dict
    seq: np.memmap
    reqseq: np.memmap
    worker_id: str | None = None
    base: str = ""      # section base dir: root, or root/workers/<wid>
    crc: np.memmap | None = None   # device-section checksums (sorted names)

    @property
    def _order(self) -> list[str]:
        return sorted(s.name for s in self.specs)

    # ---------------------------------------------------------------- create
    @staticmethod
    def create(root: str, specs: list[MapSpec],
               worker_id: str | None = None,
               group: str | None = None) -> "ShmRegion":
        base = _worker_base(root, worker_id)
        os.makedirs(os.path.join(root, "progs"), exist_ok=True)
        os.makedirs(os.path.join(base, "control"), exist_ok=True)
        # meta.json is shared and created atomically + EXCLUSIVELY
        # (os.link fails on an existing target), so concurrently launching
        # workers race safely: exactly one spec set lands, every other
        # worker must agree with it
        meta_path = os.path.join(root, "meta.json")
        tmp = f"{meta_path}.{os.getpid()}.link.tmp"   # distinct from
        with open(tmp, "w") as f:                     # _atomic_json's tmp
            json.dump(_specs_to_meta(specs), f)
        try:
            os.link(tmp, meta_path)
        except FileExistsError:
            prior = read_meta_specs(root)
            # dataclass equality covers every field, flags included —
            # flags are load-bearing (step_lane drives the global ringbuf
            # interleave), so a silent mismatch would change merge
            # semantics
            if prior != list(specs):
                if worker_id is not None:
                    raise ValueError(
                        f"shm region {root} already holds incompatible "
                        f"specs")
                # single-process layout: one creator by construction, so a
                # re-run with evolved specs rebuilds the region (the seed
                # behavior) instead of demanding a manual delete; stale
                # section files go first — their shapes may not match
                _atomic_json(meta_path, _specs_to_meta(specs))
                for sub in ("host", "device"):
                    d = os.path.join(base, sub)
                    if os.path.isdir(d):
                        for fn in os.listdir(d):
                            if fn.endswith(".npy") and \
                                    not fn.startswith("."):
                                os.unlink(os.path.join(d, fn))
        finally:
            os.unlink(tmp)
        host = _create_section(os.path.join(base, "host"), specs)
        # the device section is (re-)zeroed UNDER its seqlock: on a worker
        # restart a live reader (the aggregator) must never observe a torn
        # mix, and the counter restarting at 0 is exactly the aggregator's
        # SeqRegression signal
        os.makedirs(os.path.join(base, "device"), exist_ok=True)
        seq_path = os.path.join(base, "device", ".seq.npy")
        if os.path.exists(seq_path):
            seq = _memmap(seq_path, None, "r+")
            if int(seq[0]) % 2 == 0:
                seq[0] += 1            # mark in-flight before zeroing
                seq.flush()
        else:
            seq = _memmap(seq_path, (1,), "w+")
            seq[0] = 1
            seq.flush()
        device = _create_section(os.path.join(base, "device"), specs)
        # checksums (re-)zeroed inside the same odd window; seq restarting
        # at 0 tells readers validation begins at the first publish
        crc = _crc_create(os.path.join(base, "device"), len(specs))
        seq[0] = 0
        seq.flush()
        # control-queue reset under the same flock _queue_request takes,
        # so a restart doesn't race a concurrent request writer
        import fcntl
        with open(os.path.join(base, "control", ".requests.lock"),
                  "w") as lk:
            fcntl.flock(lk, fcntl.LOCK_EX)
            reqseq_path = os.path.join(base, "control", ".reqseq.npy")
            reqseq = (_memmap(reqseq_path, None, "r+")
                      if os.path.exists(reqseq_path)
                      else _memmap(reqseq_path, (1,), "w+"))
            reqseq[0] = 0
            reqseq.flush()
            _atomic_json(os.path.join(base, "control", "requests.json"), [])
        if worker_id is not None:
            # liveness + restart detection for the aggregation engine.
            # pid_start (the kernel's process start tick) distinguishes THIS
            # process from a later one the OS handed the same pid — the
            # pid-reuse hazard in dead-worker harvest
            info = {"worker_id": str(worker_id), "pid": os.getpid(),
                    "pid_start": _pid_start(os.getpid()),
                    "boot": uuid.uuid4().hex,
                    "started_at": time.time()}
            if group is not None:
                # aggregation-group membership: the node aggregator named
                # `group` claims this worker (tree fold path)
                info["group"] = str(group)
            _atomic_json(os.path.join(base, "worker.json"), info)
            # registration contract for the list_workers cache: the
            # worker.json may land inside an ALREADY-existing subdir
            # (restart), which would not touch workers/ — bump it so
            # aggregators' cached listings see the newcomer
            os.utime(os.path.join(root, "workers"))
        return ShmRegion(root, specs, host, device, seq, reqseq,
                         worker_id=worker_id, base=base, crc=crc)

    # ---------------------------------------------------------------- attach
    @staticmethod
    def attach(root: str, mode: str = "r+",
               worker_id: str | None = None) -> "ShmRegion":
        specs = read_meta_specs(root)
        base = _worker_base(root, worker_id)
        host = _attach_section(os.path.join(base, "host"), specs, mode)
        device = _attach_section(os.path.join(base, "device"), specs, "r")
        seq = _memmap(os.path.join(base, "device", ".seq.npy"), None, "r+")
        reqseq = _memmap(os.path.join(base, "control", ".reqseq.npy"),
                         None, "r+")
        crc = _crc_attach(os.path.join(base, "device"), mode)
        return ShmRegion(root, specs, host, device, seq, reqseq,
                         worker_id=worker_id, base=base, crc=crc)

    # ---------------------------------------------------------------- publish
    def publish_device(self, states: dict) -> None:
        """Seqlocked snapshot of (host-fetched) device map states."""
        _seq_publish(self.seq, self.device, states,
                     crc=self.crc, order=self._order)

    def snapshot_device(self, name: str, retries: int = 100,
                        backoff_base: float = BACKOFF_BASE,
                        backoff_max: float = BACKOFF_MAX) -> dict:
        out, _, _ = self.snapshot_device_meta(
            name, retries=retries, backoff_base=backoff_base,
            backoff_max=backoff_max)
        return out

    def snapshot_device_meta(self, name: str, retries: int = 100,
                             backoff_base: float = BACKOFF_BASE,
                             backoff_max: float = BACKOFF_MAX,
                             ) -> tuple[dict, int, int]:
        """(state, seq_observed, retries_used) — the torn-read test surface:
        seq_observed is always even on a successful read."""
        return _seq_snapshot(
            self.seq, self.device, name, retries,
            backoff_base=backoff_base, backoff_max=backoff_max,
            crc=self.crc,
            crc_idx=self._order.index(name) if self.crc is not None
            else None)

    # ---------------------------------------------------------------- progs
    def publish_program(self, obj_json: str, name: str) -> None:
        with open(os.path.join(self.root, "progs", f"{name}.json"), "w") as f:
            f.write(obj_json)

    def read_programs(self) -> dict[str, str]:
        return read_programs(self.root)

    # ---------------------------------------------------------------- status
    def publish_status(self, status: dict) -> None:
        """trainer side: publish the control plane's state (live-table
        generation, active links) for daemons to poll."""
        _atomic_json(os.path.join(self.base, "control", "status.json"),
                     status)

    def read_status(self) -> dict:
        p = os.path.join(self.base, "control", "status.json")
        if not os.path.exists(p):
            return {}
        with open(p) as f:
            return json.load(f)

    # ---------------------------------------------------------------- control
    def request(self, req: dict) -> None:
        """daemon side: queue an attach/detach/load request."""
        _queue_request(self.base, req, reqseq=self.reqseq)

    def poll_requests(self, last_seen: int) -> tuple[list[dict], int]:
        """trainer side: fetch requests newer than last_seen."""
        cur = int(self.reqseq[0])
        if cur == last_seen:
            return [], last_seen
        p = os.path.join(self.base, "control", "requests.json")
        with open(p) as f:
            reqs = json.load(f)
        return reqs[last_seen:cur], cur


# --------------------------------------------------------------------------
# fleet helpers (worker discovery, liveness, request fan-out)
# --------------------------------------------------------------------------

def read_programs(root: str) -> dict[str, str]:
    """Program objects published to the shared progs/ section — layout-
    independent (works for both single-process and fleet trees)."""
    d = os.path.join(root, "progs")
    out = {}
    if not os.path.isdir(d):
        return out
    for fn in sorted(os.listdir(d)):
        if fn.endswith(".json"):
            with open(os.path.join(d, fn)) as f:
                out[fn[:-5]] = f.read()
    return out


# worker-listing cache keyed by the workers/ dir stat. Sound because every
# membership change bumps the dir mtime: subdir create/remove does so via
# the kernel, and late worker.json registration inside an existing subdir
# does so via the explicit os.utime in ShmRegion.create. Content changes
# to an existing worker.json don't alter the NAME list, so they need no
# invalidation here (worker_info has its own per-file stat key).
_workers_list_cache: dict[str, tuple] = {}


def list_workers(root: str) -> list[str]:
    d = os.path.join(root, "workers")
    try:
        st = os.stat(d)
    except OSError:
        return []
    key = (st.st_ino, st.st_mtime_ns)
    hit = _workers_list_cache.get(d)
    # 100ms settle window: dir mtimes tick on the kernel's COARSE clock,
    # so two registrations inside one tick can alias to the same
    # mtime_ns. A recently-modified dir is re-listed until it quiesces.
    if (hit is not None and hit[0] == key
            and time.time() * 1e9 - st.st_mtime_ns > 1e8):
        return list(hit[1])
    out = sorted(w for w in os.listdir(d)
                 if os.path.exists(os.path.join(d, w, "worker.json")))
    _workers_list_cache[d] = (key, out)
    return out


# registry-file parse cache keyed by (inode, mtime_ns, size): every writer
# goes through _atomic_json (tmp + rename -> fresh inode), so a key match
# is an exact content match. Hot aggregator loops re-validate each
# worker.json/node.json with one stat per read instead of re-parsing —
# a 32-worker tree otherwise parses every registry file several times per
# cycle (group scans + boot checks + liveness).
_registry_cache: dict[str, tuple] = {}


def _cached_registry_json(path: str) -> dict:
    st = os.stat(path)
    key = (st.st_ino, st.st_mtime_ns, st.st_size)
    hit = _registry_cache.get(path)
    if hit is not None and hit[0] == key:
        return hit[1]
    with open(path) as f:
        data = json.load(f)
    _registry_cache[path] = (key, data)
    return data


def worker_info(root: str, worker_id: str) -> dict:
    p = os.path.join(_worker_base(root, worker_id), "worker.json")
    # shallow copy: callers mutate the result (update_node_workers), the
    # cached parse must stay pristine
    return dict(_cached_registry_json(p))


def workers_in_group(root: str, group: str) -> list[str]:
    """Workers that registered with this aggregation group (the
    `--worker-group` a trainer joins with): a node aggregator claims its
    group's members dynamically, so workers may start after their node."""
    out = []
    for wid in list_workers(root):
        try:
            if worker_info(root, wid).get("group") == group:
                out.append(wid)
        except (OSError, ValueError):
            continue
    return out


def _pid_start(pid: int) -> str | None:
    """The kernel's start tick for `pid` (/proc/<pid>/stat field 22) — a
    (pid, start) pair names one process incarnation uniquely, so pid reuse
    after a worker's death is detectable. None where /proc is unreadable
    (worker_alive falls back to the plain existence check)."""
    try:
        with open(f"/proc/{pid}/stat", "rb") as f:
            stat = f.read().decode("latin-1")
        # comm may contain spaces/parens: fields resume after the LAST ')'
        rest = stat[stat.rindex(")") + 2:].split()
        return rest[19]          # field 22, 1-indexed
    except (OSError, ValueError, IndexError):
        return None


# pidfd liveness cache: (pid, registered_start) -> pidfd. A pidfd pins ONE
# process incarnation — the fd turns readable exactly when that process
# (and only that one: a recycled pid cannot alias an open fd) exits — so
# steady-state liveness is a zero-timeout poll instead of a per-cycle
# /proc/<pid>/stat parse. Falls back to the /proc path where pidfd_open
# is unavailable.
_pidfd_cache: dict[tuple, int] = {}
_PIDFD_OK = hasattr(os, "pidfd_open")


def _pid_incarnation_alive(pid: int, registered: str | None) -> bool:
    key = (pid, registered)
    fd = _pidfd_cache.get(key)
    if fd is not None:
        import select
        r, _, _ = select.select([fd], [], [], 0)
        if r:
            os.close(fd)
            del _pidfd_cache[key]
            return False
        return True
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return False
    except PermissionError:      # exists, owned by someone else
        pass
    if registered is not None:
        current = _pid_start(pid)
        if current is not None and current != registered:
            return False         # pid reused by a different process
    if _PIDFD_OK and registered is not None:
        if len(_pidfd_cache) > 512:   # restart-churn bound: drop and re-pin
            for old in _pidfd_cache.values():
                os.close(old)
            _pidfd_cache.clear()
        try:
            fd = os.pidfd_open(pid)
        except OSError:
            return True          # alive per the checks above; stay on /proc
        # the pid may have been recycled between the checks above and the
        # open: the fd pins SOME process with this pid, so re-verify the
        # incarnation before trusting it
        if _pid_start(pid) != registered:
            os.close(fd)
            return False
        _pidfd_cache[key] = fd
    return True


def worker_alive(root: str, worker_id: str) -> bool:
    """A worker is alive iff the pid it registered still exists AND (where
    /proc is readable) still names the same process incarnation: a recycled
    pid has a different start tick, so a dead worker whose pid the OS
    handed to an unrelated process is correctly reported dead. A stale
    seqlock additionally demotes a worker to 'stale' in the aggregator,
    see daemon.Aggregator."""
    try:
        info = worker_info(root, worker_id)
        pid = int(info["pid"])
    except (OSError, ValueError, KeyError):
        return False
    return _pid_incarnation_alive(pid, info.get("pid_start"))


def _queue_request(base: str, req: dict, reqseq=None) -> None:
    """Append one request to a control queue and bump its counter — the
    only files the request path touches (no map sections opened). The
    rewrite is atomic (workers poll requests.json every step: a truncate
    window would crash them on a half-written file) and the append is
    serialized with an flock so two concurrent requesters can't lose an
    entry while bumping reqseq twice."""
    import fcntl
    with open(os.path.join(base, "control", ".requests.lock"), "w") as lk:
        fcntl.flock(lk, fcntl.LOCK_EX)
        p = os.path.join(base, "control", "requests.json")
        with open(p) as f:
            reqs = json.load(f)
        reqs.append(req)
        _atomic_json(p, reqs)
        if reqseq is None:
            reqseq = _memmap(os.path.join(base, "control", ".reqseq.npy"),
                             None, "r+")
        reqseq[0] += 1
        reqseq.flush()


def fanout_request(root: str, req: dict,
                   worker_ids: list[str] | None = None) -> list[str]:
    """Queue one request into EVERY worker's control queue (live attach
    fan-out: the whole fleet picks the program up without recompiling).
    Returns the worker ids reached."""
    wids = list_workers(root) if worker_ids is None else list(worker_ids)
    for wid in wids:
        _queue_request(_worker_base(root, wid), req)
    return wids


# --------------------------------------------------------------------------
# tree aggregation: node registry + inter-level delta streams (DESIGN.md §15)
# --------------------------------------------------------------------------

def node_base(root: str, node_id: str) -> str:
    return os.path.join(root, "nodes", str(node_id))


def list_nodes(root: str) -> list[str]:
    d = os.path.join(root, "nodes")
    if not os.path.isdir(d):
        return []
    return sorted(n for n in os.listdir(d)
                  if os.path.exists(os.path.join(d, n, "node.json")))


def node_info(root: str, node_id: str) -> dict:
    return dict(_cached_registry_json(
        os.path.join(node_base(root, node_id), "node.json")))


def node_alive(root: str, node_id: str) -> bool:
    """Same liveness rules as worker_alive: registered pid must exist AND
    (where /proc is readable) still name the same incarnation (pid-reuse
    detection via the kernel start tick)."""
    try:
        info = node_info(root, node_id)
        pid = int(info["pid"])
    except (OSError, ValueError, KeyError):
        return False
    return _pid_incarnation_alive(pid, info.get("pid_start"))


def register_node(root: str, node_id: str, parent: str | None,
                  workers: list[str], children: list[str]) -> dict:
    """Write node.json: the tree-topology record (who this node folds, who
    consumes its stream) plus the liveness/restart identity (pid, pid_start,
    boot) that gives node aggregators the same failure rules as workers."""
    info = {"node_id": str(node_id), "parent": parent,
            "workers": sorted(workers), "children": sorted(children),
            "pid": os.getpid(), "pid_start": _pid_start(os.getpid()),
            "boot": uuid.uuid4().hex, "started_at": time.time()}
    base = node_base(root, node_id)
    os.makedirs(base, exist_ok=True)
    _atomic_json(os.path.join(base, "node.json"), info)
    return info


def update_node_workers(root: str, node_id: str,
                        workers: list[str]) -> dict:
    """Refresh a registered node's worker claim in place — same pid/boot
    incarnation, so the parent does NOT see a restart. Used when group
    membership grows (a worker joined its group after the node booted)."""
    info = node_info(root, node_id)
    info["workers"] = sorted(workers)
    _atomic_json(os.path.join(node_base(root, node_id), "node.json"), info)
    return info


def unregister_node(root: str, node_id: str) -> bool:
    """Tear a node out of the topology (CLI `node rm`): its workers go back
    to being polled directly by the parent. The stream directory stays on
    disk so unconsumed batches can still be harvested."""
    p = os.path.join(node_base(root, node_id), "node.json")
    try:
        os.unlink(p)
        return True
    except OSError:
        return False


def claimed_workers(root: str) -> set[str]:
    """Worker ids owned by SOME node aggregator — the set a parent level
    must not also fold directly (each worker has exactly one fold path up
    the tree)."""
    out: set[str] = set()
    for nid in list_nodes(root):
        try:
            out.update(node_info(root, nid).get("workers", []))
        except (OSError, ValueError):
            continue
    return out


class StreamCorruption(Exception):
    """A delta-stream batch file read back with a checksum mismatch: the
    bytes were damaged after the atomic commit. Detect-and-skip with drop
    accounting, never silent-fold (same contract as SnapshotCorruption)."""


class DeltaStream:
    """Incremental delta channel between tree levels: a node aggregator
    emits sequence-numbered batch files (atomic tmp+rename commit, CRC32
    over the payload), its parent consumes every seq exactly once and acks,
    the writer garbage-collects acked batches. The stream doubles as the
    node's write-ahead log: a restarted node replays its own committed
    batches past the journal to rebuild the emit baseline, so deltas are
    never double-emitted (and journal lag costs only re-extraction).

        <root>/nodes/<nid>/stream/delta_<seq>.dsb   committed batches
        <root>/nodes/<nid>/stream/.head.npy         last committed seq
        <root>/nodes/<nid>/stream/.ack.npy          last seq the parent
                                                    has folded AND journaled
    """

    def __init__(self, root: str, node_id: str, head: np.memmap,
                 ack: np.memmap):
        self.root = root
        self.node_id = node_id
        self._head = head
        self._ack = ack

    @staticmethod
    def _dir(root: str, node_id: str) -> str:
        return os.path.join(node_base(root, node_id), "stream")

    @staticmethod
    def _batch_path(root: str, node_id: str, seq: int) -> str:
        return os.path.join(DeltaStream._dir(root, node_id),
                            f"delta_{seq:010d}.dsb")

    @staticmethod
    def create(root: str, node_id: str) -> "DeltaStream":
        """Writer side. Head/ack PERSIST across node restarts — the stream
        outlives any one incarnation (it is the level's crash-recovery
        ledger), unlike a worker's device section which resets with it."""
        d = DeltaStream._dir(root, node_id)
        os.makedirs(d, exist_ok=True)
        hp = os.path.join(d, ".head.npy")
        head = _memmap(hp, None, "r+") if os.path.exists(hp) \
            else _memmap(hp, (1,), "w+")
        ap = os.path.join(d, ".ack.npy")
        ack = _memmap(ap, None, "r+") if os.path.exists(ap) \
            else _memmap(ap, (1,), "w+")
        return DeltaStream(root, node_id, head, ack)

    @staticmethod
    def attach(root: str, node_id: str) -> "DeltaStream":
        """Consumer side (needs write access to .ack.npy only)."""
        d = DeltaStream._dir(root, node_id)
        head = _memmap(os.path.join(d, ".head.npy"), None, "r")
        ack = _memmap(os.path.join(d, ".ack.npy"), None, "r+")
        return DeltaStream(root, node_id, head, ack)

    @staticmethod
    def exists(root: str, node_id: str) -> bool:
        return os.path.exists(os.path.join(
            DeltaStream._dir(root, node_id), ".head.npy"))

    # ------------------------------------------------------------ serialize
    _MAGIC = b"DSB1"

    @staticmethod
    def _serialize(batch: dict) -> bytes:
        """Flat length-prefixed container: magic | header json (array
        names/dtypes/shapes + blob length + CRC) | json blob | packed raw
        array bytes. The CRC spans the blob and every array, so a scribble
        anywhere is detect-and-skip, same as the old npz container — but
        without the per-array zipfile bookkeeping that dominated the
        root's poll at fleet scale."""
        arrays = {k: np.ascontiguousarray(np.asarray(v))
                  for k, v in batch.get("arrays", {}).items()}
        blob = json.dumps(batch.get("json", {}),
                          sort_keys=True).encode("utf-8")
        crc = zlib.crc32(blob)
        meta, parts = [], []
        for k in sorted(arrays):
            a = arrays[k]
            raw = a.tobytes()
            crc = zlib.crc32(raw, crc)
            meta.append({"n": k, "d": a.dtype.str, "s": list(a.shape)})
            parts.append(raw)
        head = json.dumps({"a": meta, "j": len(blob), "c": crc},
                          sort_keys=True).encode("utf-8")
        return b"".join([DeltaStream._MAGIC,
                         len(head).to_bytes(4, "little"), head, blob,
                         *parts])

    @staticmethod
    def _deserialize(data: bytes) -> dict:
        try:
            if data[:4] != DeltaStream._MAGIC:
                raise ValueError("bad magic")
            hl = int.from_bytes(data[4:8], "little")
            head = json.loads(data[8:8 + hl].decode("utf-8"))
            off = 8 + hl
            blob = bytes(data[off:off + int(head["j"])])
            if len(blob) != int(head["j"]):
                raise ValueError("truncated json blob")
            off += len(blob)
            crc = zlib.crc32(blob)
            mv = memoryview(data)
            arrays = {}
            for m in head["a"]:
                dt = np.dtype(m["d"])
                nb = dt.itemsize * int(np.prod(m["s"], dtype=np.int64))
                raw = mv[off:off + nb]
                if len(raw) != nb:
                    raise ValueError("truncated array bytes")
                crc = zlib.crc32(raw, crc)
                arrays[m["n"]] = np.frombuffer(raw, dt).reshape(
                    m["s"]).copy()
                off += nb
            if crc != int(head["c"]):
                raise StreamCorruption("delta batch checksum mismatch")
            return {"json": json.loads(blob.decode("utf-8")),
                    "arrays": arrays}
        except StreamCorruption:
            raise
        except Exception as exc:   # scribbled header / layout
            raise StreamCorruption(f"delta batch unreadable: {exc}") from exc

    # ------------------------------------------------------------ writer
    def head(self) -> int:
        return int(self._head[0])

    def acked(self) -> int:
        return int(self._ack[0])

    def emit(self, seq: int, batch: dict) -> str:
        """Atomically commit batch `seq` (must be head+1) and advance the
        head. A crash between the rename and the head bump is healed by the
        consumer (it probes head+1 on disk) and by the writer's next
        restart."""
        path = self._batch_path(self.root, self.node_id, seq)
        tmp = f"{path}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            f.write(self._serialize(batch))
        os.replace(tmp, path)
        # no msync: same-host readers see the bump via the page cache; a
        # machine-crash-lost bump is healed by the consumer probing one
        # past the head (below) and by the writer's restart re-emit
        self._head[0] = seq
        return path

    def gc(self, limit: int | None = None) -> int:
        """Remove batches the consumer has folded AND journaled. Anything
        newer stays: a crashed parent re-reads them idempotently. The
        writer passes its OWN journaled emit seq as `limit` — batches past
        the writer's journal are its recovery WAL and must survive even
        after the consumer acks them."""
        bound = self.acked() if limit is None else min(self.acked(), limit)
        n = 0
        for seq in range(bound, 0, -1):
            p = self._batch_path(self.root, self.node_id, seq)
            if not os.path.exists(p):
                break
            os.unlink(p)
            n += 1
        return n

    # ------------------------------------------------------------ consumer
    def poll(self, last_seen: int) -> list[tuple[int, dict | None]]:
        """Batches with seq > last_seen in order. A committed-but-unbumped
        head (writer died mid-emit) is healed by probing one past the head.
        Corrupt or vanished batches yield (seq, None): the consumer counts
        them as stream_lost — detect-and-skip, never silent."""
        out = []
        hi = self.head()
        seq = last_seen + 1
        while True:
            p = self._batch_path(self.root, self.node_id, seq)
            if not os.path.exists(p):
                if seq <= hi:
                    out.append((seq, None))   # gc'd past us / vanished
                    seq += 1
                    continue
                break
            try:
                with open(p, "rb") as f:
                    out.append((seq, self._deserialize(f.read())))
            except (StreamCorruption, OSError, ValueError):
                out.append((seq, None))
            seq += 1
        return out

    def ack(self, seq: int) -> None:
        # no msync: an ack lost to a machine crash only makes the parent
        # re-read batches it already folded — idempotent by design
        if seq > self.acked():
            self._ack[0] = seq


# --------------------------------------------------------------------------
# sharded global hash views (keyspace partition over the home-slot hash)
# --------------------------------------------------------------------------

class HashShards:
    """The global HASH maps republished as independently seqlocked shards:
    shard s of map m holds exactly the keys whose home slot
    (maps._np_hash_idx — the probe start every lookup already uses) is
    congruent to s mod n_shards. Every key lands in exactly one shard, each
    shard has its own seqlock + CRC (same torn-read/corruption contract as
    any section), and the aggregator republishes ONLY dirty shards — a
    reader polling one shard never retries against writes to the others.

        <root>/global/shards/meta.json              {n_shards, maps}
        <root>/global/shards/<map>/<s>/*.npy        canonicalized subtable
        <root>/global/shards/<map>/<s>/.seq.npy     per-shard seqlock
        <root>/global/shards/<map>/<s>/.crc.npy     per-shard checksum
    """

    def __init__(self, root: str, specs: list[MapSpec], n_shards: int,
                 shards: dict):
        self.root = root
        self.specs = specs
        self.n_shards = n_shards
        self._shards = shards     # (name, s) -> (section, seq, crc)

    @staticmethod
    def _dir(root: str) -> str:
        return os.path.join(root, "global", "shards")

    @staticmethod
    def _hash_specs(specs: list[MapSpec]) -> list[MapSpec]:
        return [s for s in specs if s.kind == MapKind.HASH]

    @staticmethod
    def exists(root: str) -> bool:
        return os.path.exists(os.path.join(HashShards._dir(root),
                                           "meta.json"))

    @staticmethod
    def read_meta(root: str) -> dict:
        with open(os.path.join(HashShards._dir(root), "meta.json")) as f:
            return json.load(f)

    @staticmethod
    def _open(root: str, spec: MapSpec, s: int, create: bool):
        d = os.path.join(HashShards._dir(root), spec.name, str(s))
        seq_path = os.path.join(d, ".seq.npy")
        if create:
            # same restart discipline as GlobalView.create: reset under the
            # seqlock so a reader's live mmaps never observe a torn mix
            if os.path.exists(seq_path):
                section = _attach_section(d, [spec], "r+")
                seq = _memmap(seq_path, None, "r+")
                if int(seq[0]) % 2 == 0:
                    seq[0] += 1
                    seq.flush()
                for arr in section[spec.name].values():
                    arr[...] = 0
                crc = _crc_create(d, 1)
                crc[0] = _crc_of(section[spec.name])
                crc.flush()
                seq[0] += 1
                seq.flush()
            else:
                section = _create_section(d, [spec])
                crc = _crc_create(d, 1)
                seq = _memmap(seq_path, (1,), "w+")
                seq[0] = 0
        else:
            section = _attach_section(d, [spec], "r")
            seq = _memmap(seq_path, None, "r")
            crc = _crc_attach(d, "r")
        return section, seq, crc

    @staticmethod
    def create(root: str, specs: list[MapSpec],
               n_shards: int) -> "HashShards":
        hs = HashShards._hash_specs(specs)
        os.makedirs(HashShards._dir(root), exist_ok=True)
        shards = {}
        for spec in hs:
            for s in range(n_shards):
                shards[(spec.name, s)] = HashShards._open(
                    root, spec, s, create=True)
        _atomic_json(os.path.join(HashShards._dir(root), "meta.json"),
                     {"n_shards": n_shards, "maps": [s.name for s in hs],
                      "version": 1})
        return HashShards(root, specs, n_shards, shards)

    @staticmethod
    def attach(root: str) -> "HashShards":
        meta = HashShards.read_meta(root)
        specs = read_meta_specs(root)
        spec_of = {s.name: s for s in specs}
        shards = {}
        for name in meta["maps"]:
            for s in range(meta["n_shards"]):
                shards[(name, s)] = HashShards._open(
                    root, spec_of[name], s, create=False)
        return HashShards(root, specs, meta["n_shards"], shards)

    def publish(self, name: str, s: int, state: dict) -> None:
        section, seq, crc = self._shards[(name, s)]
        _seq_publish(seq, section, {name: state}, crc=crc, order=[name],
                     role="global")

    def snapshot(self, name: str, s: int, retries: int = 100
                 ) -> tuple[dict, int, int]:
        """(state, seq_observed, retries_used) — the per-shard torn-read
        test surface; seq_observed is always even on success."""
        section, seq, crc = self._shards[(name, s)]
        return _seq_snapshot(seq, section, name, retries, crc=crc,
                             crc_idx=0 if crc is not None else None)


# --------------------------------------------------------------------------
# global (daemon-merged) view
# --------------------------------------------------------------------------

@dataclass
class GlobalView:
    """The aggregation engine's output: one seqlocked section holding the
    merged state of every worker's maps, readable by any observer exactly
    like a per-worker device section."""
    root: str
    specs: list[MapSpec]
    section: dict
    seq: np.memmap
    crc: np.memmap | None = None

    @property
    def _order(self) -> list[str]:
        return sorted(s.name for s in self.specs)

    @staticmethod
    def _dir(root: str) -> str:
        return os.path.join(root, "global")

    @staticmethod
    def create(root: str, specs: list[MapSpec] | None = None) -> "GlobalView":
        specs = read_meta_specs(root) if specs is None else specs
        d = GlobalView._dir(root)
        seq_path = os.path.join(d, ".seq.npy")
        order = sorted(s.name for s in specs)
        if os.path.exists(seq_path):
            # an aggregator restart over a published section: readers may
            # hold these very mmaps, so the reset must happen UNDER the
            # seqlock — never truncate/zero the files in place
            section = _attach_section(d, specs, "r+")
            seq = _memmap(seq_path, None, "r+")
            if int(seq[0]) % 2 == 0:       # else: prior writer died odd —
                seq[0] += 1                # stay in its in-flight cycle
                seq.flush()
            for name in section:
                for arr in section[name].values():
                    arr[...] = 0
            # seq continues > 0, so readers WILL validate: the checksums
            # must match the zeroed payload, still inside the odd window
            crc = _crc_create(d, len(specs))
            for i, name in enumerate(order):
                crc[i] = _crc_of(section[name])
            crc.flush()
            seq[0] += 1                    # even: consistent zero state
            seq.flush()
            return GlobalView(root, specs, section, seq, crc=crc)
        section = _create_section(d, specs)
        crc = _crc_create(d, len(specs))
        seq = _memmap(seq_path, (1,), "w+")
        seq[0] = 0
        return GlobalView(root, specs, section, seq, crc=crc)

    @staticmethod
    def attach(root: str, mode: str = "r") -> "GlobalView":
        specs = read_meta_specs(root)
        d = GlobalView._dir(root)
        section = _attach_section(d, specs, mode)
        seq = _memmap(os.path.join(d, ".seq.npy"), None,
                      "r+" if mode != "r" else "r")
        return GlobalView(root, specs, section, seq,
                          crc=_crc_attach(d, mode))

    @staticmethod
    def exists(root: str) -> bool:
        return os.path.exists(os.path.join(GlobalView._dir(root),
                                           ".seq.npy"))

    def publish(self, states: dict) -> None:
        _seq_publish(self.seq, self.section, states,
                     crc=self.crc, order=self._order, role="global")

    def snapshot(self, name: str, retries: int = 100) -> dict:
        out, _, _ = _seq_snapshot(
            self.seq, self.section, name, retries, crc=self.crc,
            crc_idx=self._order.index(name) if self.crc is not None
            else None)
        return out

    def publish_status(self, status: dict) -> None:
        _atomic_json(os.path.join(self._dir(self.root), "status.json"),
                     status)

    def read_status(self) -> dict:
        p = os.path.join(self._dir(self.root), "status.json")
        if not os.path.exists(p):
            return {}
        with open(p) as f:
            return json.load(f)
