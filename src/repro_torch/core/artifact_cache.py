"""Fleet-wide artifact cache -- encode once, every worker reuses.

The port's half of the JAX package's cache: encoded table-program images
(`LiveTable.encode_slot(cache=...)`), content-addressed by
`LiveTable.image_key`, so a daemon fanning one live attach out to N
workers has the program encoded once and reused N-1 times. The JAX
package also stores serialized XLA executables here (`put_step`,
`get_step`, the runtime's `aot_step`); eager PyTorch builds no executable,
so there is nothing of that kind to store and the port has neither.

Durability model (same discipline as the shm plane):

  * writes are atomic (tmp + os.replace) with a zlib.crc32 over the
    payload in a JSON meta sidecar -- readers can never observe a torn
    artifact;
  * reads verify the CRC; a mismatch DELETES the entry, bumps the
    ``corrupt`` counter, and returns a miss -- the caller encodes again.
    Corruption degrades to the cold path, it never crashes a worker and
    never serves a torn image (chaos-drilled via the ``corrupt_artifact``
    fault kind on the ``cache:post_store`` hook);
  * invalidation is purely key-derivation: any change to the key basis
    lands on a different key. Stale entries are garbage, not hazards --
    ``purge`` reclaims them.

The files are the JAX package's: either package reads the other's
entries.
"""
from __future__ import annotations

import io
import json
import os
import zlib

import numpy as np

from . import faults

COUNTER_KEYS = ("hits", "misses", "stores", "corrupt", "purged", "evicted")


class ArtifactCache:
    """One directory of <key>.bin payloads + <key>.json CRC sidecars.

    Safe for concurrent use by N processes: entries are content-complete
    before they are visible (atomic rename), reads never lock, and two
    workers racing to store the same key write identical bytes (the key
    IS the trace-stability invariant), so last-rename-wins is benign.

    ``max_bytes`` arms an LRU size budget: after every store, least-
    recently-used entries (payload mtime, refreshed on every hit) are
    deleted until the directory fits.  Eviction is safe for the same
    reason purge is — an evicted key is a future miss, and the caller's
    recompile path regenerates identical bytes.  The entry just written
    is never the eviction victim, so a single artifact larger than the
    budget still serves its own writer."""

    def __init__(self, root: str, max_bytes: int | None = None):
        self.root = str(root)
        self.max_bytes = max_bytes
        os.makedirs(self.root, exist_ok=True)
        self.counters: dict[str, int] = {k: 0 for k in COUNTER_KEYS}

    # ------------------------------------------------------------ raw bytes
    def _bin(self, key: str) -> str:
        return os.path.join(self.root, f"{key}.bin")

    def _meta(self, key: str) -> str:
        return os.path.join(self.root, f"{key}.json")

    def put_bytes(self, key: str, payload: bytes, kind: str,
                  meta: dict | None = None) -> None:
        binpath, metapath = self._bin(key), self._meta(key)
        tmp = f"{binpath}.{os.getpid()}.tmp"
        with open(tmp, "wb") as f:
            f.write(payload)
            f.flush()
            os.fsync(f.fileno())
        os.replace(tmp, binpath)
        mtmp = f"{metapath}.{os.getpid()}.tmp"
        with open(mtmp, "w") as f:
            json.dump({"kind": kind, "crc": zlib.crc32(payload),
                       "size": len(payload), **(meta or {})}, f)
        os.replace(mtmp, metapath)
        self.counters["stores"] += 1
        faults.fire("cache:post_store", path=binpath, key=key)
        self._evict(exclude=key)

    def get_bytes(self, key: str, kind: str | None = None) -> bytes | None:
        binpath, metapath = self._bin(key), self._meta(key)
        try:
            with open(metapath) as f:
                meta = json.load(f)
            with open(binpath, "rb") as f:
                payload = f.read()
        except (OSError, ValueError):
            self.counters["misses"] += 1
            return None
        bad = (zlib.crc32(payload) != meta.get("crc")
               or len(payload) != meta.get("size")
               or (kind is not None and meta.get("kind") != kind))
        if bad:
            self._drop_corrupt(key)
            return None
        self.counters["hits"] += 1
        try:                       # refresh LRU recency (payload mtime)
            os.utime(binpath)
        except OSError:
            pass
        return payload

    def _evict(self, exclude: str | None = None) -> int:
        """Delete LRU entries until the directory fits ``max_bytes``.
        Recency is the payload file's mtime (stores and hits both refresh
        it).  ``exclude`` shields the entry just written.  Returns the
        number of entries evicted."""
        if self.max_bytes is None:
            return 0
        entries = []        # (mtime, key, size)
        total = 0
        for r in self.ls():
            try:
                mtime = os.stat(self._bin(r["key"])).st_mtime
            except OSError:
                continue
            entries.append((mtime, r["key"], r["size"]))
            total += r["size"]
        entries.sort()      # oldest first
        n = 0
        for mtime, key, size in entries:
            if total <= self.max_bytes:
                break
            if key == exclude:
                continue
            for p in (self._bin(key), self._meta(key)):
                try:
                    os.unlink(p)
                except OSError:
                    pass
            total -= size
            n += 1
        self.counters["evicted"] += n
        return n

    def _drop_corrupt(self, key: str) -> None:
        self.counters["corrupt"] += 1
        for p in (self._bin(key), self._meta(key)):
            try:
                os.unlink(p)
            except OSError:
                pass

    # ------------------------------------------------------------ table images
    def put_table(self, key: str, arrays: dict) -> None:
        """Store one encoded table-program image (isa.encode_table_program
        output + metadata rows) as an npz blob."""
        buf = io.BytesIO()
        np.savez(buf, **{k: np.asarray(v) for k, v in arrays.items()})
        self.put_bytes(key, buf.getvalue(), "table")

    def get_table(self, key: str) -> dict | None:
        blob = self.get_bytes(key, kind="table")
        if blob is None:
            return None
        try:
            with np.load(io.BytesIO(blob)) as z:
                return {k: z[k] for k in z.files}
        except Exception:
            self.counters["hits"] -= 1
            self._drop_corrupt(key)
            return None

    # ------------------------------------------------------------ introspection
    def ls(self) -> list[dict]:
        rows = []
        for fn in sorted(os.listdir(self.root)):
            if not fn.endswith(".json") or fn.endswith(".tmp"):
                continue
            key = fn[:-5]
            try:
                with open(self._meta(key)) as f:
                    meta = json.load(f)
            except (OSError, ValueError):
                continue
            rows.append({"key": key, "kind": meta.get("kind", "?"),
                         "size": meta.get("size", 0),
                         "crc": meta.get("crc", 0)})
        return rows

    def stats(self) -> dict:
        rows = self.ls()
        return {"root": self.root, "entries": len(rows),
                "bytes": sum(r["size"] for r in rows),
                "max_bytes": self.max_bytes,
                **self.counters}

    def purge(self, key: str | None = None) -> int:
        """Delete one entry (or all). Returns entries removed."""
        keys = [key] if key is not None else [r["key"] for r in self.ls()]
        n = 0
        for k in keys:
            existed = os.path.exists(self._meta(k)) or \
                os.path.exists(self._bin(k))
            for p in (self._bin(k), self._meta(k)):
                try:
                    os.unlink(p)
                except OSError:
                    pass
            if existed:
                n += 1
        self.counters["purged"] += n
        return n
