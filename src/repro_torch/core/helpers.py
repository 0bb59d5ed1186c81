"""Helper-function table (the BPF_CALL interface).

IDs match Linux where an equivalent exists; runtime-specific helpers live in
the 1000+ range (like bpftime's userspace-only helpers). The signature table
drives verifier arg-checking; execution lives in vm.py (numpy twin) and
jit.py (torch twin).

Arg kinds:
  mapfd   const scalar naming a bound map (verifier must know it statically —
          the analogue of the kernel requiring a map fd via LDDW relocation)
  kptr    readable stack pointer, 8 initialized bytes (a key/value cell)
  scalar  any initialized scalar
  cscalar const scalar (e.g. ringbuf output size)
"""
from __future__ import annotations

from dataclasses import dataclass

from .maps import MapKind


@dataclass(frozen=True)
class HelperSig:
    hid: int
    name: str
    args: tuple[str, ...]
    # map kinds accepted for the mapfd arg (None = any)
    map_kinds: tuple[MapKind, ...] | None = None


HELPERS: dict[int, HelperSig] = {h.hid: h for h in [
    HelperSig(1, "map_lookup_elem", ("mapfd", "kptr"),
              (MapKind.ARRAY, MapKind.HASH, MapKind.PERCPU_ARRAY)),
    HelperSig(2, "map_update_elem", ("mapfd", "kptr", "kptr", "scalar"),
              (MapKind.ARRAY, MapKind.HASH)),
    HelperSig(3, "map_delete_elem", ("mapfd", "kptr"), (MapKind.HASH,)),
    HelperSig(5, "ktime_get_ns", ()),
    HelperSig(6, "trace_printk", ("scalar", "scalar")),
    HelperSig(7, "get_prandom_u32", ()),
    HelperSig(8, "get_smp_processor_id", ()),
    HelperSig(14, "get_current_pid_tgid", ()),
    HelperSig(130, "ringbuf_output", ("mapfd", "kptr", "cscalar", "scalar"),
              (MapKind.RINGBUF,)),
    HelperSig(1001, "map_fetch_add", ("mapfd", "kptr", "scalar"),
              (MapKind.ARRAY, MapKind.HASH)),
    HelperSig(1002, "log2", ("scalar",)),
    HelperSig(1003, "override_return", ("scalar",)),
    HelperSig(1004, "hist_add", ("mapfd", "scalar"), (MapKind.LOG2HIST,)),
    HelperSig(1005, "percpu_fetch_add", ("mapfd", "kptr", "scalar"),
              (MapKind.PERCPU_ARRAY,)),
]}

HELPER_IDS: dict[str, int] = {h.name: h.hid for h in HELPERS.values()}

# aux fields each helper may WRITE — drives the verifier's touched-aux
# analysis (fused pipeline gates per-event aux selects to this footprint).
AUX_WRITES: dict[str, tuple[str, ...]] = {
    "get_prandom_u32": ("rand",),
    "trace_printk": ("printk_buf", "printk_n"),
    "override_return": ("override_set", "override_val"),
}
