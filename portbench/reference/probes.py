"""What the attached eBPF programs must leave in their maps, worked out
from their semantics and the reference's own numbers, and the count of
entries in which the program's maps differ from it.

Map states are numpy arrays as the runtime holds them: an ARRAY map
{"values": [n]}, a HASH {"keys", "used", "values": [n]} (used 1 for an
occupied slot), a LOG2HIST {"bins": [64]}, a RINGBUF {"data": [cap, W],
"head": [1], "dropped": [1]}; fixed-point fields are Q47.16."""
from __future__ import annotations

import numpy as np

FX_ONE = 1 << 16


def _hash_items(st) -> dict:
    out: dict = {}
    for k, u, v in zip(st["keys"].tolist(), st["used"].tolist(),
                       st["values"].tolist()):
        if u == 1:                  # a key held twice is a broken table
            out[k] = None if k in out else v
    return out


def counter_errors(st, per_index: int, n_index: int, kind: str) -> int:
    """Entries of a per-layer counter (ARRAY or HASH keyed by the layer)
    that differ from `per_index` at layers 0..n_index-1 and 0 elsewhere."""
    if kind == "array":
        want = np.zeros_like(st["values"])
        want[:n_index] = per_index
        return int((st["values"] != want).sum())
    items = _hash_items(st)
    want = {i: per_index for i in range(n_index)}
    keys = set(items) | set(want)
    return sum(1 for k in keys if items.get(k) != want.get(k))


def hist_total_error(st, events: int) -> int:
    """|events - the histogram's total count|: every event lands in one bin."""
    return abs(int(st["bins"].sum()) - events)


def ring_head_error(st, records: int) -> int:
    return abs(int(st["head"][0]) - records)


def ring_records(st, first: int, count: int) -> np.ndarray:
    """Records first .. first+count-1 (by order of arrival), [count, W]."""
    cap = st["data"].shape[0]
    head = int(st["head"][0])
    if first + count > head or first < head - cap:
        raise ValueError(f"records {first}..{first + count - 1} are not in "
                         f"a ring of {cap} whose head is {head}")
    return st["data"][[(first + i) % cap for i in range(count)]]


def loss_record_gap(records: np.ndarray, losses: list) -> float:
    """Worst relative gap between the loss records' mean lane (lane 2, the
    loss in Q47.16) and the reference's losses, in order."""
    got = records[:, 2].astype(np.float64) / FX_ONE
    want = np.asarray(losses, np.float64)
    return float(np.max(np.abs(got - want) / np.abs(want)))
