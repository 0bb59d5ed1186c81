"""Kernels (the routed experts, models/moe.py): the least time the
traced sub-window's `moe.routed` calls need at the card's peak bandwidth
over the device time launched inside `moe.routed` spans. A call's bytes,
from its keyed record (experts held E, k, D, expert width F, tokens T,
element size): every expert's three matrices in the compute type,
E * 3 * D * F, and the tokens' activations in and out, 2 * T * D, each
element of that size. The bound follows the work, not the code that
does it."""


def read(run):
    t = run.trace
    if t is None or not t.calls("moe.routed"):
        return None
    rec = t.records.get("keyed", {}).get("moe.routed", {})
    nbytes = sum((E * 3 * D * F + 2 * T * D) * size * n
                 for (E, _, D, F, T, size), n in rec.items())
    dev = t.launched_in(("moe.routed",))
    if not nbytes or dev <= 0:
        return None
    return 100.0 * nbytes / run.peak["hbm_bytes_per_s"] / dev
