"""Serving loop (serve/engine.py): share of the traced sub-window's host
time inside ServeEngine._prefill_slot, which ends in its own sync."""


def read(run):
    t = run.trace
    if t is None or not t.calls("prefill_slot") and not t.calls("decode"):
        return None
    return 100.0 * t.host_s("prefill_slot") / t.window_s
