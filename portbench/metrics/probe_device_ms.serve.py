"""Probe stage: device ms a decode step of the operations launched inside
the collector's emit ranges and the probe stage (placed by launch call)."""


def read(run):
    t = run.trace
    if t is None or not t.calls("decode") or not t.calls("emit"):
        return None
    return 1e3 * t.launched_in(("emit", "probe_stage")) / t.calls("decode")
