"""Probe stage (core/events.py's collector, core/runtime.probe_stage):
host ms a decode step spends inside the emit and probe-stage ranges."""


def read(run):
    t = run.trace
    if t is None or not t.calls("decode") or not t.calls("emit"):
        return None
    return 1e3 * (t.host_s("emit") + t.host_s("probe_stage")) / \
        t.calls("decode")
