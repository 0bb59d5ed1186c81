"""Probe stage: device ms a training step of the operations launched
inside the collector's emit ranges and the probe stage (by launch call)."""


def read(run):
    t = run.trace
    if t is None or run.mode != "train" or not run.traced_steps \
            or not t.calls("emit"):
        return None
    return 1e3 * t.launched_in(("emit", "probe_stage")) / run.traced_steps
