"""Probe stage (core/events.py's collector): host us a `probe.emit` span
inside a `decode.step` takes, the event's row written by the statistics
kernel's launch. Read with telemetry on, so it includes the span's own
host time."""


def read(run):
    t = run.trace
    emits = [] if t is None else t.nested("probe.emit", "decode.step")
    if not emits:
        return None
    return 1e-3 * sum(b - a for a, b in emits) / len(emits)
