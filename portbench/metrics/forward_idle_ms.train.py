"""Device: idle ms a traced step in the gaps between device operations
that start while `train.forward` is the port's innermost open span (the
forward's host work outrunning the work it launched). Read with telemetry
on, so it includes the spans' own host time."""


def read(run):
    t = run.trace
    if t is None or not run.traced_steps or not t.ops or \
            not t.calls("train.forward"):
        return None
    gaps = t.idle_gaps(t.span_label)
    return 1e3 * gaps.get("train.forward", 0) / 1e9 / run.traced_steps
