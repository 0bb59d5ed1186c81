"""Decode step (serve/steps.py, models/): host ms a decode call takes to
enqueue its work (collector and probe stage included), before the engine
syncs."""


def read(run):
    t = run.trace
    if t is None or not t.calls("decode"):
        return None
    return 1e3 * t.host_s("decode") / t.calls("decode")
