"""95th percentile, over every output token in the window that follows
another of its request, of the time since that token: the duration of
the engine iteration (refills, prefills, decode, probe stage) that
emitted it."""
from portbench import timeline


def read(run):
    if run.mode != "serve":
        return None
    gaps = timeline.token_gaps(run.emissions, *run.window)
    return 1e3 * timeline.percentile(gaps, 95) if gaps else None
