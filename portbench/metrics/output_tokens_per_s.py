"""Every output token the engine emitted in the window (first tokens from
prefill and decode tokens) over the window's seconds up to the last."""
from portbench import timeline


def read(run):
    if run.mode != "serve":
        return None
    return timeline.tokens_per_s(run.emissions, *run.window)
