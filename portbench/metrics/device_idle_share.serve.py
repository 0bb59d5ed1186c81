"""Device: share of the traced serving sub-window with no operation
running on the card."""


def read(run):
    if run.mode != "serve" or run.trace is None:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / run.trace.window_s)
