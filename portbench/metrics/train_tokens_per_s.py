"""Tokens of the training steps that ended inside the window, over the
time from the window's start to the end of the last of them."""
from portbench import timeline


def read(run):
    if run.mode != "train":
        return None
    return timeline.train_rate(run.steps, run.window[0], run.tokens_per_step)
