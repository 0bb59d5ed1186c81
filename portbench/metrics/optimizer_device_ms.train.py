"""Model (train/train_step.py's `train.optimizer` span, AdamW): device ms
a traced step of the operations launched inside it."""


def read(run):
    t = run.trace
    if t is None or not run.traced_steps or not t.ops or \
            not t.calls("train.optimizer"):
        return None
    return 1e3 * t.launched_in(("train.optimizer",)) / run.traced_steps
