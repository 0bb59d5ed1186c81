"""Model (models/registry.loss_fn's `model.loss` span, the cross-entropy
over the logits): device ms a traced step of the operations launched
inside it."""


def read(run):
    t = run.trace
    if t is None or not run.traced_steps or not t.ops or \
            not t.calls("model.loss"):
        return None
    return 1e3 * t.launched_in(("model.loss",)) / run.traced_steps
