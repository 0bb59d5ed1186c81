"""Decode step (serve/steps.py's `decode.model` span: the model's work,
replayed from CUDA graphs on the card): host ms a `decode.step` spends in
`decode.model` less the `probe.emit` spans inside it. Read with
telemetry on, so it includes the spans' own host time."""


def read(run):
    t = run.trace
    if t is None or not t.calls("decode.step"):
        return None
    emits = sum(b - a for a, b in t.nested("probe.emit", "decode.model"))
    return 1e3 * (t.host_s("decode.model") - emits / 1e9) / \
        t.calls("decode.step")
