"""Serving loop (serve/engine.py `_prefill_slot`): host ms a
`serve.prefill` spends in its `serve.slot_write`, the copy of the
one-request cache into its slot of the engine's. Read with telemetry on,
so it includes the spans' own host time."""


def read(run):
    t = run.trace
    if t is None or not t.calls("serve.prefill"):
        return None
    return 1e3 * t.host_s("serve.slot_write") / t.calls("serve.prefill")
