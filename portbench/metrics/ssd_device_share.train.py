"""SSM mixer (models/ssm.py): share of the traced steps' device time in
operations launched inside models.ssm.ssd_chunked (the forward and the
remat recompute; the backward runs outside the range)."""


def read(run):
    t = run.trace
    if t is None or run.mode != "train" or not t.calls("ssd_chunked"):
        return None
    total = t.device_s()
    return 100.0 * t.launched_in(("ssd_chunked",)) / total if total else None
