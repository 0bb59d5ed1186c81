"""Model (models/moe.py's `moe.routed` span: the router, the dispatch, the
experts and the combine): device ms a decode step of the operations
launched inside `moe.routed` spans nested in `decode.step`. Under the
graphed decode a replayed segment reopens the span it was captured in
(serve/decode_graph.py)."""

import bisect


def read(run):
    t = run.trace
    if t is None or not t.calls("decode.step"):
        return None
    spans = sorted(t.nested("moe.routed", "decode.step"))
    if not spans:
        return None
    starts = [a for a, _ in spans]

    def inside(at):
        i = bisect.bisect_right(starts, at) - 1
        return i >= 0 and at <= spans[i][1]
    dev = sum(b - a for _, a, b, at in t.ops if at is not None and inside(at))
    return 1e3 * dev / 1e9 / t.calls("decode.step")
