"""The host-clock arithmetic of the end-to-end metrics, apart from any
device so the tests can feed it synthetic timestamps."""
from __future__ import annotations

import numpy as np


def window_tokens(emissions: dict, start: float, end: float) -> list:
    """Emission times of every token emitted in (start, end]."""
    return sorted(t for ts in emissions.values() for t in ts
                  if start < t <= end)


def tokens_per_s(emissions: dict, start: float, end: float) -> float:
    """Tokens emitted in the window over the time from its start to the
    last of them."""
    ts = window_tokens(emissions, start, end)
    return len(ts) / (ts[-1] - start) if ts else 0.0


def token_gaps(emissions: dict, start: float, end: float) -> list:
    """For every token emitted in the window after its request's first,
    the time since that request's previous token."""
    out = []
    for ts in emissions.values():
        for a, b in zip(ts, ts[1:]):
            if start < b <= end:
                out.append(b - a)
    return out


def percentile(xs, q: float) -> float:
    return float(np.percentile(np.asarray(xs, np.float64), q))


def train_rate(steps: list, start: float, tokens_per_step: int) -> float:
    """Tokens of the whole steps (start, end) listed, over the time from
    the window's start to the end of the last."""
    if not steps:
        return 0.0
    return len(steps) * tokens_per_step / (steps[-1][1] - start)
