"""The traced sub-window: `torch.profiler` over a few steady iterations or
steps, with the benchmark's own ranges around the calls into each layer,
reduced to what the per-layer readers need.

Device operations are placed in a range by the call that launched them:
each is matched by its correlation id to its CUDA runtime or driver
call, and belongs to a range when that call started inside one of the
range's spans on the host's clock (never by the profiler's operator tree,
which can link launches made outside every range to an event)."""
from __future__ import annotations

import bisect
import contextlib
import re

import torch

PREFIX = "portbench."
WINDOW = PREFIX + "window"


@contextlib.contextmanager
def ranged(fns: dict):
    """Each `getattr(owner, name)` of fns {label: (owner, name)} called
    inside the range PREFIX + label while the block runs. The owner is a
    module, a class or an instance; the attribute is put back after."""
    saved = {label: getattr(o, n) for label, (o, n) in fns.items()}
    had = {label: n in vars(o) for label, (o, n) in fns.items()}

    def wrap(label, fn):
        def inner(*args, **kwargs):
            with torch.profiler.record_function(PREFIX + label):
                return fn(*args, **kwargs)
        return inner
    for label, (o, n) in fns.items():
        # a plain function set on a class is bound like the one it wraps
        setattr(o, n, wrap(label, saved[label]))
    try:
        yield
    finally:
        for label, (o, n) in fns.items():
            if had[label]:
                setattr(o, n, saved[label])
            else:
                delattr(o, n)


def _kind(ev) -> str:
    name = ev.name()
    if "cuda" in str(ev.device_type()).lower():
        return "annotation" if name.startswith(PREFIX) else "device"
    if name.startswith(PREFIX):
        return "range"
    return "launch" if re.match(r"cu(da)?[A-Z]", name) else "other"


class Trace:
    """The reduced profile of one sub-window (times in ns on the
    profiler's clock)."""

    def __init__(self, kineto_events):
        events = [(e, _kind(e)) for e in kineto_events]
        self.ranges: dict[str, list] = {}
        for e, k in events:
            if k == "range":
                self.ranges.setdefault(e.name()[len(PREFIX):], []).append(
                    (e.start_ns(), e.end_ns()))
        for spans in self.ranges.values():
            spans.sort()
        win = self.ranges.get("window") or [(
            min(e.start_ns() for e, _ in events),
            max(e.end_ns() for e, _ in events))]
        self.t0, self.t1 = win[0][0], win[-1][1]
        launch = {e.correlation_id(): e.start_ns() for e, k in events
                  if k == "launch" and e.correlation_id()}
        # (name, start, end, host start of its launch call or None)
        self.ops = sorted(
            ((e.name(), max(e.start_ns(), self.t0),
              min(e.end_ns(), self.t1), launch.get(e.correlation_id()))
             for e, k in events if k == "device"
             and e.end_ns() > self.t0 and e.start_ns() < self.t1),
            key=lambda op: op[1])

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e9

    def busy_intervals(self) -> list:
        out = []
        for _, a, b, _ in self.ops:
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        return out

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def device_s(self, pred=None) -> float:
        """Summed device seconds of the operations whose name `pred`
        accepts (all without one)."""
        return sum(b - a for n, a, b, _ in self.ops
                   if pred is None or pred(n)) / 1e9

    def _inside(self, labels, t) -> bool:
        for label in labels:
            spans = self.ranges.get(label, [])
            i = bisect.bisect_right(spans, (t, float("inf"))) - 1
            if i >= 0 and spans[i][0] <= t <= spans[i][1]:
                return True
        return False

    def launched_in(self, labels, pred=None) -> float:
        """Device seconds of the operations (named as `pred` accepts)
        launched by a call that started inside a span of `labels`."""
        return sum(b - a for n, a, b, t in self.ops
                   if t is not None and (pred is None or pred(n))
                   and self._inside(labels, t)) / 1e9

    def host_s(self, label) -> float:
        """Host seconds inside the spans of `label` (outermost spans only,
        so a range re-entered within itself is counted once)."""
        total, end = 0, -1
        for a, b in self.ranges.get(label, []):
            if a >= end:
                total += b - a
                end = b
            elif b > end:
                total += b - end
                end = b
        return total / 1e9

    def calls(self, label) -> int:
        return len(self.ranges.get(label, []))

    def breakdown(self, top: int = 10) -> dict:
        by_name: dict[str, int] = {}
        for n, a, b, _ in self.ops:
            by_name[n] = by_name.get(n, 0) + (b - a)
        device_ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
        gaps: dict[str, int] = {}
        busy = self.busy_intervals()
        edges = [self.t0] + [x for ab in busy for x in ab] + [self.t1]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                label = self.host_label(a)
                gaps[label] = gaps.get(label, 0) + (b - a)
        idle = sorted(gaps.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:120], v / 1e9] for n, v in device_ops],
                "idle_gaps": [[n, v / 1e9] for n, v in idle]}

    def host_label(self, t) -> str:
        """The innermost benchmark range open on the host at time t."""
        best, best_start = "outside every range", None
        for label, spans in self.ranges.items():
            if label == "window":
                continue
            i = bisect.bisect_right(spans, (t, float("inf"))) - 1
            if i >= 0 and spans[i][0] <= t <= spans[i][1] and \
                    (best_start is None or spans[i][0] > best_start):
                best, best_start = label, spans[i][0]
        return best


class Window:
    """The profiler over [start(), stop()], with the range WINDOW around
    it. Only the benchmark's own ranges are recorded on the host (the
    user scope), not every operator, so the host runs near its untraced
    pace; the device's operations and the runtime calls that launched
    them come from CUPTI."""

    def __init__(self):
        from torch._C._profiler import (ProfilerActivity, ProfilerConfig,
                                        ProfilerState, _ExperimentalConfig)
        self.config = ProfilerConfig(ProfilerState.KINETO, False, False,
                                     False, False, False,
                                     _ExperimentalConfig())
        self.activities = {ProfilerActivity.CPU}
        if torch.cuda.is_available():
            self.activities.add(ProfilerActivity.CUDA)
        self.rf = None

    def start(self):
        from torch._C._profiler import RecordScope
        from torch.autograd import _enable_profiler, _prepare_profiler
        _prepare_profiler(self.config, self.activities)
        _enable_profiler(self.config, self.activities,
                         {RecordScope.USER_SCOPE})
        self.rf = torch.profiler.record_function(WINDOW)
        self.rf.__enter__()

    def stop(self) -> Trace:
        from torch.autograd import _disable_profiler
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.rf.__exit__(None, None, None)
        return Trace(_disable_profiler().events())
