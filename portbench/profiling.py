"""The traced sub-window: `torch.profiler` over a few steady iterations or
steps with the port's telemetry on, reduced to what the per-layer readers
need. Two kinds of host intervals are kept apart: the benchmark's own
ranges (`portbench.*`), which wrap calls into the port from outside, and
the port's spans (`repro_torch.*`, `repro_torch/telemetry.py`), which
the port opens at its own layer boundaries while telemetry is on. A
range is named by its label ("decode"), a span by its name
("decode.step"); the port's span names are dotted, the labels are not.

Device operations are placed in a range or a span by the call that
launched them: each is matched by its correlation id to its CUDA runtime
or driver call, and belongs to a range or span when that call started
inside it on the host's clock (never by the profiler's operator tree,
which can link launches made outside every range to an event)."""
from __future__ import annotations

import bisect
import contextlib
import re

import torch

PREFIX = "portbench."
WINDOW = PREFIX + "window"
# the port's spans (repro_torch/telemetry.py's PREFIX)
SPAN_PREFIX = "repro_torch."


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
        # the profiler mirrors a host range or span that launched work as
        # an annotation on the device's timeline: it is no operation
        return "annotation" if name.startswith((PREFIX, SPAN_PREFIX)) \
            else "device"
    if name.startswith(PREFIX):
        return "range"
    if name.startswith(SPAN_PREFIX):
        return "span"
    return "launch" if re.match(r"cu(da)?[A-Z]", name) else "other"


def _by_name(events, kind: str, prefix: str) -> dict:
    out: dict[str, list] = {}
    for e, k in events:
        if k == kind:
            out.setdefault(e.name()[len(prefix):], []).append(
                (e.start_ns(), e.end_ns()))
    for spans in out.values():
        spans.sort()
    return out


def _nest(spans) -> list:
    """spans [(name, start, end, thread)] -> [(name, start, end, parent)]
    in order of start, parent the index of the innermost span of the same
    thread that holds it (-1 for none)."""
    order = sorted(spans, key=lambda s: (s[3], s[1], -s[2]))
    out, stacks = [], {}
    for name, a, b, thread in order:
        stack = stacks.setdefault(thread, [])
        while stack and out[stack[-1]][2] < b:
            stack.pop()
        out.append((name, a, b, stack[-1] if stack else -1))
        stack.append(len(out) - 1)
    return out


def _innermost(by_label: dict, t, none: str) -> str:
    """The label of the latest-opened interval open at time t."""
    best, best_start = none, None
    for label, spans in by_label.items():
        i = bisect.bisect_right(spans, (t, float("inf"))) - 1
        if i >= 0 and spans[i][0] <= t <= spans[i][1] and \
                (best_start is None or spans[i][0] > best_start):
            best, best_start = label, spans[i][0]
    return best


class Trace:
    """The reduced profile of one sub-window (times in ns on the
    profiler's clock). `ranges` and `spans`: {label or name: [(start,
    end)]}; `span_tree`: every span as (name, start, end, parent);
    `records`: the port's `telemetry.records()` at the window's end, its
    keyed records over the window and its launch totals over the
    process."""

    def __init__(self, kineto_events):
        events = [(e, _kind(e)) for e in kineto_events]
        self.ranges = _by_name(events, "range", PREFIX)
        self.spans = _by_name(events, "span", SPAN_PREFIX)
        self.span_tree = _nest([
            (e.name()[len(SPAN_PREFIX):], e.start_ns(), e.end_ns(),
             e.start_thread_id()) for e, k in events if k == "span"])
        self.records: dict = {}
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

    def _intervals(self, label) -> list:
        """The spans of the range `label`, or of the port's span of that
        name."""
        return self.ranges.get(label) or self.spans.get(label, [])

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
            spans = self._intervals(label)
            i = bisect.bisect_right(spans, (t, float("inf"))) - 1
            if i >= 0 and spans[i][0] <= t <= spans[i][1]:
                return True
        return False

    def launched_in(self, labels, pred=None) -> float:
        """Device seconds of the operations (named as `pred` accepts)
        launched by a call that started inside a range or span of
        `labels`."""
        return sum(b - a for n, a, b, t in self.ops
                   if t is not None and (pred is None or pred(n))
                   and self._inside(labels, t)) / 1e9

    def host_s(self, label) -> float:
        """Host seconds inside the range or span `label` (outermost
        intervals only, so one re-entered within itself counts once)."""
        total, end = 0, -1
        for a, b in self._intervals(label):
            if a >= end:
                total += b - a
                end = b
            elif b > end:
                total += b - end
                end = b
        return total / 1e9

    def calls(self, label) -> int:
        return len(self._intervals(label))

    def nested(self, name, outer) -> list:
        """[(start, end)] of the spans `name` that lie inside a span
        `outer` (their parent, or a parent's parent)."""
        tree = self.span_tree
        out = []
        for n, a, b, parent in tree:
            if n != name:
                continue
            while parent >= 0 and tree[parent][0] != outer:
                parent = tree[parent][3]
            if parent >= 0:
                out.append((a, b))
        return out

    def host_label(self, t) -> str:
        """The innermost benchmark range open on the host at time t."""
        return _innermost({k: v for k, v in self.ranges.items()
                           if k != "window"}, t, "outside every range")

    def span_label(self, t) -> str:
        """The innermost span of the port open on the host at time t."""
        return _innermost(self.spans, t, "outside every span")

    def idle_gaps(self, label_at) -> dict:
        """Idle ns of the window's gaps between device operations, by the
        label `label_at` gives each gap's start."""
        gaps: dict[str, int] = {}
        busy = self.busy_intervals()
        edges = [self.t0] + [x for ab in busy for x in ab] + [self.t1]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                label = label_at(a)
                gaps[label] = gaps.get(label, 0) + (b - a)
        return gaps

    def breakdown(self, top: int = 10) -> dict:
        by_name: dict[str, int] = {}
        for n, a, b, _ in self.ops:
            by_name[n] = by_name.get(n, 0) + (b - a)

        def largest(d):
            return sorted(d.items(), key=lambda kv: -kv[1])[:top]
        return {"device_ops": [[n[:120], v / 1e9]
                               for n, v in largest(by_name)],
                "idle_gaps": [[n, v / 1e9] for n, v in
                              largest(self.idle_gaps(self.host_label))],
                "idle_gaps_by_span": [[n, v / 1e9] for n, v in largest(
                    self.idle_gaps(self.span_label))]}


class Window:
    """The profiler over [start(), stop()], with the range WINDOW around
    it and the port's telemetry on from just before the profiler starts
    to just after it stops; the trace carries `telemetry.records()`: the
    keyed records of that span of time, the launch totals of the process. Only the user scope is recorded on the host (the
    benchmark's ranges and the port's spans), not every operator, so the
    host runs near its untraced pace; the device's operations and the
    runtime calls that launched them come from CUPTI."""

    def __init__(self):
        from torch._C._profiler import (ProfilerActivity, ProfilerConfig,
                                        ProfilerState, _ExperimentalConfig)
        self.config = ProfilerConfig(ProfilerState.KINETO, False, False,
                                     False, False, False,
                                     _ExperimentalConfig())
        self.activities = {ProfilerActivity.CPU}
        if torch.cuda.is_available():
            self.activities.add(ProfilerActivity.CUDA)
        self.rf = self.recording = None

    def start(self):
        from torch._C._profiler import RecordScope
        from torch.autograd import _enable_profiler, _prepare_profiler
        from repro_torch import telemetry
        self.recording = telemetry.recording()
        self.recording.__enter__()
        _prepare_profiler(self.config, self.activities)
        _enable_profiler(self.config, self.activities,
                         {RecordScope.USER_SCOPE})
        self.rf = torch.profiler.record_function(WINDOW)
        self.rf.__enter__()

    def stop(self) -> Trace:
        from torch.autograd import _disable_profiler
        from repro_torch import telemetry
        if torch.cuda.is_available():
            torch.cuda.synchronize()
        self.rf.__exit__(None, None, None)
        events = _disable_profiler().events()
        self.recording.__exit__(None, None, None)
        trace = Trace(events)
        trace.records = telemetry.records()
        return trace
