"""The port's own telemetry: named spans at the layer boundaries of
serving and training, and keyed records of what the kernels were launched
on. Off unless a caller is inside `recording()`.

    with telemetry.recording():           # on, records cleared
        engine.submit_all(requests)
    telemetry.records()                   # {"launches": ..., "keyed": ...}

`span(name)` marks a region of the host's work. While telemetry is off it
returns one shared object whose enter and exit do nothing: no string is
built, nothing is allocated, no profiler call is made. While it is on it
opens the user-scope range "repro_torch." + name, the range
`torch.profiler.record_function` opens: a running `torch.profiler` stamps
it on the clock of its device events, and spans opened inside it on the
same thread are its children. While a step is traced to be exported or
counted (`device.tracing()`) every span is a no-op.

`count(name, key, n=1)` adds n to the record `name` under `key` (a shape,
a length, a position) while telemetry is on. The kernels' launch totals
(`kernels/ops.launch_counts()`) stay always on; `records()` returns them
beside the keyed records.

While a CUDA graph is captured, `notes_begin()` / `notes_end()` keep, on
or off, the names of the spans opened and the records counted in between,
so that a replay of the graph, which runs no Python of the model, can
open and count them again (`serve/decode_graph.py`). Inside `cut_at(names,
cut)` a span of one of those names calls `cut()` where it opens and where
it closes, so that a capture can end the graph there and begin the next
(`serve/prefill_graph.py`).
"""
from __future__ import annotations

import contextlib

import torch

from .device import tracing

PREFIX = "repro_torch."

_ON = False
_KEYED: dict[str, dict] = {}
_NOTES: list | None = None
_CUT: tuple | None = None       # (span names, cut) inside `cut_at`


class _Off:
    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


OFF = _Off()


class _Span:
    """The user-scope range `torch.profiler.record_function` opens,
    entered by a direct call instead of a dispatched operator: under a
    running profiler, under half its host cost."""
    __slots__ = ("name", "handle")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.handle = torch.autograd._record_function_with_args_enter(
            self.name)
        return self

    def __exit__(self, *exc):
        torch.autograd._record_function_with_args_exit(self.handle)
        return False


class _Cut:
    """A span at which a capture is cut (`cut_at`): it opens no range; its
    note goes to the graph begun where it opens."""
    __slots__ = ("name",)

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        _CUT[1]()
        _NOTES.append(("span", self.name))
        return None

    def __exit__(self, exc_type, *exc):
        if exc_type is None:
            _CUT[1]()
        return False


def on() -> bool:
    return _ON


def span(name: str):
    """A context manager around a region named `name` (static: each name
    is listed in PERF.md with the metric it feeds)."""
    if _CUT is not None and name in _CUT[0]:
        return _Cut(name)
    if _NOTES is not None:
        _NOTES.append(("span", name))
    if not _ON or tracing():
        return OFF
    return _Span(PREFIX + name)


def count(name: str, key, n: int = 1) -> None:
    if _NOTES is not None:
        _NOTES.append(("count", name, key, n))
    if _ON:
        rec = _KEYED.setdefault(name, {})
        rec[key] = rec.get(key, 0) + n


def shapes(*tensors) -> tuple:
    """A launch's key: (shape, element size) of each tensor it was given."""
    return tuple((tuple(t.shape), t.element_size()) for t in tensors)


def notes_begin() -> None:
    """Keep the spans opened and the records counted from here on."""
    global _NOTES
    _NOTES = []


def notes_end() -> list:
    """What was kept since `notes_begin()`: ("span", name) and ("count",
    name, key, n), in order; keeping stops."""
    global _NOTES
    out, _NOTES = _NOTES or [], None
    return out


@contextlib.contextmanager
def cut_at(names, cut):
    """Over the block, while notes are kept (`notes_begin`): each span
    named in `names` calls `cut()` as it opens, then notes itself, and
    calls `cut()` again as it closes (not where an exception leaves it)."""
    global _CUT
    _CUT = (frozenset(names), cut)
    try:
        yield
    finally:
        _CUT = None


@contextlib.contextmanager
def recording():
    """Telemetry on over the block, with the keyed records cleared at its
    start; they stay readable after it until the next recording. Not
    nested: the inner block's end turns telemetry off."""
    global _ON
    _KEYED.clear()
    _ON = True
    try:
        yield
    finally:
        _ON = False


def records() -> dict:
    """{"launches": every kernel's launch total, "keyed": {name: {key:
    count}}} (copies)."""
    from .kernels.ops import launch_counts
    return {"launches": launch_counts(),
            "keyed": {k: dict(v) for k, v in _KEYED.items()}}
