"""Spans and counters inside the port's search, kept in memory.

    from repro_torch import spans
    spans.enable()
    with spans.span("search", family="graph", Q=1000, k=10):
        with spans.span("search.seed"):
            ...
        spans.count("sync")
    recs = spans.records()

Off by default. Off, `span` returns one shared no-op context manager and
`count` returns at once, each after one check of a module flag: no clock
read, no record. On, a span records its name, its start and end on
`time.perf_counter_ns()`, its parent (the innermost span open on the same
thread when it started, -1 for none) and a call id: the id of its
outermost span, so every span of one `KBest.search` call shares it. A
count records its name, time and amount, and the innermost open span and
call (-1 outside any). No span syncs the device, reads a tensor or holds
one. Records stay in one list of at most `CAP`; later ones are counted in
`dropped()` and not kept. There is no exporter: the benchmark's metric
readers (portbench/metrics/) read `records()`.

The clock is the one the benchmark marks its window on. `profiler_ns`
maps it onto `torch.profiler`'s clock, the wall clock (`time.time_ns()`)
that the profiler's host events and CUPTI's device activity are stamped
in, linearly between two (perf_counter_ns, time_ns) anchors: one taken
at `enable()`, one at the latest `records()`.
"""
from __future__ import annotations

import itertools
import threading
import time
from typing import List, NamedTuple, Optional, Tuple, Union

CAP = 2_000_000


class Span(NamedTuple):
    name: str
    start: int              # perf_counter_ns
    end: int
    id: int
    parent: int             # the enclosing span's id, -1 for an outermost
    call: int               # the outermost span's id
    attrs: Optional[dict]


class Count(NamedTuple):
    name: str
    t: int                  # perf_counter_ns
    n: int
    parent: int             # the innermost open span's id, -1 outside any
    call: int               # -1 outside any


Record = Union[Span, Count]

_on = False
_records: List[Record] = []
_dropped = 0
_lock = threading.Lock()
_ids = itertools.count()
_local = threading.local()
_first: Optional[Tuple[int, int]] = None    # anchor at enable()
_last: Optional[Tuple[int, int]] = None     # anchor at records()


class _NoSpan:
    """The shared no-op context manager of a span site while off."""
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NO_SPAN = _NoSpan()


class _OpenSpan:
    __slots__ = ("name", "attrs", "id", "parent", "call", "start")

    def __init__(self, name: str, attrs: Optional[dict]):
        self.name, self.attrs = name, attrs

    def __enter__(self):
        stack = _stack()
        self.id = next(_ids)
        if stack:
            self.parent, self.call = stack[-1].id, stack[-1].call
        else:
            self.parent, self.call = -1, self.id
        stack.append(self)
        self.start = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _stack().pop()
        _append(Span(self.name, self.start, end, self.id, self.parent,
                     self.call, self.attrs))
        return False


def _stack() -> list:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


def _append(rec: Record) -> None:
    global _dropped
    if len(_records) < CAP:
        _records.append(rec)
    else:
        with _lock:
            _dropped += 1


def span(name: str, **attrs):
    """A context manager that records one span while the recorder is on,
    and the shared `NO_SPAN` while it is off."""
    if not _on:
        return NO_SPAN
    return _OpenSpan(name, attrs or None)


def count(name: str, n: int = 1) -> None:
    """Record `n` of `name` now, inside the innermost open span."""
    if not _on:
        return
    stack = _stack()
    top = stack[-1] if stack else None
    _append(Count(name, time.perf_counter_ns(), n,
                  top.id if top else -1, top.call if top else -1))


def _anchor() -> Tuple[int, int]:
    a = time.perf_counter_ns()
    wall = time.time_ns()
    b = time.perf_counter_ns()
    return (a + b) // 2, wall


def enable() -> None:
    """Start recording (kept records stay); takes the first clock anchor
    when the recorder was off."""
    global _on, _first
    if not _on:
        _first = _anchor()
        _on = True


def disable() -> None:
    global _on
    _on = False


def enabled() -> bool:
    return _on


def clear() -> None:
    """Drop every record and the count of dropped ones."""
    global _dropped
    with _lock:
        _records.clear()
        _dropped = 0


def records() -> List[Record]:
    """A copy of the records, in the order they ended; takes the second
    clock anchor."""
    global _last
    _last = _anchor()
    return list(_records)


def dropped() -> int:
    """Records not kept because `CAP` were held."""
    return _dropped


def profiler_ns(t: int) -> int:
    """A perf_counter_ns time on the profiler's (wall) clock."""
    if _first is None:
        raise RuntimeError("the recorder was never enabled")
    p0, w0 = _first
    if _last is None or _last[0] == p0:
        return w0 + (t - p0)
    p1, w1 = _last
    return w0 + (t - p0) * (w1 - w0) // (p1 - p0)
