"""The program's own spans and counts (`repro_torch/spans.py`), for the
metric readers, set against the device trace.

A reader of them calls `recorder()` when it is imported. That turns the
program's recorder on: the harness imports the per-layer readers only in
a `--trace 1` run, after the build and before the warm-up, so the
recorder is off in every `--trace 0` run. A program without the recorder
(a commit older than it) gives None, and its readers read nothing.

`Window` keeps the records that start inside the measured window, their
times mapped onto the profiler's clock, on which the device intervals and
the host's CUDA calls of `run.summary` (pb.tracing) lie too. The idle
time of the device inside the window, the complement of the union of
those intervals, is then put down to the innermost span open at each
instant, or to "outside the program".
"""
from __future__ import annotations

import bisect
from collections import defaultdict
from typing import Dict, List, Optional, Tuple

from pb.tracing import NO_CALL, _union

ROOT = "search"                 # the span of one KBest.search call
OUTSIDE = "outside the program"
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC")


def recorder():
    """The program's recorder, turned on; None where the program has
    none."""
    try:
        from repro_torch import spans
    except ImportError:
        return None
    spans.enable()
    return spans


class Window:
    """The records of the measured window: `spans` (start, end, name,
    id, parent) on the profiler's clock, `counts` by name, `calls` (the
    root spans), and the window's bounds `lo`, `hi` on that clock. A
    window without a call keeps no spans and maps no time."""

    def __init__(self, run, rec, to_clock=None):
        lo = round(run.marks["window"] * 1e9)
        hi = lo + round(run.window_s * 1e9)
        records = rec.records()
        self.counts: Dict[str, int] = defaultdict(int)
        for r in records:
            if isinstance(r, rec.Count) and lo <= r.t < hi:
                self.counts[r.name] += r.n
        self.dropped = rec.dropped()
        spans = [r for r in records
                 if isinstance(r, rec.Span) and lo <= r.start < hi]
        self.spans, self.calls = [], []
        if not any(r.name == ROOT and r.parent == -1 for r in spans):
            return
        to_clock = to_clock or rec.profiler_ns
        self.lo, self.hi = to_clock(lo), to_clock(hi)
        self.spans = [(to_clock(r.start), to_clock(r.end), r.name, r.id,
                       r.parent) for r in spans]
        self.calls = [(a, b) for a, b, name, _, parent in self.spans
                      if name == ROOT and parent == -1]

    def durations(self, name: str) -> List[int]:
        return [b - a for a, b, n, *_ in self.spans if n == name]


def window(run) -> Optional[Window]:
    """The window's records; None where the program has no recorder or
    the window served no call that it recorded."""
    rec = recorder()
    if rec is None:
        return None
    w = Window(run, rec)
    return w if w.calls else None


def innermost(spans) -> List[Tuple[int, int, str]]:
    """(start, end, name) pieces of time, each the part of one span that
    none of its children covers, in time order. `spans` nest (one thread);
    their pieces sum to each span's self time."""
    out, stack, cursor = [], [], 0
    for a, b, name, *_ in sorted(spans, key=lambda s: (s[0], -s[1])):
        while stack and stack[-1][0] <= a:
            end, top = stack.pop()
            out.append((cursor, end, top))
            cursor = end
        if stack:
            out.append((cursor, a, stack[-1][1]))
        cursor = a
        stack.append((b, name))
    while stack:
        end, top = stack.pop()
        out.append((cursor, end, top))
        cursor = end
    return [p for p in out if p[1] > p[0]]


def idle(device, lo: int, hi: int) -> List[Tuple[int, int]]:
    """The intervals of [lo, hi) in which no device activity ran."""
    out, t = [], lo
    for a, b in _union(device):
        if b <= t:
            continue
        if a >= hi:
            break
        if a > t:
            out.append((t, a))
        t = max(t, b)
    if t < hi:
        out.append((t, hi))
    return out


def overlap_by(pieces, intervals) -> Dict[str, int]:
    """Nanoseconds of `intervals` (sorted, disjoint) inside `pieces`
    (sorted, disjoint (start, end, name)), summed by name."""
    out: Dict[str, int] = defaultdict(int)
    j = 0
    for a, b, name in pieces:
        while j < len(intervals) and intervals[j][1] <= a:
            j += 1
        k = j
        while k < len(intervals) and intervals[k][0] < b:
            out[name] += min(b, intervals[k][1]) - max(a, intervals[k][0])
            k += 1
    return out


def inside(t: int, calls) -> bool:
    """Whether time `t` lies in one of `calls` (sorted, disjoint)."""
    i = bisect.bisect_right(calls, (t, float("inf"))) - 1
    return i >= 0 and calls[i][0] <= t < calls[i][1]


def piece_at(pieces, starts, t: int) -> str:
    """The name of the piece of `pieces` (with their `starts`) that holds
    time `t`, OUTSIDE where none does."""
    i = bisect.bisect_right(starts, t) - 1
    return pieces[i][2] if i >= 0 and t < pieces[i][1] else OUTSIDE


def idle_report(w: Window, summary) -> dict:
    """The device's idle time in the window, put down to spans:
    `in_calls` (ns inside root spans), `by_span` (ns by innermost span,
    and OUTSIDE), `no_call` (the gaps in which the host was in no CUDA
    call at their middle, pb.tracing's NO_CALL, by the innermost span at
    that middle), `self` (each span name's self ns), `under_child` (the
    share of `in_calls` that a child of the root holds), `launches` and
    `launches_inside` (kernel-launch host calls of the window, all and
    those that start inside a root span: the shared clock's check)."""
    gaps = idle(summary.device, w.lo, w.hi)
    pieces = innermost(w.spans)
    by_span = dict(overlap_by(pieces, gaps))
    starts = [a for a, _, _ in pieces]
    no_call = defaultdict(int)
    for a, b in gaps:
        if summary._host_at((a + b) // 2) == NO_CALL:
            no_call[piece_at(pieces, starts, (a + b) // 2)] += b - a
    total = sum(b - a for a, b in gaps)
    by_span[OUTSIDE] = total - sum(by_span.values())
    calls = sorted(w.calls)
    in_calls = sum(overlap_by([(a, b, ROOT) for a, b in calls],
                              gaps).values())
    own = defaultdict(int)
    for a, b, name in pieces:
        own[name] += b - a
    launches = [a for a, _, name in summary._host
                if name in LAUNCHES and w.lo <= a < w.hi]
    return {"idle": total, "in_calls": in_calls, "by_span": by_span,
            "no_call": dict(no_call), "self": dict(own),
            "under_child": ((in_calls - by_span.get(ROOT, 0)) / in_calls
                            if in_calls else None),
            "launches": len(launches),
            "launches_inside": sum(inside(t, calls) for t in launches)}


def describe(rep: dict, w: Window) -> str:
    """One line for standard error."""
    def secs(d):
        return ", ".join(f"{k} {v / 1e9:.4f}" for k, v in
                         sorted(d.items(), key=lambda kv: -kv[1]))
    share = (100.0 * rep["launches_inside"] / rep["launches"]
             if rep["launches"] else float("nan"))
    under = ("n/a" if rep["under_child"] is None
             else f"{100.0 * rep['under_child']:.2f}%")
    return (f"device idle {rep['idle'] / 1e9:.4f} s of the window, "
            f"{rep['in_calls'] / 1e9:.4f} s inside {len(w.calls)} search "
            f"calls ({under} of it under a child span); idle s by "
            f"innermost span: {secs(rep['by_span'])}; '{NO_CALL}' s by "
            f"innermost span at the gap's middle: {secs(rep['no_call'])}; "
            f"self s: "
            f"{secs(rep['self'])}; kernel launches inside a search span: "
            f"{rep['launches_inside']} of {rep['launches']} ({share:.3f}%)"
            f"; records dropped: {w.dropped}")
