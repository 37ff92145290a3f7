"""The traced run's device trace, reduced to the numbers readers need.

`Tracer` runs `torch.profiler` over the measured window with CUDA
activity only: the device's kernels, copies and fills, and the host's
CUDA API calls that CUPTI records beside them. Host operators are not
recorded: on an H100 host, recording them slowed the graph cell's host
loop 2.5x, where CUDA activity alone costs it 10-15%.

The reduction reads the profiler's raw events, without building its
function-event tree. Kernels are told apart by the program's kernel
names; an idle gap is named after the host's CUDA call open at its middle
("host: no CUDA call" where the host was in Python between calls).
"""
from __future__ import annotations

import bisect
import re
from collections import defaultdict
from typing import List, Optional, Tuple

import torch

_NAME_CHARS = 120
NO_CALL = "host: no CUDA call"


def _activity(e) -> str:
    """The event's activity type, "" where torch's events carry none
    (torch 2.11): kernels and copies are then told apart by name."""
    return str(e.activity_type()) if hasattr(e, "activity_type") else ""


class Tracer:
    """Context manager over the window; `summary()` reduces the trace.
    On the host (the tests), which has no CUDA activity, it records the
    host's operators instead, and no device activity."""

    def __init__(self, enabled: bool, on_card: bool = True):
        self.enabled, self.on_card = enabled, on_card
        self._prof = None

    def __enter__(self):
        if self.enabled:
            from torch.profiler import ProfilerActivity, profile
            self._prof = profile(activities=[
                ProfilerActivity.CUDA if self.on_card
                else ProfilerActivity.CPU])
            self._prof.__enter__()
        return self

    def __exit__(self, *exc):
        if self._prof is not None:
            self._prof.__exit__(*exc)
        return False

    def summary(self) -> "TraceSummary":
        return TraceSummary(self._prof.profiler.kineto_results.events())


class TraceSummary:
    """Device activities of the traced window and the host's CUDA calls."""

    def __init__(self, events):
        self.activity_types = defaultdict(int)
        host = []               # (start_ns, end_ns, name)
        device = []             # (start_ns, end_ns, name, kind)
        for e in events:
            act = _activity(e)
            name = e.name()
            start = e.start_ns()
            end = start + e.duration_ns()
            on_device = e.device_type() == torch.autograd.DeviceType.CUDA
            self.activity_types[(on_device, act)] += 1
            if on_device:
                if "annotation" in act:
                    continue
                copy = ("memcpy" in act or "memset" in act or not act
                        and name.startswith(("Memcpy", "Memset")))
                device.append((start, end, name,
                               "copy" if copy else "kernel"))
            else:
                host.append((start, end, name))
        self.device = device
        self._host = sorted(host)

    # ---------------------------------------------------------- readings
    def busy_s(self) -> float:
        """Seconds in which some device activity ran (their union)."""
        return sum(b - a for a, b in _union(self.device)) / 1e9

    def kernels(self, pattern: Optional[str] = None) -> list:
        """Kernel activities, all or those whose name matches the regular
        expression `pattern`."""
        rx = re.compile(pattern) if pattern else None
        return [d for d in self.device if d[3] == "kernel"
                and (rx is None or rx.search(d[2]))]

    def device_s(self, pattern: str) -> float:
        """Summed device seconds of the kernels matching `pattern`."""
        return sum(b - a for a, b, *_ in self.kernels(pattern)) / 1e9

    def describe(self) -> dict:
        """Counts that show whether the trace was read whole."""
        return {"device_activities": len(self.device),
                "kernels": len(self.kernels()),
                "host_calls": len(self._host),
                "types": {f"{'device' if d else 'host'}:{a}": n
                          for (d, a), n in self.activity_types.items()}}

    def breakdown(self, top: int = 10) -> dict:
        """The device operations that took most time, and the idle gaps
        summed by the host's CUDA call open at their midpoint."""
        ops = defaultdict(int)
        for a, b, name, _ in self.device:
            ops[name[:_NAME_CHARS]] += b - a
        gaps = defaultdict(int)
        busy = _union(self.device)
        for (_, end), (nxt, _) in zip(busy, busy[1:]):
            gaps[self._host_at((end + nxt) // 2)] += nxt - end
        return {"device_ops": _rank(ops, top), "idle_gaps": _rank(gaps, top)}

    def _host_at(self, t: int) -> str:
        lst = self._host
        i = bisect.bisect_right(lst, (t, float("inf"), "")) - 1
        for j in range(i, max(i - 64, -1), -1):
            if lst[j][1] >= t:
                return lst[j][2][:_NAME_CHARS]
        return NO_CALL


def _rank(d: dict, top: int) -> list:
    return sorted(([k, v / 1e9] for k, v in d.items()),
                  key=lambda kv: -kv[1])[:top]


def _union(acts) -> List[Tuple[int, int]]:
    out: List[List[int]] = []
    for a, b, *_ in sorted(acts):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]
