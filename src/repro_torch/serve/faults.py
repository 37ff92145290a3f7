"""Fault injection for the serving and persistence tiers (DESIGN.md §17),
a copy of the JAX package's `repro/serve/faults.py` over the port's
`core.persist`.

  latency spikes    — per-request virtual service-time penalties (the
                      scheduler's clock, not a real sleep), deterministic
                      by request_id.
  engine exceptions — `poisoned` request_ids make the dispatch raise
                      `EngineFault` inside serve_loop's error boundary;
                      the poisoned request must fail alone.
  clock skew        — a constant offset added to every arrival time;
                      admission uses relative times only, so statuses
                      must not change.

Persistence kill points ride `core.persist.checkpoint`: `trace_steps()`
records every kill point of a save, `crash_at(step)` kills the next save
at exactly that step with `InjectedCrash`.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterable, List, Set

from repro_torch.core import persist


class EngineFault(RuntimeError):
    """Injected engine-side failure (stands in for an out-of-memory error,
    a kernel assert, a poisoned input: anything a dispatch can raise)."""


class InjectedCrash(RuntimeError):
    """Injected kill inside a save protocol step (simulated power loss)."""


@dataclasses.dataclass
class FaultInjector:
    """Deterministic fault plan for one serve_loop drain."""

    latency_spikes: Dict[int, float] = dataclasses.field(default_factory=dict)
    poisoned: Set[int] = dataclasses.field(default_factory=set)
    skew_ms: float = 0.0

    def check(self, group: Iterable) -> None:
        """Raise EngineFault if any request of the dispatch group is
        poisoned; called inside serve_loop's error boundary before the
        engine runs."""
        for r in group:
            if r.request_id in self.poisoned:
                raise EngineFault(
                    f"injected engine failure for request {r.request_id}")

    def extra_ms(self, group: Iterable) -> float:
        """Total virtual service-time penalty of a dispatch group."""
        return float(sum(self.latency_spikes.get(r.request_id, 0.0)
                         for r in group))


@contextlib.contextmanager
def trace_steps(out: List[str]):
    """Record every persist.checkpoint() step fired inside the block: the
    kill points a crash matrix iterates over."""
    def hook(step: str) -> None:
        out.append(step)
    persist.set_crash_hook(hook)
    try:
        yield out
    finally:
        persist.set_crash_hook(None)


@contextlib.contextmanager
def crash_at(step: str):
    """Kill the save running inside the block at the FIRST occurrence of
    `step` (later occurrences run clean, so a re-save inside the same
    block is unaffected)."""
    fired = [False]

    def hook(s: str) -> None:
        if s == step and not fired[0]:
            fired[0] = True
            raise InjectedCrash(f"injected crash at save step '{step}'")
    persist.set_crash_hook(hook)
    try:
        yield
    finally:
        persist.set_crash_hook(None)
