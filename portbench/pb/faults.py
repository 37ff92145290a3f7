"""The control and the planted faults that the comparison must reject.

* `ControlSystem`: the plain reference in the program's place, one
  precision below what the configurations state (TF32 products for
  float32; pb.reference.control_topk).
* `plant(name, kind)`: a context manager that breaks the program
  underneath the measured call (kind: the index type, "graph" or
  "ivf"), and yields how to wrap the system's call:
    - "state_unchanged": a step returns its state unchanged (graph: the
      traversal's queue merge keeps the queue; IVF: the probe step keeps
      its starting lists 0..P-1 for every query);
    - "half_left_out": half of each batch is left out and answered with
      the other half's answers;
    - "answer_altered": an answer is altered where it is produced (graph:
      the first id of each fused_expand output moves to the next row;
      IVF: the first exact re-rank distance of each query gains 1e-3).
  The exchange between chips does not exist on one chip.

Used by calibrate.py (on the card, at the cells' own sizes) and by the
tests (on the host, at a small size).
"""
from __future__ import annotations

import contextlib

import numpy as np

from pb.reference import control_topk

FAULTS = ("state_unchanged", "half_left_out", "answer_altered")


class ControlSystem:
    def __init__(self, base: np.ndarray, metric: str, device: str):
        self.base, self.metric, self.device = base, metric, device

    def search(self, queries: np.ndarray, k: int):
        d, i = control_topk(self.base, queries, k, self.metric, self.device)
        return d, i, None


@contextlib.contextmanager
def _patched(module, name, fn):
    orig = getattr(module, name)
    setattr(module, name, fn(orig))
    try:
        yield
    finally:
        setattr(module, name, orig)


@contextlib.contextmanager
def plant(name: str, kind: str):
    """Break the program for the duration of the block; yields a function
    that turns the system's call (queries, k) -> (dists, ids, stats) into
    the call to measure."""
    import torch
    from repro_torch.core import ivf as ivf_mod
    from repro_torch.core import queue as qmod
    from repro_torch.kernels import ops

    same = lambda search: search                      # noqa: E731
    if name == "half_left_out":
        def halved(search):
            def call(q, k):
                h = len(q) // 2
                d, i, st = search(q[:h], k)
                return (np.concatenate([d, d[:len(q) - h]]),
                        np.concatenate([i, i[:len(q) - h]]), st)
            return call
        yield halved
    elif name == "state_unchanged" and kind == "graph":
        with _patched(qmod, "merge_sorted_runs",
                      lambda orig: lambda queue, sd, si: queue):
            yield same
    elif name == "state_unchanged":
        def first_lists(orig):
            def probes(state, q, nprobe, metric):
                P = min(nprobe, state.nlist)
                return torch.arange(P, dtype=torch.int32, device=q.device
                                    ).expand(q.shape[0], P).contiguous()
            return probes
        with _patched(ivf_mod, "select_probes", first_lists):
            yield same
    elif name == "answer_altered" and kind == "graph":
        def moved(orig):
            def fused_expand(q, db, ids, **kw):
                sd, si, bests, ties = orig(q, db, ids, **kw)
                si = si.clone()
                si[:, 0] = torch.where(si[:, 0] >= 0,
                                       (si[:, 0] + 1) % db.shape[0],
                                       si[:, 0])
                return sd, si, bests, ties
            return fused_expand
        with _patched(ops, "fused_expand", moved):
            yield same
    elif name == "answer_altered":
        def shifted(orig):
            def gather_dist(q, db, ids, **kw):
                d = orig(q, db, ids, **kw).clone()
                d[:, 0] += 1e-3
                return d
            return gather_dist
        with _patched(ops, "gather_dist", shifted):
            yield same
    else:
        raise ValueError(f"unknown fault {name!r}")
