"""Dispatch of the port's kernels by the device of the tensors given.

A CUDA tensor goes to the hand-written kernel (csrc/*.cu), which launches
or raises; a CPU tensor goes to the plain torch version in `ref.py`, the
way the JAX package runs its Pallas kernels in interpret mode on the CPU.
There is no fallback from one to the other. Unlike the JAX package's
`ops.py`, nothing is padded to a 128-lane width: that is a TPU layout
rule, and the kernels mask their own ragged edges.

Every metric other than "l2" is an inner product here ("cosine" vectors
are normalized at add() time), as in the JAX package.
"""
from __future__ import annotations

from typing import Dict

import torch

from repro_torch.kernels import batch_dist as _bd
from repro_torch.kernels import gather_dist as _gd
from repro_torch.kernels import pq_adc as _pq
from repro_torch.kernels import ref
from repro_torch.kernels import traverse_step as _ts

# each wrapper module's `launches` maps its kernels' names to their counts
_WRAPPERS = (_gd, _ts, _bd, _pq)


def _kernel_metric(metric: str) -> str:
    return "l2" if metric == "l2" else "ip"


def batch_dist(q: torch.Tensor, x: torch.Tensor, *,
               metric: str = "l2") -> torch.Tensor:
    """(Q, d) x (B, d) -> (Q, B) distance matrix."""
    if q.is_cuda:
        return _bd.batch_dist(q, x, _kernel_metric(metric))
    return ref.batch_dist_ref(q, x, _kernel_metric(metric))


def gather_dist(q: torch.Tensor, db: torch.Tensor, ids: torch.Tensor, *,
                metric: str = "l2") -> torch.Tensor:
    """(Q, d), (n, d), (Q, M) int32 -> (Q, M); -1 ids produce +inf."""
    if q.is_cuda:
        return _gd.gather_dist(q, db, ids, _kernel_metric(metric))
    return ref.gather_dist_ref(q, db, ids, _kernel_metric(metric))


def fused_expand(q: torch.Tensor, db: torch.Tensor, ids: torch.Tensor, *,
                 metric: str = "l2", L: int, n_beam: int = 1):
    """(Q, d), (n, d), (Q, C) int32 -> (sorted dists (Q, T), ids (Q, T),
    per-expansion bests (Q, n_beam), earlier-expansion tie counts
    (Q, n_beam)) with T = min(L, C); -1 ids -> +inf."""
    if q.is_cuda:
        return _ts.fused_expand(q, db, ids, _kernel_metric(metric), L, n_beam)
    return ref.fused_expand_ref(q, db, ids, _kernel_metric(metric), L, n_beam)


def sq_gather_dist(q: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
                   zero: torch.Tensor, ids: torch.Tensor, *,
                   metric: str = "l2") -> torch.Tensor:
    """(Q, d), (n, d) u8 codes, (d,) scale and zero, (Q, M) int32 ->
    (Q, M) distances to the rows code * scale + zero; -1 ids -> +inf."""
    if q.is_cuda:
        return _gd.sq_gather_dist(q, codes, scale, zero, ids,
                                  _kernel_metric(metric))
    return ref.sq_gather_dist_ref(q, codes, scale, zero, ids,
                                  _kernel_metric(metric))


def fused_expand_sq(q: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
                    zero: torch.Tensor, ids: torch.Tensor, *,
                    metric: str = "l2", L: int, n_beam: int = 1):
    """SQ twin of fused_expand over (n, d) u8 codes."""
    if q.is_cuda:
        return _ts.fused_expand_sq(q, codes, scale, zero, ids,
                                   _kernel_metric(metric), L, n_beam)
    return ref.fused_expand_sq_ref(q, codes, scale, zero, ids,
                                   _kernel_metric(metric), L, n_beam)


def pq_adc(lut: torch.Tensor, codes: torch.Tensor,
           ids: torch.Tensor) -> torch.Tensor:
    """(Q, m, K) tables, (n, m) u8 codes, (Q, B) int32 -> (Q, B) ADC
    distances; -1 ids -> +inf."""
    if lut.is_cuda:
        return _pq.pq_adc(lut, codes, ids)
    return ref.pq_adc_ref(lut, codes, ids)


def fused_expand_pq(lut: torch.Tensor, codes: torch.Tensor, ids: torch.Tensor,
                    *, L: int, n_beam: int = 1):
    """PQ-ADC twin of fused_expand over (n, m) u8 codes."""
    if lut.is_cuda:
        return _ts.fused_expand_pq(lut, codes, ids, L, n_beam)
    return ref.fused_expand_pq_ref(lut, codes, ids, L, n_beam)


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far, per kernel (the CPU path launches none)."""
    return {name: n for mod in _WRAPPERS for name, n in mod.launches.items()}


def reset_launch_counts() -> None:
    for mod in _WRAPPERS:
        for name in mod.launches:
            mod.launches[name] = 0
