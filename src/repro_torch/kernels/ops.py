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

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import batch_dist as _bd
from repro_torch.kernels import beam_filter as _bf
from repro_torch.kernels import bin_hamming as _bh
from repro_torch.kernels import gather_dist as _gd
from repro_torch.kernels import ivf_scan as _iv
from repro_torch.kernels import pq4_scan as _p4
from repro_torch.kernels import pq_adc as _pq
from repro_torch.kernels import ref
from repro_torch.kernels import traverse_step as _ts

# each wrapper module's `launches` maps its kernels' names to their counts
_WRAPPERS = (_gd, _ts, _bd, _pq, _p4, _bh, _iv, _bf)


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


def pq4_adc(lut: torch.Tensor, packed: torch.Tensor,
            ids: torch.Tensor) -> torch.Tensor:
    """(Q, m, 16) tables, (n, m/2) u8 nibble-packed codes, (Q, B) int32 ->
    (Q, B) ADC distances; -1 ids -> +inf."""
    if lut.is_cuda:
        return _p4.pq4_adc(lut, packed, ids)
    return ref.pq4_adc_ref(lut, packed, ids)


def fused_expand_pq4(lut: torch.Tensor, packed: torch.Tensor,
                     ids: torch.Tensor, *, L: int, n_beam: int = 1):
    """PQ4 twin of fused_expand over (n, m/2) nibble-packed codes."""
    if lut.is_cuda:
        return _ts.fused_expand_pq4(lut, packed, ids, L, n_beam)
    return ref.fused_expand_pq4_ref(lut, packed, ids, L, n_beam)


def bin_dist(qcodes: torch.Tensor, codes: torch.Tensor,
             ids: torch.Tensor) -> torch.Tensor:
    """(Q, nw) int32 query sign words, (n, nw) int32 code words, (Q, B)
    int32 -> (Q, B) exact Hamming distances in f32; -1 ids -> +inf."""
    if qcodes.is_cuda:
        return _bh.bin_dist(qcodes, codes, ids)
    return ref.bin_dist_ref(qcodes, codes, ids)


def fused_expand_bin(qcodes: torch.Tensor, codes: torch.Tensor,
                     ids: torch.Tensor, *, L: int, n_beam: int = 1):
    """Hamming twin of fused_expand over (n, nw) int32 sign words."""
    if qcodes.is_cuda:
        return _ts.fused_expand_bin(qcodes, codes, ids, L, n_beam)
    return ref.fused_expand_bin_ref(qcodes, codes, ids, L, n_beam)


def ivf_scan(luts: torch.Tensor, list_codes: torch.Tensor,
             list_ids: torch.Tensor, probe_ids: torch.Tensor, *, L: int):
    """(Q, Pl, m, K) tables (Pl in {1, P}), (nlist, max_len, m) u8 list
    codes, (nlist, max_len) int32 list ids, (Q, P) int32 probes -> each
    probed list's top-L (dists (Q, P, L) ascending, ids (Q, P, L), -1
    where +inf); 1 <= L <= max_len."""
    if luts.is_cuda:
        return _iv.ivf_scan(luts, list_codes, list_ids, probe_ids, L)
    return ref.ivf_scan_ref(luts, list_codes, list_ids, probe_ids, L)


def pq4_ivf_scan(luts: torch.Tensor, list_codes: torch.Tensor,
                 list_ids: torch.Tensor, probe_ids: torch.Tensor, *, L: int):
    """PQ4 twin of ivf_scan: (Q, Pl, m, 16) tables, (nlist, max_len, m/2)
    nibble-packed list codes."""
    if luts.is_cuda:
        return _p4.pq4_ivf_scan(luts, list_codes, list_ids, probe_ids, L)
    return ref.pq4_ivf_scan_ref(luts, list_codes, list_ids, probe_ids, L)


def bin_ivf_scan(qcodes: torch.Tensor, list_codes: torch.Tensor,
                 list_ids: torch.Tensor, probe_ids: torch.Tensor, *, L: int):
    """Hamming twin of ivf_scan: (Q, nw) int32 query words, (nlist,
    max_len, nw) int32 list words; exact."""
    if qcodes.is_cuda:
        return _bh.bin_ivf_scan(qcodes, list_codes, list_ids, probe_ids, L)
    return ref.bin_ivf_scan_ref(qcodes, list_codes, list_ids, probe_ids, L)


def beam_filter(v: torch.Tensor, graph: torch.Tensor,
                queue_ids: torch.Tensor, bitmap: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The traversal's candidate filter: (Q, W) int32 expanded ids (-1
    where a lane does not expand), (n, M) int32 graph, (Q, L) int32 queue
    ids, optional (Q, nwords) int64 visited bitmap, updated in place ->
    (flat (Q, W*M) int32 neighbor ids in beam order, -1 where invalid,
    repeating an earlier position, visited or queued; n_new (Q,) int32,
    the candidates counted before the queue test)."""
    if v.is_cuda:
        return _bf.beam_filter(v, graph, queue_ids, bitmap)
    return ref.beam_filter_ref(v, graph, queue_ids, bitmap)


def launch_counts() -> Dict[str, int]:
    """Kernel launches so far, per kernel (the CPU path launches none)."""
    return {name: n for mod in _WRAPPERS for name, n in mod.launches.items()}


def reset_launch_counts() -> None:
    for mod in _WRAPPERS:
        for name in mod.launches:
            mod.launches[name] = 0
