"""Wrappers of the fused beam-step CUDA kernels (csrc/traverse_step.cu):
`fused_expand`, `fused_expand_sq` and `fused_expand_pq`.

The counterparts of the JAX package's Pallas kernels of the same names
(src/repro/kernels/traverse_step.py): (Q, C = W*M) int32 candidate ids,
scored against (Q, d) queries over an (n, d) f32 database, over (n, d) u8
SQ codes with (d,) scale and zero, or through (Q, m, K) PQ tables over
(n, m) u8 codes -> sorted dists (Q, T), ids (Q, T), per-expansion bests
(Q, W) and earlier-expansion tie counts (Q, W), T = min(L, C).
`launches` counts, per kernel, the launches made through these wrappers.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gather_dist import (METRIC_CODES, check_affine,
                                             check_rows, check_tables,
                                             raise_on, stream_ptr)

MAX_C = 4096
launches = {"fused_expand": 0, "fused_expand_sq": 0, "fused_expand_pq": 0}
# the C launchers' signatures: pointers, ints, stream
_P, _I, _S = ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p
_ARGTYPES = {"fused_expand_f32": [_P] * 7 + [_I] * 6 + [_S],
             "fused_expand_sq_u8": [_P] * 9 + [_I] * 6 + [_S],
             "fused_expand_pq_u8": [_P] * 7 + [_I] * 6 + [_S]}


def _launch(kernel: str, symbol: str, ids: torch.Tensor, L: int, n_beam: int,
            lead: list, tail: list):
    """Allocate the four outputs, call `symbol` with the pointers `lead`,
    ids, the outputs, (Q, C, T, W) and the ints `tail`, and count it."""
    Q, C = ids.shape
    if not 1 <= C <= MAX_C or C % n_beam:
        raise ValueError(f"C={C} must lie in [1, {MAX_C}] and be a "
                         f"multiple of n_beam={n_beam}")
    T = min(L, C)
    dev = ids.device
    outs = (torch.empty((Q, T), dtype=torch.float32, device=dev),
            torch.empty((Q, T), dtype=torch.int32, device=dev),
            torch.empty((Q, n_beam), dtype=torch.float32, device=dev),
            torch.empty((Q, n_beam), dtype=torch.int32, device=dev))
    if Q == 0:
        return outs
    fn = _build.function("traverse_step", symbol, _ARGTYPES[symbol])
    ptrs = [ctypes.c_void_p(t.data_ptr()) for t in (*lead, ids, *outs)]
    ints = [ctypes.c_int(v) for v in (Q, C, T, n_beam, *tail)]
    raise_on(fn(*ptrs, *ints, stream_ptr(ids)), kernel)
    launches[kernel] += 1
    return outs


def fused_expand(q: torch.Tensor, db: torch.Tensor, ids: torch.Tensor,
                 metric: str, L: int, n_beam: int):
    check_rows(q, db, ids, torch.float32)
    return _launch("fused_expand", "fused_expand_f32", ids, L, n_beam,
                   [q, db], [q.shape[1], METRIC_CODES[metric]])


def fused_expand_sq(q: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
                    zero: torch.Tensor, ids: torch.Tensor, metric: str, L: int,
                    n_beam: int):
    check_rows(q, codes, ids, torch.uint8, scale, zero)
    scale, zero = check_affine(scale, zero, q.shape[1])
    return _launch("fused_expand_sq", "fused_expand_sq_u8", ids, L, n_beam,
                   [q, codes, scale, zero],
                   [q.shape[1], METRIC_CODES[metric]])


def fused_expand_pq(lut: torch.Tensor, codes: torch.Tensor, ids: torch.Tensor,
                    L: int, n_beam: int):
    check_tables(lut, codes, ids)
    _, m, K = lut.shape
    return _launch("fused_expand_pq", "fused_expand_pq_u8", ids, L, n_beam,
                   [lut, codes], [m, K])
