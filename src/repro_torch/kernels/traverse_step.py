"""Wrapper of the `fused_expand` CUDA kernel (csrc/traverse_step.cu).

The counterpart of the JAX package's Pallas `fused_expand`
(src/repro/kernels/traverse_step.py): (Q, d) queries, (n, d) database,
(Q, C = W*M) int32 ids -> sorted dists (Q, T), ids (Q, T), per-expansion
bests (Q, W) and earlier-expansion tie counts (Q, W), T = min(L, C).
`launches` counts the kernel launches made through this wrapper.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gather_dist import (METRIC_CODES, check, raise_on,
                                             stream_ptr)

MAX_C = 4096
launches = 0
# the C launcher's signature: pointers, ints, stream
_ARGTYPES = [ctypes.c_void_p] * 7 + [ctypes.c_int] * 6 + [ctypes.c_void_p]


def fused_expand(q: torch.Tensor, db: torch.Tensor, ids: torch.Tensor,
                 metric: str, L: int, n_beam: int):
    global launches
    check(q, "q", torch.float32, 2)
    check(db, "db", torch.float32, 2)
    check(ids, "ids", torch.int32, 2)
    Q, d = q.shape
    C = ids.shape[1]
    if db.shape[1] != d or ids.shape[0] != Q:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"db {tuple(db.shape)}, ids {tuple(ids.shape)}")
    if not (q.device == db.device == ids.device):
        raise ValueError("q, db and ids must lie on one device")
    if not 1 <= C <= MAX_C or C % n_beam:
        raise ValueError(f"C={C} must lie in [1, {MAX_C}] and be a "
                         f"multiple of n_beam={n_beam}")
    T = min(L, C)
    dev = q.device
    sd = torch.empty((Q, T), dtype=torch.float32, device=dev)
    si = torch.empty((Q, T), dtype=torch.int32, device=dev)
    bests = torch.empty((Q, n_beam), dtype=torch.float32, device=dev)
    ties = torch.empty((Q, n_beam), dtype=torch.int32, device=dev)
    if Q == 0:
        return sd, si, bests, ties
    fn = _build.function("traverse_step", "fused_expand_f32", _ARGTYPES)
    err = fn(ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(db.data_ptr()),
             ctypes.c_void_p(ids.data_ptr()), ctypes.c_void_p(sd.data_ptr()),
             ctypes.c_void_p(si.data_ptr()), ctypes.c_void_p(bests.data_ptr()),
             ctypes.c_void_p(ties.data_ptr()), ctypes.c_int(Q), ctypes.c_int(C),
             ctypes.c_int(T), ctypes.c_int(n_beam), ctypes.c_int(d),
             ctypes.c_int(METRIC_CODES[metric]), stream_ptr(q))
    raise_on(err, "fused_expand")
    launches += 1
    return sd, si, bests, ties
