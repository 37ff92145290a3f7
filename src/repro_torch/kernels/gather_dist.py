"""Wrapper of the `gather_dist` CUDA kernel (csrc/gather_dist.cu).

The counterpart of the JAX package's Pallas `gather_dist`
(src/repro/kernels/gather_dist.py): (Q, d) queries, (n, d) database,
(Q, M) int32 ids -> (Q, M) f32 distances, +inf where an id is < 0.
`launches` counts the kernel launches made through this wrapper.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

METRIC_CODES = {"l2": 0, "ip": 1}
launches = 0
# the C launcher's signature: pointers, ints, stream
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def check(t: torch.Tensor, name: str, dtype: torch.dtype, ndim: int) -> None:
    """Raise unless `t` is a contiguous CUDA tensor of the given type."""
    if not t.is_cuda:
        raise ValueError(f"{name} must be a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name} must be {dtype}, got {t.dtype}")
    if t.dim() != ndim:
        raise ValueError(f"{name} must have {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name} must be contiguous")


def stream_ptr(t: torch.Tensor) -> ctypes.c_void_p:
    return ctypes.c_void_p(torch.cuda.current_stream(t.device).cuda_stream)


def raise_on(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"{kernel} launch failed: cudaError {err}")


def gather_dist(q: torch.Tensor, db: torch.Tensor, ids: torch.Tensor,
                metric: str) -> torch.Tensor:
    global launches
    check(q, "q", torch.float32, 2)
    check(db, "db", torch.float32, 2)
    check(ids, "ids", torch.int32, 2)
    Q, d = q.shape
    M = ids.shape[1]
    if db.shape[1] != d or ids.shape[0] != Q:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"db {tuple(db.shape)}, ids {tuple(ids.shape)}")
    if not (q.device == db.device == ids.device):
        raise ValueError("q, db and ids must lie on one device")
    out = torch.empty((Q, M), dtype=torch.float32, device=q.device)
    if Q == 0 or M == 0:
        return out
    fn = _build.function("gather_dist", "gather_dist_f32", _ARGTYPES)
    err = fn(ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(db.data_ptr()),
             ctypes.c_void_p(ids.data_ptr()), ctypes.c_void_p(out.data_ptr()),
             ctypes.c_int(Q), ctypes.c_int(M), ctypes.c_int(d),
             ctypes.c_int(METRIC_CODES[metric]), stream_ptr(q))
    raise_on(err, "gather_dist")
    launches += 1
    return out
