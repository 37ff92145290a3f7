"""Wrappers of the `gather_dist` and `sq_gather_dist` CUDA kernels
(csrc/gather_dist.cu).

The counterparts of the JAX package's Pallas `gather_dist` and
`sq_gather_dist` (src/repro/kernels/gather_dist.py): (Q, d) queries,
(n, d) f32 database or u8 SQ codes with (d,) scale and zero, (Q, M) int32
ids -> (Q, M) f32 distances, +inf where an id is < 0. `launches` counts,
per kernel, the launches made through these wrappers.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build

METRIC_CODES = {"l2": 0, "ip": 1}
launches = {"gather_dist": 0, "sq_gather_dist": 0}
# the C launchers' signatures: pointers, ints, stream
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
_SQ_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


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


def check_rows(q: torch.Tensor, rows: torch.Tensor, ids: torch.Tensor,
               rows_dtype: torch.dtype, *extra: torch.Tensor) -> None:
    """The gather kernels' common checks: q (Q, d) f32, rows (n, d) of
    `rows_dtype`, ids (Q, C) int32, every tensor on one device."""
    check(q, "q", torch.float32, 2)
    check(rows, "rows", rows_dtype, 2)
    check(ids, "ids", torch.int32, 2)
    if rows.shape[1] != q.shape[1] or ids.shape[0] != q.shape[0]:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"rows {tuple(rows.shape)}, ids {tuple(ids.shape)}")
    if any(t.device != q.device for t in (rows, ids, *extra)):
        raise ValueError("all operands must lie on one device")


def check_tables(lut: torch.Tensor, codes: torch.Tensor,
                 ids: torch.Tensor) -> None:
    """The PQ kernels' common checks: lut (Q, m, K) f32, codes (n, m) u8,
    ids (Q, C) int32, every tensor on one device."""
    check(lut, "lut", torch.float32, 3)
    check(codes, "codes", torch.uint8, 2)
    check(ids, "ids", torch.int32, 2)
    if codes.shape[1] != lut.shape[1] or ids.shape[0] != lut.shape[0]:
        raise ValueError(f"shape mismatch: lut {tuple(lut.shape)}, "
                         f"codes {tuple(codes.shape)}, ids {tuple(ids.shape)}")
    if not (lut.device == codes.device == ids.device):
        raise ValueError("lut, codes and ids must lie on one device")


def check_affine(scale: torch.Tensor, zero: torch.Tensor, d: int):
    """SQ scale and zero as contiguous (d,) f32 CUDA tensors."""
    scale, zero = scale.reshape(-1), zero.reshape(-1)
    for t, name in ((scale, "scale"), (zero, "zero")):
        check(t, name, torch.float32, 1)
        if t.shape[0] != d:
            raise ValueError(f"{name} must hold {d} values, got {t.shape[0]}")
    return scale, zero


def gather_dist(q: torch.Tensor, db: torch.Tensor, ids: torch.Tensor,
                metric: str) -> torch.Tensor:
    check_rows(q, db, ids, torch.float32)
    Q, d = q.shape
    M = ids.shape[1]
    out = torch.empty((Q, M), dtype=torch.float32, device=q.device)
    if Q == 0 or M == 0:
        return out
    fn = _build.function("gather_dist", "gather_dist_f32", _ARGTYPES)
    err = fn(ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(db.data_ptr()),
             ctypes.c_void_p(ids.data_ptr()), ctypes.c_void_p(out.data_ptr()),
             ctypes.c_int(Q), ctypes.c_int(M), ctypes.c_int(d),
             ctypes.c_int(METRIC_CODES[metric]), stream_ptr(q))
    raise_on(err, "gather_dist")
    launches["gather_dist"] += 1
    return out


def sq_gather_dist(q: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor,
                   zero: torch.Tensor, ids: torch.Tensor,
                   metric: str) -> torch.Tensor:
    check_rows(q, codes, ids, torch.uint8, scale, zero)
    Q, d = q.shape
    M = ids.shape[1]
    scale, zero = check_affine(scale, zero, d)
    out = torch.empty((Q, M), dtype=torch.float32, device=q.device)
    if Q == 0 or M == 0:
        return out
    fn = _build.function("gather_dist", "sq_gather_dist_u8", _SQ_ARGTYPES)
    err = fn(ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(codes.data_ptr()),
             ctypes.c_void_p(scale.data_ptr()),
             ctypes.c_void_p(zero.data_ptr()), ctypes.c_void_p(ids.data_ptr()),
             ctypes.c_void_p(out.data_ptr()), ctypes.c_int(Q), ctypes.c_int(M),
             ctypes.c_int(d), ctypes.c_int(METRIC_CODES[metric]),
             stream_ptr(q))
    raise_on(err, "sq_gather_dist")
    launches["sq_gather_dist"] += 1
    return out
