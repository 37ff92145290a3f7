"""Wrapper of the `batch_dist` CUDA kernel (csrc/batch_dist.cu).

The counterpart of the JAX package's Pallas `batch_dist`
(src/repro/kernels/batch_dist.py): (Q, d) x (B, d) f32 -> (Q, B) f32
distance matrix, any shapes (the kernel masks its ragged tiles, so no
padding happens here). `launches` counts the kernel launches made through
this wrapper.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gather_dist import (METRIC_CODES, check, raise_on,
                                             stream_ptr)

launches = {"batch_dist": 0}
# the C launcher's signature: pointers, ints, stream
_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def batch_dist(q: torch.Tensor, x: torch.Tensor, metric: str) -> torch.Tensor:
    check(q, "q", torch.float32, 2)
    check(x, "x", torch.float32, 2)
    Q, d = q.shape
    B = x.shape[0]
    if x.shape[1] != d:
        raise ValueError(f"shape mismatch: q {tuple(q.shape)}, "
                         f"x {tuple(x.shape)}")
    if q.device != x.device:
        raise ValueError("q and x must lie on one device")
    out = torch.empty((Q, B), dtype=torch.float32, device=q.device)
    if Q == 0 or B == 0:
        return out
    fn = _build.function("batch_dist", "batch_dist_f32", _ARGTYPES)
    err = fn(ctypes.c_void_p(q.data_ptr()), ctypes.c_void_p(x.data_ptr()),
             ctypes.c_void_p(out.data_ptr()), ctypes.c_int(Q), ctypes.c_int(B),
             ctypes.c_int(d), ctypes.c_int(METRIC_CODES[metric]),
             stream_ptr(q))
    raise_on(err, "batch_dist")
    launches["batch_dist"] += 1
    return out
