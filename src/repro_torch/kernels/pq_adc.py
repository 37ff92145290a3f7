"""Wrapper of the `pq_adc` CUDA kernel (csrc/pq_adc.cu).

The counterpart of the JAX package's Pallas `pq_adc`
(src/repro/kernels/pq_adc.py): (Q, m, K) f32 lookup tables, (n, m) u8 PQ
codes, (Q, B) int32 ids -> (Q, B) f32 ADC distances
sum_j lut[q, j, codes[id, j]], +inf where an id is < 0. `launches` counts
the kernel launches made through this wrapper.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gather_dist import check_tables, raise_on, stream_ptr

launches = {"pq_adc": 0}
# the C launcher's signature: pointers, ints, stream
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]


def pq_adc(lut: torch.Tensor, codes: torch.Tensor,
           ids: torch.Tensor) -> torch.Tensor:
    check_tables(lut, codes, ids)
    Q, m, K = lut.shape
    B = ids.shape[1]
    out = torch.empty((Q, B), dtype=torch.float32, device=lut.device)
    if Q == 0 or B == 0:
        return out
    fn = _build.function("pq_adc", "pq_adc_u8", _ARGTYPES)
    err = fn(ctypes.c_void_p(lut.data_ptr()), ctypes.c_void_p(codes.data_ptr()),
             ctypes.c_void_p(ids.data_ptr()), ctypes.c_void_p(out.data_ptr()),
             ctypes.c_int(Q), ctypes.c_int(B), ctypes.c_int(m), ctypes.c_int(K),
             stream_ptr(lut))
    raise_on(err, "pq_adc")
    launches["pq_adc"] += 1
    return out
