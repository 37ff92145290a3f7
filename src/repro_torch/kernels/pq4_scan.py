"""Wrapper of the `pq4_adc` CUDA kernel (csrc/pq4_scan.cu).

The counterpart of the JAX package's Pallas `pq4_adc`
(src/repro/kernels/pq4_scan.py): (Q, m, 16) f32 lookup tables, (n, m/2) u8
nibble-packed PQ4 codes (byte b: subspace 2b low, 2b+1 high), (Q, B) int32
ids -> (Q, B) f32 ADC distances, +inf where an id is < 0. `launches`
counts the kernel launches made through this wrapper.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gather_dist import check, raise_on, stream_ptr

K4 = 16          # centroids per 4-bit sub-codebook
launches = {"pq4_adc": 0}
# the C launcher's signature: pointers, ints, stream
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def check_packed(lut: torch.Tensor, packed: torch.Tensor,
                 ids: torch.Tensor) -> None:
    """The PQ4 kernels' common checks: lut (Q, m, 16) f32, packed
    (n, m/2) u8, ids (Q, C) int32, every tensor on one device."""
    check(lut, "lut", torch.float32, 3)
    check(packed, "packed", torch.uint8, 2)
    check(ids, "ids", torch.int32, 2)
    if (lut.shape[2] != K4 or 2 * packed.shape[1] != lut.shape[1]
            or ids.shape[0] != lut.shape[0]):
        raise ValueError(f"shape mismatch: lut {tuple(lut.shape)}, packed "
                         f"{tuple(packed.shape)}, ids {tuple(ids.shape)}")
    if not (lut.device == packed.device == ids.device):
        raise ValueError("all operands must lie on one device")


def pq4_adc(lut: torch.Tensor, packed: torch.Tensor,
            ids: torch.Tensor) -> torch.Tensor:
    check_packed(lut, packed, ids)
    Q, m, _ = lut.shape
    B = ids.shape[1]
    out = torch.empty((Q, B), dtype=torch.float32, device=lut.device)
    if Q == 0 or B == 0:
        return out
    fn = _build.function("pq4_scan", "pq4_adc_u8", _ARGTYPES)
    err = fn(ctypes.c_void_p(lut.data_ptr()),
             ctypes.c_void_p(packed.data_ptr()),
             ctypes.c_void_p(ids.data_ptr()), ctypes.c_void_p(out.data_ptr()),
             ctypes.c_int(Q), ctypes.c_int(B), ctypes.c_int(m),
             stream_ptr(lut))
    raise_on(err, "pq4_adc")
    launches["pq4_adc"] += 1
    return out
