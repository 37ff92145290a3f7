"""Wrappers of the `pq4_adc` CUDA kernel (csrc/pq4_scan.cu) and the
`pq4_ivf_scan` one (csrc/ivf_scan.cu).

The counterparts of the JAX package's Pallas `pq4_adc` and `pq4_ivf_scan`
(src/repro/kernels/pq4_scan.py). `pq4_adc`: (Q, m, 16) f32 lookup tables,
(n, m/2) u8 nibble-packed PQ4 codes (byte b: subspace 2b low, 2b+1 high),
(Q, B) int32 ids -> (Q, B) f32 ADC distances, +inf where an id is < 0.
`pq4_ivf_scan`: the list scan of kernels/ivf_scan.py over (Q, Pl, m, 16)
tables and (nlist, max_len, m/2) packed list codes. `launches` counts the
kernel launches made through these wrappers.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gather_dist import check, raise_on, stream_ptr
from repro_torch.kernels.ivf_scan import check_lists, check_luts, launch_scan

K4 = 16          # centroids per 4-bit sub-codebook
launches = {"pq4_adc": 0, "pq4_ivf_scan": 0}
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


def pq4_ivf_scan(luts: torch.Tensor, list_codes: torch.Tensor,
                 list_ids: torch.Tensor, probe_ids: torch.Tensor, L: int):
    check_luts(luts, probe_ids, K4)
    check_lists(list_codes, list_ids, probe_ids, torch.uint8, L, luts)
    _, Pl, m, _ = luts.shape
    if 2 * list_codes.shape[2] != m:
        raise ValueError(f"list_codes {tuple(list_codes.shape)} must hold "
                         f"m/2={m // 2} bytes a slot")
    return launch_scan(launches, "pq4_ivf_scan", "pq4_ivf_scan_u8", [luts],
                       list_codes, list_ids, probe_ids, L, [Pl, m])
