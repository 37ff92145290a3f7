"""Wrappers of the `bin_dist` CUDA kernel (csrc/bin_hamming.cu) and the
`bin_ivf_scan` one (csrc/bin_ivf_scan.cu).

The counterparts of the JAX package's Pallas `bin_dist` and
`bin_ivf_scan` (src/repro/kernels/bin_hamming.py). `bin_dist`: (Q, nw)
packed query signs, (n, nw) packed database signs, (Q, B) int32 ids ->
(Q, B) f32 Hamming distances, +inf where an id is < 0. `bin_ivf_scan`:
the list scan of kernels/ivf_scan.py by Hamming distance between (Q, nw)
query words and (nlist, max_len, nw) list words, exact. The sign words are
`torch.int32` tensors holding the bits of the reference's uint32 words.
`launches` counts the kernel launches made through these wrappers.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gather_dist import check, raise_on, stream_ptr
from repro_torch.kernels.ivf_scan import check_lists, launch_scan

launches = {"bin_dist": 0, "bin_ivf_scan": 0}
# the C launcher's signature: pointers, ints, stream
_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 3 + [ctypes.c_void_p]


def check_signs(qcodes: torch.Tensor, codes: torch.Tensor,
                ids: torch.Tensor) -> None:
    """The bin kernels' common checks: qcodes (Q, nw) and codes (n, nw)
    int32 words, ids (Q, C) int32, every tensor on one device."""
    check(qcodes, "qcodes", torch.int32, 2)
    check(codes, "codes", torch.int32, 2)
    check(ids, "ids", torch.int32, 2)
    if codes.shape[1] != qcodes.shape[1] or ids.shape[0] != qcodes.shape[0]:
        raise ValueError(f"shape mismatch: qcodes {tuple(qcodes.shape)}, "
                         f"codes {tuple(codes.shape)}, ids {tuple(ids.shape)}")
    if not (qcodes.device == codes.device == ids.device):
        raise ValueError("all operands must lie on one device")


def bin_dist(qcodes: torch.Tensor, codes: torch.Tensor,
             ids: torch.Tensor) -> torch.Tensor:
    check_signs(qcodes, codes, ids)
    Q, nw = qcodes.shape
    B = ids.shape[1]
    out = torch.empty((Q, B), dtype=torch.float32, device=qcodes.device)
    if Q == 0 or B == 0:
        return out
    fn = _build.function("bin_hamming", "bin_dist_u32", _ARGTYPES)
    err = fn(ctypes.c_void_p(qcodes.data_ptr()),
             ctypes.c_void_p(codes.data_ptr()),
             ctypes.c_void_p(ids.data_ptr()), ctypes.c_void_p(out.data_ptr()),
             ctypes.c_int(Q), ctypes.c_int(B), ctypes.c_int(nw),
             stream_ptr(qcodes))
    raise_on(err, "bin_dist")
    launches["bin_dist"] += 1
    return out


def bin_ivf_scan(qcodes: torch.Tensor, list_codes: torch.Tensor,
                 list_ids: torch.Tensor, probe_ids: torch.Tensor, L: int):
    check(qcodes, "qcodes", torch.int32, 2)
    check_lists(list_codes, list_ids, probe_ids, torch.int32, L, qcodes)
    if list_codes.shape[2] != qcodes.shape[1]:
        raise ValueError(f"list_codes {tuple(list_codes.shape)} must hold "
                         f"nw={qcodes.shape[1]} words a slot")
    return launch_scan(launches, "bin_ivf_scan", "bin_ivf_scan_u32",
                       [qcodes], list_codes, list_ids, probe_ids, L,
                       [qcodes.shape[1]], lib="bin_ivf_scan")
