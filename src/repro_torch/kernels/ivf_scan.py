"""Wrapper of the `ivf_scan` CUDA kernel (csrc/ivf_scan.cu), and the list
checks and launcher that the PQ4 and bin list scans share.

The counterpart of the JAX package's Pallas `ivf_scan`
(src/repro/kernels/ivf_scan.py): (Q, Pl, m, K) f32 lookup tables with
Pl = P (a table per probe) or 1 (one per query), (nlist, max_len, m) u8
list codes, (nlist, max_len) int32 list ids (-1 padding) and (Q, P) int32
probed lists -> each probed list's own top-L, dists (Q, P, L) ascending
and ids (Q, P, L), -1 where the distance is +inf. L is at most max_len and
is not rounded up (the TPU's power-of-two rule). `launches` counts the
kernel launches made through this wrapper.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gather_dist import check, raise_on, stream_ptr

launches = {"ivf_scan": 0}


def check_lists(list_codes: torch.Tensor, list_ids: torch.Tensor,
                probe_ids: torch.Tensor, codes_dtype: torch.dtype, L: int,
                lead: torch.Tensor) -> None:
    """The list scans' common checks: list_codes (nlist, max_len, width)
    of `codes_dtype`, list_ids (nlist, max_len) and probe_ids (Q, P)
    int32, 1 <= L <= max_len, `lead` (the tables or query words) with Q
    rows, every tensor on one device."""
    check(list_codes, "list_codes", codes_dtype, 3)
    check(list_ids, "list_ids", torch.int32, 2)
    check(probe_ids, "probe_ids", torch.int32, 2)
    nlist, max_len = list_ids.shape
    if tuple(list_codes.shape[:2]) != (nlist, max_len) \
            or lead.shape[0] != probe_ids.shape[0]:
        raise ValueError(f"shape mismatch: list_codes "
                         f"{tuple(list_codes.shape)}, list_ids "
                         f"{tuple(list_ids.shape)}, probe_ids "
                         f"{tuple(probe_ids.shape)}, lead "
                         f"{tuple(lead.shape)}")
    if not 1 <= L <= max_len:
        raise ValueError(f"L={L} must lie in [1, max_len={max_len}]")
    if nlist * max_len >= 2 ** 31:
        raise ValueError(f"{nlist} lists of {max_len} slots exceed int32 "
                         f"row indices")
    if any(t.device != lead.device for t in (list_codes, list_ids,
                                               probe_ids)):
        raise ValueError("all operands must lie on one device")


def check_luts(luts: torch.Tensor, probe_ids: torch.Tensor,
                 K: int = 0) -> None:
    """luts (Q, Pl, m, K) f32 with Pl in {1, P} (and K as given)."""
    check(luts, "luts", torch.float32, 4)
    Pl, P = luts.shape[1], probe_ids.shape[1]
    if Pl not in (1, P) or (K and luts.shape[3] != K):
        raise ValueError(f"luts {tuple(luts.shape)} must be (Q, 1 or "
                         f"P={P}, m, {K or 'K'})")


def launch_scan(counts: dict, kernel: str, symbol: str, lead: list,
                list_codes: torch.Tensor, list_ids: torch.Tensor,
                probe_ids: torch.Tensor, L: int, tail: list,
                lib: str = "ivf_scan"):
    """Allocate (Q, P, L) dists and ids, call `symbol` of lib<lib>.so with
    the pointers `lead`, the lists, probes and outputs, (Q, P, nlist,
    max_len, L) and the ints `tail`, and count the launch in
    `counts[kernel]`."""
    Q, P = probe_ids.shape
    nlist, max_len = list_ids.shape
    dev = probe_ids.device
    outs = (torch.empty((Q, P, L), dtype=torch.float32, device=dev),
            torch.empty((Q, P, L), dtype=torch.int32, device=dev))
    if Q == 0 or P == 0:
        return outs
    ptrs = [ctypes.c_void_p(t.data_ptr())
            for t in (*lead, list_codes, list_ids, probe_ids, *outs)]
    ints = [ctypes.c_int(v) for v in (Q, P, nlist, max_len, L, *tail)]
    fn = _build.function(lib, symbol,
                         [ctypes.c_void_p] * len(ptrs)
                         + [ctypes.c_int] * len(ints) + [ctypes.c_void_p])
    raise_on(fn(*ptrs, *ints, stream_ptr(probe_ids)), kernel)
    counts[kernel] += 1
    return outs


def ivf_scan(luts: torch.Tensor, list_codes: torch.Tensor,
             list_ids: torch.Tensor, probe_ids: torch.Tensor, L: int):
    check_luts(luts, probe_ids)
    check_lists(list_codes, list_ids, probe_ids, torch.uint8, L, luts)
    _, Pl, m, K = luts.shape
    if list_codes.shape[2] != m:
        raise ValueError(f"list_codes {tuple(list_codes.shape)} must hold "
                         f"m={m} codes a slot")
    return launch_scan(launches, "ivf_scan", "ivf_scan_u8", [luts],
                       list_codes, list_ids, probe_ids, L, [Pl, m, K])
