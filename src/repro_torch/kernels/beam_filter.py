"""Wrapper of the `beam_filter` CUDA kernel (csrc/beam_filter.cu): the
candidate filter of one lockstep iteration of the beam traversal.

Replaces no Pallas kernel: the JAX package runs this stage as plain jnp
ops (src/repro/core/search.py). (Q, W) int32 expanded ids (-1 on lanes
that do not expand), an (n, M) int32 graph, (Q, L) int32 queue ids and an
optional (Q, nwords) int64 visited bitmap -> flat (Q, W*M) int32 candidate
ids in beam order (-1 where invalid, a repeat of an earlier position, seen
in the bitmap, or already queued) and n_new (Q,) int32, the candidates
counted before the queue test. The bitmap, when given, is updated in
place. `launches` counts the kernel launches made through this wrapper.
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.gather_dist import check, raise_on, stream_ptr

MAX_C = 4096
launches = {"beam_filter": 0}
# the C launcher's signature: pointers, ints, stream
_ARGTYPES = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]


def beam_filter(v: torch.Tensor, graph: torch.Tensor,
                queue_ids: torch.Tensor, bitmap: Optional[torch.Tensor] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    check(v, "v", torch.int32, 2)
    check(graph, "graph", torch.int32, 2)
    check(queue_ids, "queue_ids", torch.int32, 2)
    operands = [v, graph, queue_ids]
    if bitmap is not None:
        check(bitmap, "bitmap", torch.int64, 2)
        operands.append(bitmap)
    (Q, W), M, L = v.shape, graph.shape[1], queue_ids.shape[1]
    if queue_ids.shape[0] != Q or (bitmap is not None
                                   and bitmap.shape[0] != Q):
        raise ValueError(f"shape mismatch: v {tuple(v.shape)}, queue_ids "
                         f"{tuple(queue_ids.shape)}, bitmap "
                         f"{None if bitmap is None else tuple(bitmap.shape)}")
    if any(t.device != v.device for t in operands):
        raise ValueError("all operands must lie on one device")
    C = W * M
    if not 1 <= C <= MAX_C:
        raise ValueError(f"W*M={C} must lie in [1, {MAX_C}]")
    flat = torch.empty((Q, C), dtype=torch.int32, device=v.device)
    n_new = torch.empty((Q,), dtype=torch.int32, device=v.device)
    if Q == 0:
        return flat, n_new
    fn = _build.function("beam_filter", "beam_filter_i32", _ARGTYPES)
    ptrs = [ctypes.c_void_p(0 if t is None else t.data_ptr())
            for t in (v, graph, queue_ids, bitmap, flat, n_new)]
    ints = [ctypes.c_int(x) for x in (
        Q, W, M, L, 0 if bitmap is None else bitmap.shape[1])]
    raise_on(fn(*ptrs, *ints, stream_ptr(v)), "beam_filter")
    launches["beam_filter"] += 1
    return flat, n_new
