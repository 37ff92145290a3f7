"""The plain reference: exact nearest neighbours by brute force.

Plain PyTorch and NumPy; it imports nothing of the program under test and
takes nothing the program made. It is given the same corpus and queries
the benchmark hands the program and works out, by itself:

* `exact_topk`: each query's k nearest rows (float32, TF32 off), ties to
  the lower id; the ground truth of recall;
* `exact_dists`: the distance of given (query, id) pairs in float64, the
  yardstick of the distances the program returns;
* `control_topk`: the same search one precision lower than the
  configuration states (TF32 products for float32), the control that the
  comparison must reject.

Distances follow the program's convention: "ip" is the negated inner
product, "l2" the squared euclidean distance; smaller is nearer.
"""
from __future__ import annotations

import numpy as np
import torch


def _dist_block(q: torch.Tensor, x: torch.Tensor, metric: str,
                x_sq: torch.Tensor = None) -> torch.Tensor:
    dots = q @ x.T
    if metric == "l2":
        return (q * q).sum(1, keepdim=True) - 2.0 * dots + x_sq[None, :]
    return -dots


def _topk_blocked(base: np.ndarray, queries: np.ndarray, k: int, metric: str,
                  device: str, tf32: bool, rows: int):
    """(dists (Q, k) f32, ids (Q, k) int64), ascending, ties to the lower
    id, over query blocks of `rows`."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    on_card = torch.device(device).type == "cuda"
    torch.backends.cuda.matmul.allow_tf32 = tf32 and on_card
    torch.backends.cudnn.allow_tf32 = tf32 and on_card
    try:
        x = torch.as_tensor(base, dtype=torch.float32, device=device)
        if tf32 and not on_card:
            x = round_tf32(x)
        x_sq = (x * x).sum(1) if metric == "l2" else None
        out_d = np.empty((len(queries), k), np.float32)
        out_i = np.empty((len(queries), k), np.int64)
        for s in range(0, len(queries), rows):
            q = torch.as_tensor(queries[s:s + rows], dtype=torch.float32,
                                device=device)
            if tf32 and not on_card:
                q = round_tf32(q)
            d = _dist_block(q, x, metric, x_sq)
            # a top-(k+1) then a (distance, id) sort of rows that tie
            vals, idx = torch.topk(d, min(k + 1, d.shape[1]), dim=1,
                                   largest=False, sorted=True)
            vals, idx = vals.cpu().numpy(), idx.cpu().numpy()
            order = np.lexsort((idx, vals), axis=1)
            vals = np.take_along_axis(vals, order, 1)[:, :k]
            idx = np.take_along_axis(idx, order, 1)[:, :k]
            out_d[s:s + rows], out_i[s:s + rows] = vals, idx
            del d
        return out_d, out_i
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def exact_topk(base: np.ndarray, queries: np.ndarray, k: int, metric: str,
               device: str = "cpu", rows: int = 1000):
    """The exact k nearest rows of each query, float32 with TF32 off."""
    return _topk_blocked(base, queries, k, metric, device, False, rows)


def control_topk(base: np.ndarray, queries: np.ndarray, k: int, metric: str,
                 device: str = "cpu", rows: int = 1000):
    """The exact search in TF32: on the card with TF32 matmuls, on the
    host with both operands rounded to TF32's 10-bit mantissa."""
    return _topk_blocked(base, queries, k, metric, device, True, rows)


def round_tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 rounded to the nearest TF32 value (10 mantissa bits; ties
    away from zero), as a float32 tensor."""
    bits = x.contiguous().view(torch.int32)
    bits = (bits + 0x1000) & ~0x1FFF
    return bits.view(torch.float32)


def exact_dists(base: np.ndarray, queries: np.ndarray, ids: np.ndarray,
                metric: str) -> np.ndarray:
    """float64 distances of (Q, k) ids to their queries; NaN where an id
    lies outside the corpus."""
    ok = (ids >= 0) & (ids < len(base))
    rows = base[np.where(ok, ids, 0)].astype(np.float64)       # (Q, k, d)
    q = queries.astype(np.float64)[:, None, :]
    if metric == "l2":
        d = ((rows - q) ** 2).sum(-1)
    else:
        d = -(rows * q).sum(-1)
    return np.where(ok, d, np.nan)
