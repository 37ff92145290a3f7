"""Reference distance functions (plain torch), the counterparts of the JAX
package's `repro/core/distance.py` with the same formulas.

All distances are "smaller is more similar":
  l2     : squared Euclidean ||q - x||^2
  ip     : negative inner product  -<q, x>
  cosine : negative cosine similarity; callers normalize x at add() time so
           this reduces to ip on unit vectors.

Each formula stays where the reference has it: only `pairwise` (and the
batch_dist kernel) expands L2 as ||q||^2 + ||x||^2 - 2 q.x; the gather
paths sum (x - q)^2 directly.
"""
from __future__ import annotations

import torch

from repro_torch.core.types import METRICS


def normalize(x: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    n = torch.linalg.norm(x, dim=-1, keepdim=True)
    return x / torch.clamp(n, min=eps)


def pairwise(q: torch.Tensor, x: torch.Tensor, metric: str) -> torch.Tensor:
    """Full (nq, nx) distance matrix. q: (nq, d), x: (nx, d)."""
    assert metric in METRICS
    if metric == "l2":
        qq = torch.sum(q * q, dim=-1, keepdim=True)
        xx = torch.sum(x * x, dim=-1)[None, :]
        qx = q @ x.T
        return torch.clamp(qq + xx - 2.0 * qx, min=0.0)
    return -(q @ x.T)


def one_to_many(q: torch.Tensor, xs: torch.Tensor, metric: str) -> torch.Tensor:
    """Distances from one query (d,) to a batch (B, d) — the paper's 1-to-B."""
    assert metric in METRICS
    if metric == "l2":
        diff = xs - q[None, :]
        return torch.sum(diff * diff, dim=-1)
    return -(xs @ q)


def batched_one_to_many(q: torch.Tensor, xs: torch.Tensor,
                        metric: str) -> torch.Tensor:
    """(Q, d) queries vs per-query neighbor batches (Q, B, d) -> (Q, B)."""
    assert metric in METRICS
    if metric == "l2":
        diff = xs - q[:, None, :]
        return torch.sum(diff * diff, dim=-1)
    return -torch.einsum("qbd,qd->qb", xs, q)
