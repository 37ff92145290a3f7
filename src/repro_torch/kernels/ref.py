"""Plain torch versions of the port's three kernels.

Each function is the semantic specification of its CUDA kernel, mirroring
the JAX package's `repro/kernels/ref.py` (`batch_dist_ref`,
`gather_dist_ref`, `sorted_block_ref`, `fused_expand_ref`). The CPU path of
`kernels/ops.py` runs these; on the card they serve only as the yardstick
the kernels are held against.
"""
from __future__ import annotations

import torch


def batch_dist_ref(q: torch.Tensor, x: torch.Tensor, metric: str) -> torch.Tensor:
    """(Q, d), (B, d) -> (Q, B) distance matrix."""
    qf, xf = q.float(), x.float()
    if metric == "l2":
        qq = torch.sum(qf * qf, dim=-1, keepdim=True)
        xx = torch.sum(xf * xf, dim=-1)[None, :]
        return torch.clamp(qq + xx - 2.0 * (qf @ xf.T), min=0.0)
    return -(qf @ xf.T)


def gather_dist_ref(q: torch.Tensor, db: torch.Tensor, ids: torch.Tensor,
                    metric: str) -> torch.Tensor:
    """(Q, d) queries, (n, d) db, (Q, M) ids -> (Q, M) distances.

    Invalid ids (< 0) produce +inf.
    """
    vecs = db[torch.clamp(ids, min=0).long()].float()          # (Q, M, d)
    qf = q.float()
    if metric == "l2":
        diff = vecs - qf[:, None, :]
        out = torch.sum(diff * diff, dim=-1)
    else:
        out = -torch.einsum("qmd,qd->qm", vecs, qf)
    return torch.where(ids >= 0, out, torch.full_like(out, float("inf")))


def sorted_block_ref(d: torch.Tensor, ids: torch.Tensor, L: int, n_beam: int):
    """Epilogue of fused_expand: mask invalid ids to +inf, stable-sort
    ascending (ties keep flat beam order), truncate to T = min(L, C), and
    report each beam expansion's best (minimum) distance plus its
    earlier-expansion exact-tie count.

    d (Q, C), ids (Q, C) with C divisible by n_beam ->
    (dists (Q, T) ascending, ids (Q, T) with -1 beyond the finite prefix,
    bests (Q, n_beam), ties (Q, n_beam) i32).
    """
    Q, C = d.shape
    T = min(L, C)
    inf = torch.full_like(d, float("inf"))
    d = torch.where(ids >= 0, d, inf)
    sd, order = torch.sort(d, dim=1, stable=True)
    sd = sd[:, :T]
    si = torch.gather(ids, 1, order[:, :T])
    si = torch.where(torch.isfinite(sd), si, torch.full_like(si, -1))
    block = d.reshape(Q, n_beam, -1)
    bests = torch.amin(block, dim=2)
    eq = torch.sum(block[:, None, :, :] == bests[:, :, None, None], dim=3)
    ar = torch.arange(n_beam, device=d.device)
    tri = (ar[None, :] < ar[:, None])[None]
    ties = torch.sum(torch.where(tri, eq, torch.zeros_like(eq)), dim=2)
    return sd, si, bests, ties.to(torch.int32)


def fused_expand_ref(q: torch.Tensor, db: torch.Tensor, ids: torch.Tensor,
                     metric: str, L: int, n_beam: int = 1):
    """(Q, d), (n, d), (Q, C) -> sorted top-min(L, C) candidate block +
    per-expansion bests and tie counts; gather_dist then the epilogue."""
    return sorted_block_ref(gather_dist_ref(q, db, ids, metric), ids,
                            L, n_beam)
