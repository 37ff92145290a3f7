"""Plain torch versions of the port's kernels.

Each function is the semantic specification of its CUDA kernel, mirroring
the JAX package's `repro/kernels/ref.py` (`batch_dist_ref`,
`gather_dist_ref`, `sq_gather_dist_ref`, `pq_adc_ref`, `sorted_block_ref`
and the `fused_expand{,_sq,_pq}_ref` family). The CPU path of
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


def sq_gather_dist_ref(q: torch.Tensor, codes: torch.Tensor,
                       scale: torch.Tensor, zero: torch.Tensor,
                       ids: torch.Tensor, metric: str) -> torch.Tensor:
    """(Q, d) queries, (n, d) u8 codes, (d,) or (1, d) scale/zero, (Q, M)
    ids -> (Q, M) distances against the affine-dequantized rows
    (code * scale + zero). Invalid ids (< 0) produce +inf."""
    vecs = (codes[torch.clamp(ids, min=0).long()].float()
            * scale.reshape(-1)[None, None, :]
            + zero.reshape(-1)[None, None, :])
    qf = q.float()
    if metric == "l2":
        diff = vecs - qf[:, None, :]
        out = torch.sum(diff * diff, dim=-1)
    else:
        out = -torch.einsum("qmd,qd->qm", vecs, qf)
    return torch.where(ids >= 0, out, torch.full_like(out, float("inf")))


def pq_adc_ref(lut: torch.Tensor, codes: torch.Tensor,
               ids: torch.Tensor) -> torch.Tensor:
    """(Q, m, K) luts, (n, m) uint8 codes, (Q, B) ids -> (Q, B) ADC dists.

    dist[q, b] = sum_j lut[q, j, codes[ids[q, b], j]]; invalid ids -> +inf.
    """
    c = codes[torch.clamp(ids, min=0).long()].long()           # (Q, B, m)
    g = torch.gather(lut[:, None, :, :].expand(-1, c.shape[1], -1, -1), 3,
                     c[..., None])[..., 0]
    out = torch.sum(g, dim=-1)
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


def fused_expand_sq_ref(q: torch.Tensor, codes: torch.Tensor,
                        scale: torch.Tensor, zero: torch.Tensor,
                        ids: torch.Tensor, metric: str, L: int,
                        n_beam: int = 1):
    """SQ twin: sq_gather_dist_ref then the sorted-block epilogue."""
    return sorted_block_ref(
        sq_gather_dist_ref(q, codes, scale, zero, ids, metric), ids, L,
        n_beam)


def fused_expand_pq_ref(lut: torch.Tensor, codes: torch.Tensor,
                        ids: torch.Tensor, L: int, n_beam: int = 1):
    """PQ-ADC twin: pq_adc_ref then the sorted-block epilogue."""
    return sorted_block_ref(pq_adc_ref(lut, codes, ids), ids, L, n_beam)
