"""Plain torch versions of the port's kernels.

Each function is the semantic specification of its CUDA kernel, mirroring
the JAX package's `repro/kernels/ref.py` (`batch_dist_ref`,
`gather_dist_ref`, `sq_gather_dist_ref`, `pq_adc_ref`, `pq4_adc_ref`,
`bin_dist_ref`, `sorted_block_ref` and the
`fused_expand{,_sq,_pq,_pq4,_bin}_ref` family). The CPU path of
`kernels/ops.py` runs these; on the card they serve only as the yardstick
the kernels are held against.

Bin codes are `torch.int32` tensors holding the bits of the reference's
uint32 words (torch has no shifts for uint32 on the CPU); XOR and
popcount do not care about the sign bit.
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


def _unpack_nibbles_ref(packed: torch.Tensor) -> torch.Tensor:
    """(..., m//2) packed bytes -> (..., m) int64 codes: byte j holds
    subspace 2j in its low nibble and 2j+1 in its high nibble."""
    p = packed.long()
    return torch.stack([p & 0x0F, (p >> 4) & 0x0F], dim=-1).reshape(
        *packed.shape[:-1], 2 * packed.shape[-1])


def pq4_adc_ref(lut: torch.Tensor, packed: torch.Tensor,
                ids: torch.Tensor) -> torch.Tensor:
    """(Q, m, 16) luts, (n, m//2) u8 nibble-packed codes, (Q, B) ids ->
    (Q, B) ADC dists; invalid ids -> +inf. Unpack-then-pq_adc, summed
    over j = 0 .. m-1 in order: the order of the reference's jnp.sum on
    the CPU and of the CUDA kernel, so all three give the same floats.
    With u8-requantized tables many sums tie exactly, and a sum in
    another order would break those ties differently."""
    c = _unpack_nibbles_ref(packed[torch.clamp(ids, min=0).long()])
    g = torch.gather(lut[:, None, :, :].expand(-1, c.shape[1], -1, -1), 3,
                     c[..., None])[..., 0]
    out = g[..., 0]
    for j in range(1, g.shape[-1]):
        out = out + g[..., j]
    return torch.where(ids >= 0, out, torch.full_like(out, float("inf")))


def _popcount32(x: torch.Tensor) -> torch.Tensor:
    """Bits set in each 32-bit word, from its int32 bit-view: the SWAR
    ladder (pairs, nibbles, bytes, then a byte sum) on int64."""
    x = x.long() & 0xFFFFFFFF
    x = x - ((x >> 1) & 0x55555555)
    x = (x & 0x33333333) + ((x >> 2) & 0x33333333)
    x = (x + (x >> 4)) & 0x0F0F0F0F
    return ((x * 0x01010101) & 0xFFFFFFFF) >> 24


def bin_dist_ref(qcodes: torch.Tensor, codes: torch.Tensor,
                 ids: torch.Tensor) -> torch.Tensor:
    """(Q, nw) int32 packed query signs, (n, nw) int32 packed db signs,
    (Q, B) ids -> (Q, B) f32 Hamming distances (XOR + popcount);
    invalid ids -> +inf. Tail bits past d are zero on both sides, so they
    never count."""
    x = torch.bitwise_xor(codes[torch.clamp(ids, min=0).long()],
                          qcodes[:, None, :])                  # (Q, B, nw)
    out = _popcount32(x).sum(-1).float()
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


def fused_expand_pq4_ref(lut: torch.Tensor, packed: torch.Tensor,
                         ids: torch.Tensor, L: int, n_beam: int = 1):
    """PQ4 twin: pq4_adc_ref then the sorted-block epilogue."""
    return sorted_block_ref(pq4_adc_ref(lut, packed, ids), ids, L, n_beam)


def fused_expand_bin_ref(qcodes: torch.Tensor, codes: torch.Tensor,
                         ids: torch.Tensor, L: int, n_beam: int = 1):
    """bin twin: bin_dist_ref then the sorted-block epilogue."""
    return sorted_block_ref(bin_dist_ref(qcodes, codes, ids), ids, L, n_beam)
