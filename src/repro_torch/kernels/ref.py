"""Plain torch versions of the port's kernels.

Each function is the semantic specification of its CUDA kernel, mirroring
the JAX package's `repro/kernels/ref.py` (`batch_dist_ref`,
`gather_dist_ref`, `sq_gather_dist_ref`, `pq_adc_ref`, `pq4_adc_ref`,
`bin_dist_ref`, `sorted_block_ref`, the
`fused_expand{,_sq,_pq,_pq4,_bin}_ref` family and the list scans
`{,pq4_,bin_}ivf_scan_ref`), and `beam_filter_ref`, the traversal's
candidate filter, which the JAX package runs as plain jnp ops in its
`core/search.py` and which has a kernel only here. The CPU path of
`kernels/ops.py` runs these; on the card they serve only as the yardstick
the kernels are held against.

Bin codes are `torch.int32` tensors holding the bits of the reference's
uint32 words (torch has no shifts for uint32 on the CPU); XOR and
popcount do not care about the sign bit.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core import queue as qmod
from repro_torch.core.build import sortable_keys
from repro_torch.core.search import _bitmap_set_raw, _bitmap_test


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


def sum_in_order(g: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis from +0.0, j = 0 .. m-1 in order: the order
    of the reference's jnp.sum on the CPU and of the CUDA kernels, so all
    three give the same floats (a row whose terms are all -0.0 sums to
    +0.0). torch.sum adds in another order and differs in the last bit.
    With u8-requantized PQ4 tables many sums tie exactly, and a sum in
    another order would break those ties differently."""
    out = g[..., 0] + 0.0
    for j in range(1, g.shape[-1]):
        out = out + g[..., j]
    return out


def adc_sums(lut: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """(Q, m, K) tables, (Q, B, m) int64 codes -> (Q, B) ADC sums
    sum_j lut[q, j, c[q, b, j]], in order (sum_in_order)."""
    g = torch.gather(lut[:, None, :, :].expand(-1, c.shape[1], -1, -1), 3,
                     c[..., None])[..., 0]
    return sum_in_order(g)


def pq_adc_ref(lut: torch.Tensor, codes: torch.Tensor,
               ids: torch.Tensor) -> torch.Tensor:
    """(Q, m, K) luts, (n, m) uint8 codes, (Q, B) ids -> (Q, B) ADC dists.

    dist[q, b] = sum_j lut[q, j, codes[ids[q, b], j]], summed in order
    (sum_in_order); invalid ids -> +inf.
    """
    out = adc_sums(lut, codes[torch.clamp(ids, min=0).long()].long())
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
    (Q, B) ADC dists; invalid ids -> +inf. Unpack-then-pq_adc, summed in
    order (sum_in_order)."""
    out = adc_sums(lut, _unpack_nibbles_ref(
        packed[torch.clamp(ids, min=0).long()]))
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


# --------------------------------------------------------------------------
# IVF list scans: every slot of each probed list scored, -1 slots +inf, then
# each list's own L best in the stable order (distance, then slot)
# --------------------------------------------------------------------------
_SCAN_ELEMS = 1 << 24     # gathered code elements per chunk of queries


def _list_top(d: torch.Tensor, ids: torch.Tensor, L: int):
    """(q, P, max_len) distances and slot ids -> each list's L smallest,
    ascending, ties to the lower slot and -0.0 before +0.0 (lax.top_k's
    order), ids -1 where the distance is not finite. A top-L over the
    distinct (distance, slot) keys, so no tie is left to the device."""
    d = torch.where(ids >= 0, d, torch.full_like(d, float("inf")))
    keys, _ = torch.topk(sortable_keys(d), L, dim=-1, largest=False,
                         sorted=True)
    pos = keys & 0xFFFFFFFF
    vals = torch.gather(d, -1, pos)
    out = torch.gather(ids, -1, pos)
    return vals, torch.where(torch.isfinite(vals), out, torch.full_like(out, -1))


def _by_query_chunks(score, probe_ids: torch.Tensor, width: int, L: int):
    """score(s, e) -> (dists, ids) of queries s..e, over as many queries at
    a time as keep the gathered (q, P, max_len, width) block near
    _SCAN_ELEMS elements (a whole Deep1M batch would be gigabytes)."""
    Q, P = probe_ids.shape
    if Q == 0:
        dev = probe_ids.device
        return (torch.empty((0, P, L), dtype=torch.float32, device=dev),
                torch.empty((0, P, L), dtype=torch.int32, device=dev))
    step = max(1, _SCAN_ELEMS // max(1, P * width))
    parts = [score(s, min(s + step, Q)) for s in range(0, Q, step)]
    return (torch.cat([p[0] for p in parts]),
            torch.cat([p[1] for p in parts]))


def _adc_lists(luts: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """(q, Pl, m, K) tables, (q, P, max_len, m) int64 codes -> (q, P,
    max_len) ADC sums, in order (sum_in_order)."""
    q, P, N, m = codes.shape
    t = luts.expand(q, P, m, luts.shape[-1])[:, :, None]
    return sum_in_order(torch.gather(t.expand(q, P, N, m, t.shape[-1]), 4,
                                     codes[..., None])[..., 0])


def ivf_scan_ref(luts: torch.Tensor, list_codes: torch.Tensor,
                 list_ids: torch.Tensor, probe_ids: torch.Tensor, L: int):
    """(Q, Pl, m, K) tables (Pl = P, or 1 for probe-independent tables),
    (nlist, max_len, m) u8 codes, (nlist, max_len) ids, (Q, P) probes ->
    each probed list's top-L: dists (Q, P, L) ascending, ids (Q, P, L),
    -1 where the distance is +inf."""
    N, m = list_codes.shape[1:]

    def score(s, e):
        pid = probe_ids[s:e].long()
        d = _adc_lists(luts[s:e], list_codes[pid].long())
        return _list_top(d, list_ids[pid], L)
    return _by_query_chunks(score, probe_ids, N * m, L)


def pq4_ivf_scan_ref(luts: torch.Tensor, list_codes: torch.Tensor,
                     list_ids: torch.Tensor, probe_ids: torch.Tensor, L: int):
    """PQ4 twin of ivf_scan_ref: (Q, Pl, m, 16) tables, (nlist, max_len,
    m/2) nibble-packed codes, unpacked and scanned identically."""
    N, mh = list_codes.shape[1:]

    def score(s, e):
        pid = probe_ids[s:e].long()
        d = _adc_lists(luts[s:e], _unpack_nibbles_ref(list_codes[pid]))
        return _list_top(d, list_ids[pid], L)
    return _by_query_chunks(score, probe_ids, N * 2 * mh, L)


def bin_ivf_scan_ref(qcodes: torch.Tensor, list_codes: torch.Tensor,
                     list_ids: torch.Tensor, probe_ids: torch.Tensor, L: int):
    """Hamming twin of ivf_scan_ref: (Q, nw) int32 query sign words,
    (nlist, max_len, nw) int32 list words; XOR + popcount, exact."""
    N, nw = list_codes.shape[1:]

    def score(s, e):
        pid = probe_ids[s:e].long()
        x = torch.bitwise_xor(list_codes[pid], qcodes[s:e, None, None, :])
        d = _popcount32(x).sum(-1).float()
        return _list_top(d, list_ids[pid], L)
    return _by_query_chunks(score, probe_ids, N * nw, L)


def beam_filter_ref(v: torch.Tensor, graph: torch.Tensor,
                    queue_ids: torch.Tensor,
                    bitmap: Optional[torch.Tensor] = None
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The traversal's candidate filter: (Q, W) expanded ids (-1 where a
    lane does not expand), (n, M) graph, (Q, L) queue ids, optional
    (Q, nwords) int64 visited bitmap (updated in place) -> flat (Q, W*M)
    neighbor ids in beam order, -1 where invalid, repeating an earlier
    position, visited or already queued; n_new (Q,) int32, the candidates
    counted before the queue test."""
    Q, W = v.shape
    nbrs = torch.where(v[..., None] >= 0, graph[torch.clamp(v, min=0).long()],
                       torch.full((1, 1, 1), -1, dtype=graph.dtype,
                                  device=v.device))
    flat = qmod.dedupe_ids(nbrs.reshape(Q, W * graph.shape[1]))
    if bitmap is not None:
        seen = _bitmap_test(bitmap, flat)
        flat = torch.where(seen, torch.full_like(flat, -1), flat)
        bitmap.copy_(_bitmap_set_raw(bitmap, flat))
    n_new = torch.sum(flat >= 0, dim=1).to(torch.int32)
    queued = qmod.in_queue_mask(qmod.Queue(None, queue_ids, None), flat)
    return torch.where(queued, torch.full_like(flat, -1), flat), n_new
