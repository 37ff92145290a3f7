"""IVF index: coarse k-means partitioning + residual product codes.

The counterpart of the JAX package's `repro/core/ivf.py` (its DESIGN.md
§4), behind the same functions. Inverted lists are padded dense arrays:
`list_ids (nlist, max_len)` int32 with -1 padding and `list_codes
(nlist, max_len, width)` — u8 PQ codes (width m), nibble-packed PQ4 codes
(m/2) or bin sign words (ceil(d/32) int32 bit-views of the reference's
uint32) — with max_len the longest list padded to `IVFConfig.list_pad`.

Search: (1) the nprobe nearest centroids under the index metric; (2) a
list scan per probed list with its own top-L (the `ivf_scan`,
`pq4_ivf_scan` and `bin_ivf_scan` kernels on the card, their plain
versions in kernels/ref.py otherwise), then a global stable top-L over the
nprobe partial lists; (3) the exact re-rank, done by the caller
(KBest._rerank). For L2 with residual codes the tables are built per
probe from q - c_p (Pl = P); otherwise one table serves every probe
(Pl = 1), and for ip with residual codes the per-list constant -<q, c_p>
is added after the per-list top-L.

Differences from the reference, none of them in what is computed:
  * the coarse k-means, the PQ training and the bin rotation take their
    random draws as inputs (`coarse_init`, `pq_init`, `rot`); see
    core/quantize.py;
  * the nearest-centroid assignment runs in row chunks (1M x 1,000 f32
    distances are 4 GB);
  * top-k selections use the stable (distance, index) order of
    `build.stable_topk_smallest`, the order `lax.top_k` gives.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Optional, Tuple

import numpy as np
import torch

from repro_torch import spans
from repro_torch.core import quantize as qz
from repro_torch.core.build import stable_topk_smallest
from repro_torch.core.distance import pairwise
from repro_torch.core.types import IVFConfig, QuantConfig
from repro_torch.kernels import ref as kref

_ROWS = 65536          # rows per chunk of the nearest-centroid assignment


@dataclasses.dataclass
class IVFState:
    """A built IVF index (tensors on the index's device)."""

    centroids: torch.Tensor   # (nlist, d) f32 coarse codebook
    list_ids: torch.Tensor    # (nlist, max_len) int32, -1 padded
    list_codes: torch.Tensor  # (nlist, max_len, m) u8 residual PQ codes,
                              # (nlist, max_len, m//2) nibble-packed pq4,
                              # or (nlist, max_len, ceil(d/32)) int32 bin
    pq: Optional[qz.PQState]  # fine codebooks (m, K, ds); None for bin
    residual: bool
    packed: bool = False      # True => pq4 nibble-packed list_codes
    bin: Optional[qz.BinState] = None  # set => 1-bit sign codec lists

    @property
    def nlist(self) -> int:
        return self.centroids.shape[0]

    @property
    def max_len(self) -> int:
        return self.list_ids.shape[1]


def auto_nlist(n: int) -> int:
    """sqrt(n) heuristic, clamped so tiny corpora still get >= 2 cells."""
    return max(2, min(n, int(round(float(np.sqrt(n))))))


def _assign(x: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
    """(n,) int64 nearest centroid of each row by L2 (`pairwise`'s
    formula, as the reference assigns), first index on ties."""
    return torch.cat([torch.argmin(pairwise(x[s:s + _ROWS], cents, "l2"),
                                   dim=1)
                      for s in range(0, x.shape[0], _ROWS)])


# ---------------------------------------------------------------------- build
def build_ivf(x: torch.Tensor, ivf_cfg: IVFConfig, quant_cfg: QuantConfig,
              coarse_init: Optional[torch.Tensor] = None,
              pq_init: Optional[torch.Tensor] = None,
              rot: Optional[torch.Tensor] = None,
              timings: Optional[dict] = None) -> IVFState:
    """Train the coarse and fine quantizers and lay out the padded lists.

    Assignment is L2 nearest-centroid whatever the metric. Every kind but
    "bin" takes the PQ branch ("pq4" packs its 16-centroid codes; "none"
    and "sq" become 8-bit PQ, as in the reference). `coarse_init` (nlist,)
    and `pq_init` (m, K) replace the seeded k-means draws and `rot` (d, d)
    the bin rotation; `timings`, when given, receives each stage's
    seconds."""
    times = {} if timings is None else timings
    t0 = time.perf_counter()

    def lap(name):
        nonlocal t0
        if x.is_cuda:
            torch.cuda.synchronize(x.device)
        t = time.perf_counter()
        times[name] = times.get(name, 0.0) + (t - t0)
        t0 = t

    n, d = x.shape
    nlist = ivf_cfg.nlist if ivf_cfg.nlist > 0 else auto_nlist(n)
    nlist = min(nlist, n)
    cents = qz.kmeans(x, nlist, ivf_cfg.kmeans_iters, seed=ivf_cfg.seed,
                      init_idx=coarse_init)
    lap("coarse_kmeans")
    where = _assign(x, cents)
    lap("assign")

    if quant_cfg.kind == "bin":
        # signs of the rotated raw vectors, not residuals: one query
        # encoding then serves every probed list
        pq, packed = None, False
        bin_state = qz.bin_train(x, quant_cfg, rot=rot)
        codes = qz.bin_encode(bin_state, x)             # (n, nw) int32
    else:
        bin_state = None
        vecs = x - cents[where] if ivf_cfg.residual else x
        pq = qz.pq_train(vecs, quant_cfg, init_idx=pq_init)
        packed = quant_cfg.kind == "pq4"
        codes = qz.pq_encode(pq.codebooks, vecs)        # (n, m), values < K
        if packed:
            codes = qz.pq4_pack(codes)                  # (n, m//2)
        del vecs
    lap("train_encode")

    # host-side list layout, as the reference's: stable sort by list, then
    # each point to its rank within its list
    assign_h = where.cpu().numpy()
    codes_h = codes.cpu().numpy()
    counts = np.bincount(assign_h, minlength=nlist)
    pad = ivf_cfg.list_pad
    max_len = int(-(-max(int(counts.max()), 1) // pad) * pad)
    order = np.argsort(assign_h, kind="stable")
    starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
    slot = np.arange(n) - starts[assign_h[order]]       # rank within list
    list_ids = np.full((nlist, max_len), -1, np.int32)
    list_codes = np.zeros((nlist, max_len, codes_h.shape[1]), codes_h.dtype)
    list_ids[assign_h[order], slot] = order.astype(np.int32)
    list_codes[assign_h[order], slot] = codes_h[order]
    state = IVFState(centroids=cents.contiguous(),
                     list_ids=torch.as_tensor(list_ids, device=x.device),
                     list_codes=torch.as_tensor(list_codes, device=x.device),
                     pq=pq, residual=ivf_cfg.residual, packed=packed,
                     bin=bin_state)
    lap("lists")
    return state


# --------------------------------------------------------------------- search
def select_probes(state: IVFState, q: torch.Tensor, nprobe: int,
                  metric: str) -> torch.Tensor:
    """(Q, d) -> (Q, P) int32 nearest-centroid ids under the index metric,
    P = min(nprobe, nlist), ties to the lower id."""
    P = min(nprobe, state.nlist)
    _, probes = stable_topk_smallest(pairwise(q, state.centroids, metric), P)
    return probes.to(torch.int32).contiguous()


def query_luts(state: IVFState, q: torch.Tensor, probes: torch.Tensor,
               metric: str, lut_u8: bool = False
               ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """ADC tables (Q, Pl, m, K) and an optional per-probe bias (Q, P).

    Pl is P only where the table differs per probe (l2 with residual
    codes); otherwise Pl = 1. The ip-residual term -<q, c_p> is constant
    within a list, so it comes back as a bias that scan_lists adds after
    the per-list top-L, not folded into the table."""
    Q, P = probes.shape
    books = state.pq.codebooks
    m, K, _ = books.shape
    requant = qz.pq4_requant_lut if lut_u8 else (lambda t: t)
    if metric == "l2" and state.residual:
        qr = q[:, None, :] - state.centroids[probes.long()]     # (Q, P, d)
        lut = requant(qz.pq_query_tables(books, qr.reshape(Q * P, -1), "l2"))
        return lut.reshape(Q, P, m, K), None
    lut = requant(qz.pq_query_tables(books, q, metric)).reshape(Q, 1, m, K)
    if metric != "l2" and state.residual:
        bias = -torch.einsum("qd,qpd->qp", q, state.centroids[probes.long()])
        return lut, bias
    return lut, None


def _merge(pd: torch.Tensor, pi: torch.Tensor, L: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The global merge: (Q, P, Lp) per-list results -> the stable top
    min(L, P*Lp) of their concatenation (earlier probe first on ties), ids
    -1 where the distance is not finite."""
    Q = pd.shape[0]
    with spans.span("ivf.merge"):
        flat_d, flat_i = pd.reshape(Q, -1), pi.reshape(Q, -1)
        k = min(L, flat_d.shape[1])
        vals, pos = stable_topk_smallest(flat_d, k)
        ids = torch.gather(flat_i, 1, pos)
        return vals, torch.where(torch.isfinite(vals), ids,
                                 torch.full_like(ids, -1))


def scan_lists(state: IVFState, luts: torch.Tensor, probes: torch.Tensor,
               L: int, impl: str = "ref",
               bias: Optional[torch.Tensor] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """List scan with per-list top-L, then the global merge. Returns
    (dists (Q, L) ascending approximate distances, ids (Q, L), -1 pad)."""
    Lp = min(L, state.max_len)
    with spans.span("ivf.scan"):
        if impl == "kernel":
            from repro_torch.kernels import ops as kops
            scan = kops.pq4_ivf_scan if state.packed else kops.ivf_scan
            pd, pi = scan(luts.contiguous(), state.list_codes,
                          state.list_ids, probes, L=Lp)
        else:
            scan = kref.pq4_ivf_scan_ref if state.packed \
                else kref.ivf_scan_ref
            pd, pi = scan(luts, state.list_codes, state.list_ids, probes, Lp)
        if bias is not None:
            pd = pd + bias[:, :, None]      # +inf padding stays +inf
    return _merge(pd, pi, L)


def scan_bin_lists(state: IVFState, qcodes: torch.Tensor,
                   probes: torch.Tensor, L: int, impl: str = "ref"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Hamming twin of scan_lists over the probed sign-word lists."""
    Lp = min(L, state.max_len)
    with spans.span("ivf.scan"):
        if impl == "kernel":
            from repro_torch.kernels import ops as kops
            pd, pi = kops.bin_ivf_scan(qcodes, state.list_codes,
                                       state.list_ids, probes, L=Lp)
        else:
            pd, pi = kref.bin_ivf_scan_ref(qcodes, state.list_codes,
                                           state.list_ids, probes, Lp)
    return _merge(pd, pi, L)


def search_ivf(state: IVFState, q: torch.Tensor, nprobe: int, L: int,
               metric: str, impl: str = "ref", lut_u8: bool = False
               ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Stages 1 and 2: probe, scan, merge. Returns (approximate dists
    (Q, L), candidate ids (Q, L), probes (Q, P)); the caller re-ranks the
    candidates exactly and derives the scan's stats from the probes. Only
    (L, nprobe, dist_impl, quant) shape this path: the traversal's knobs
    (beam_width, batch_B, visited_mode) do not reach it."""
    with spans.span("ivf.probe"):
        probes = select_probes(state, q, nprobe, metric)
    if state.bin is not None:
        with spans.span("ivf.luts"):
            qcodes = qz.bin_query_codes(state.bin, q)
        dists, ids = scan_bin_lists(state, qcodes, probes, L, impl)
        return dists, ids, probes
    with spans.span("ivf.luts"):
        luts, bias = query_luts(state, q, probes, metric, lut_u8=lut_u8)
    dists, ids = scan_lists(state, luts, probes, L, impl, bias=bias)
    return dists, ids, probes


def scanned_counts(state: IVFState, probes: torch.Tensor) -> torch.Tensor:
    """(Q, P) probes -> (Q,) int32 valid codes scanned (stats only)."""
    n_valid = torch.sum(state.list_ids >= 0, dim=1)          # (nlist,)
    return torch.sum(n_valid[probes.long()], dim=1).to(torch.int32)
