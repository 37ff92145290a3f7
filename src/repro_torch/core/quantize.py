"""Vector quantization (paper §3.2, A4): the `pq` and `sq` codecs.

The counterpart of the `pq` (8-bit) and `sq` half of the JAX package's
`repro/core/quantize.py`, behind the same interface:

  train(db)          -> state (codebooks / scales)
  encode(db)         -> codes
  query tables       -> per-query operand passed to search() as its
                        "queries" (the search loop is agnostic)
  make_dist_fn()     -> DistFn consuming (tables or queries, nbr_ids)

PQ distance is ADC: per query an (m, 256) lookup table of subspace
distances, so a database code (m,) costs m table reads (the `pq_adc`
kernel on the card). SQ is a per-dimension affine u8 code dequantized on
the fly (the `sq_gather_dist` kernel).

Differences from the reference, none of them in what is computed:
  * k-means takes its initial indices as an input. The reference draws
    them with `jax.random.choice`, whose bits torch cannot reproduce; the
    default here draws from a `torch.Generator` seeded the same way, and
    parity tests pass in the reference's draw.
  * k-means sums each cluster with a one-hot product over row chunks, not
    a scatter: CUDA's float `index_add_` uses atomics, whose order (and so
    whose rounding) changes from run to run, and two trainings must give
    identical codebooks.
  * `pq_encode` works in row chunks; the reference's (n, m, K) distance
    block is 16 GB at n = 1M, m = 16.
The kinds `pq4` and `bin` are not ported yet (ROADMAP.md); their registry
entries stay, and KBest refuses them.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.core.types import QuantConfig

_ROWS = 65536          # rows per chunk of the (rows, k) blocks below


# --------------------------------------------------------------------------
# k-means (shared by PQ training)
# --------------------------------------------------------------------------
def kmeans_init(n: int, k: int, seed: int) -> torch.Tensor:
    """(k,) int64 initial centroid indices: k distinct rows when n >= k,
    else k draws with replacement (the reference's `replace=n < k`), from
    a CPU generator seeded `seed`, so every device draws the same."""
    g = torch.Generator().manual_seed(seed)
    if n >= k:
        return torch.randperm(n, generator=g)[:k]
    return torch.randint(0, n, (k,), generator=g)


def _assign(x: torch.Tensor, cents: torch.Tensor) -> torch.Tensor:
    """Nearest centroid per row of x (rows, ds) by the reference's formula
    ||x||^2 + ||c||^2 - 2 x.c; argmin takes the first index on ties."""
    d2 = (torch.sum(x * x, 1, keepdim=True)
          + torch.sum(cents * cents, 1)[None] - 2.0 * (x @ cents.T))
    return torch.argmin(d2, dim=1)


def kmeans(x: torch.Tensor, k: int, iters: int, seed: int = 0,
           init_idx: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Lloyd's algorithm over x (n, d); returns (k, d) centroids. Empty
    clusters keep their previous centroid. `init_idx` (k,) replaces the
    seeded draw of `kmeans_init`."""
    n, d = x.shape
    if init_idx is None:
        init_idx = kmeans_init(n, k, seed)
    cents = x[torch.as_tensor(init_idx, device=x.device).long()]
    ar = torch.arange(k, device=x.device)
    for _ in range(iters):
        sums = torch.zeros((k, d), dtype=x.dtype, device=x.device)
        cnts = torch.zeros((k,), dtype=x.dtype, device=x.device)
        for s in range(0, n, _ROWS):
            xc = x[s:s + _ROWS]
            onehot = (_assign(xc, cents)[:, None] == ar[None]).to(x.dtype)
            sums += onehot.T @ xc
            cnts += onehot.sum(0)
        cents = torch.where(cnts[:, None] > 0,
                            sums / torch.clamp(cnts[:, None], min=1), cents)
    return cents


# --------------------------------------------------------------------------
# Product quantization (8-bit codes, K = 256)
# --------------------------------------------------------------------------
@dataclasses.dataclass
class PQState:
    codebooks: torch.Tensor  # (m, K, ds)
    m: int
    ds: int

    @property
    def ksub(self) -> int:
        return self.codebooks.shape[1]


def pq_train(db: torch.Tensor, cfg: QuantConfig,
             init_idx: Optional[torch.Tensor] = None) -> PQState:
    """Per-subspace codebooks; subspace j runs k-means seeded cfg.seed + j.
    `init_idx` (m, K), when given, holds each subspace's initial indices."""
    n, d = db.shape
    m = cfg.pq_m
    assert d % m == 0, f"dim {d} not divisible by pq_m {m}"
    ds = d // m
    K = cfg.ksub if cfg.kind in ("pq", "pq4") else 256
    subs = db.reshape(n, m, ds).transpose(0, 1)          # (m, n, ds)
    books = torch.stack([
        kmeans(subs[j].contiguous(), K, cfg.kmeans_iters, seed=cfg.seed + j,
               init_idx=None if init_idx is None else init_idx[j])
        for j in range(m)])
    return PQState(codebooks=books, m=m, ds=ds)


def pq_encode(books: torch.Tensor, db: torch.Tensor) -> torch.Tensor:
    """(n, d) -> (n, m) uint8 codes: each subvector's nearest centroid."""
    m, K, ds = books.shape
    n = db.shape[0]
    bb = torch.sum(books * books, -1)[None]                 # (1, m, K)
    out = torch.empty((n, m), dtype=torch.uint8, device=db.device)
    rows = max(1, _ROWS * 256 // (m * K))      # 64 MB blocks at m*K=4096
    for s in range(0, n, rows):
        subs = db[s:s + rows].reshape(-1, m, ds)
        d2 = (torch.sum(subs * subs, -1)[:, :, None] + bb
              - 2.0 * torch.einsum("nmd,mkd->nmk", subs, books))
        out[s:s + rows] = torch.argmin(d2, dim=-1).to(torch.uint8)
    return out


def pq_query_tables(books: torch.Tensor, queries: torch.Tensor,
                    metric: str) -> torch.Tensor:
    """Per-query ADC lookup tables, flattened to (Q, m*K).

    l2: LUT[j, c] = ||q_j - C[j, c]||^2  (sums to ||q - x_hat||^2)
    ip: LUT[j, c] = -<q_j, C[j, c]>      (sums to -<q, x_hat>)
    """
    m, K, ds = books.shape
    Q = queries.shape[0]
    qs = queries.reshape(Q, m, ds)
    if metric == "l2":
        lut = (torch.sum(qs * qs, -1)[:, :, None]
               + torch.sum(books * books, -1)[None]
               - 2.0 * torch.einsum("qmd,mkd->qmk", qs, books))
    else:
        lut = -torch.einsum("qmd,mkd->qmk", qs, books)
    return lut.reshape(Q, m * K).contiguous()


def pq_make_dist_fn(codes: torch.Tensor, m: int, impl: str = "ref"):
    """DistFn over PQ codes; `tables` (the search "queries") is (Q, m*256).
    impl="kernel" goes to the pq_adc kernel (its plain version on CPU)."""
    K = 256

    if impl == "kernel":
        from repro_torch.kernels import ops as kops

        def fn(tables, nbr_ids):
            return kops.pq_adc(tables.reshape(tables.shape[0], m, K),
                               codes, nbr_ids)
        return fn

    def fn(tables, nbr_ids):
        lut = tables.reshape(tables.shape[0], m, K)
        c = codes[torch.clamp(nbr_ids, min=0).long()].long()   # (Q, B, m)
        g = torch.gather(lut[:, None, :, :].expand(-1, c.shape[1], -1, -1),
                         3, c[..., None])[..., 0]
        return torch.sum(g, dim=-1)
    return fn


# --------------------------------------------------------------------------
# Scalar quantization (int8 per-dimension affine)
# --------------------------------------------------------------------------
@dataclasses.dataclass
class SQState:
    scale: torch.Tensor   # (d,)
    zero: torch.Tensor    # (d,)


def sq_train(db: torch.Tensor) -> SQState:
    lo = torch.amin(db, dim=0)
    hi = torch.amax(db, dim=0)
    scale = torch.clamp(hi - lo, min=1e-12) / 255.0
    return SQState(scale=scale, zero=lo)


def sq_encode(state: SQState, db: torch.Tensor) -> torch.Tensor:
    """(n, d) -> (n, d) uint8; torch.round rounds half to even, as
    jnp.round does."""
    out = torch.empty(db.shape, dtype=torch.uint8, device=db.device)
    for s in range(0, db.shape[0], _ROWS):
        q = torch.round((db[s:s + _ROWS] - state.zero[None])
                        / state.scale[None])
        out[s:s + _ROWS] = torch.clamp(q, 0, 255).to(torch.uint8)
    return out


def sq_make_dist_fn(codes: torch.Tensor, state: SQState, metric: str,
                    impl: str = "ref"):
    """DistFn with on-the-fly dequantization (code * scale + zero);
    impl="kernel" goes to the sq_gather_dist kernel (its plain version on
    CPU)."""
    if impl == "kernel":
        from repro_torch.kernels import ops as kops

        def fn(queries, nbr_ids):
            return kops.sq_gather_dist(queries, codes, state.scale,
                                       state.zero, nbr_ids, metric=metric)
        return fn

    from repro_torch.core.distance import batched_one_to_many

    def fn(queries, nbr_ids):
        c = codes[torch.clamp(nbr_ids, min=0).long()].float()
        vecs = c * state.scale[None, None, :] + state.zero[None, None, :]
        return batched_one_to_many(queries, vecs, metric)
    return fn


# --------------------------------------------------------------------------
# Quant-kind registry (sweeps) and the code-size accounting they report
# --------------------------------------------------------------------------
def quant_variants(pq_m: int = 16) -> dict:
    """Named QuantConfig kwargs for every quantization variant, the
    reference's registry as it is (sweeps enumerate it). pq_m must divide
    the dataset dim; "bin" and "sq" ignore it."""
    return {
        "full": dict(kind="none"),
        "pq8": dict(kind="pq", pq_m=pq_m),
        "pq4": dict(kind="pq4", pq_m=pq_m),
        "pq4+u8lut": dict(kind="pq4", pq_m=pq_m, pq4_lut_u8=True),
        "sq": dict(kind="sq"),
        "bin": dict(kind="bin"),
    }


# The IVF-capable subset of the registry (the kinds build_ivf has codecs
# for).
IVF_QUANT_KINDS = ("pq", "pq4", "bin")


def code_bytes_per_vector(idx) -> int:
    """Stored code bytes per database vector (the A4 memory axis), dtype-
    aware: pq/pq4/sq codes are uint8, bin codes uint32 words. Takes a
    KBest (duck-typed)."""
    for arr in (getattr(idx, "ivf", None) and idx.ivf.list_codes,
                getattr(idx, "bin_codes", None),
                getattr(idx, "pq_codes", None),
                getattr(idx, "sq_codes", None)):
        if arr is not None:
            return int(arr.shape[-1]) * arr.element_size()
    return 4 * int(idx.db.shape[-1])            # f32 full vectors
