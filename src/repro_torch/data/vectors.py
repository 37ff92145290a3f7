"""Synthetic vector datasets matching the paper's Table 3 benchmarks.

No network access in this environment, so each dataset is a deterministic
synthetic analogue matched on (n, d, metric, query-distribution):

  glove_like  : 100-d, angular, heavy cluster structure (word vectors are
                famously clustered) -> gaussian mixture, normalized.
  deep_like   : 96-d, angular, smoother "real-world CNN descriptor"-ish
                distribution -> low-rank gaussian + noise, normalized.
  t2i_like    : 200-d, inner-product, OUT-OF-DISTRIBUTION queries (text
                queries vs image corpus) -> corpus from mixture A, queries
                from shifted mixture B (the paper's OOD robustness test).
  bigann_like : 128-d, L2, SIFT-ish non-negative clustered integers.

Sizes are scaled down by `scale` for CPU tests; the generator keeps the
structural knobs (cluster count, OOD shift) fixed so recall curves are
comparable across scales.

A copy of the JAX package's `repro/data/vectors.py` (numpy), so the same
seed gives the same vectors in both packages. One difference: the exact
ground truth is computed on the card by default, on batch_dist tiles with
a stable top-k; `device="cpu"` keeps the reference's numpy path on the
host.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class VectorDataset:
    name: str
    metric: str
    base: np.ndarray      # (n, d) float32
    queries: np.ndarray   # (q, d) float32
    gt_ids: np.ndarray    # (q, k) int64 exact top-k ids under `metric`


def _mixture(key: np.random.Generator, n: int, d: int, n_clusters: int,
             spread: float, shift: float = 0.0, bg_frac: float = 0.15,
             rank: int = 16, basis: np.ndarray = None,
             center_scale: float = 0.8) -> np.ndarray:
    """Gaussian mixture with low-intrinsic-dimension cluster geometry plus a
    broad "background" component.

    Real embedding datasets are clustered but (i) have density bridges
    between clusters and (ii) live near a low-dimensional manifold, so
    inter-cluster distances vary smoothly and greedy routing has a gradient
    to follow. Isotropic random centers in d~100 are mutually
    near-orthogonal — pathological for ANY proximity-graph method and
    unrepresentative — so centers are drawn from a rank-`rank` subspace.
    """
    if basis is None:
        basis = key.normal(size=(rank, d)).astype(np.float32)
    rank = basis.shape[0]
    centers = (key.normal(size=(n_clusters, rank)).astype(np.float32) @ basis
               ) * center_scale + shift
    assign = key.integers(0, n_clusters, size=n)
    x = centers[assign] + key.normal(size=(n, d)).astype(np.float32) * spread
    n_bg = int(n * bg_frac)
    if n_bg:
        bg = (key.normal(size=(n_bg, rank)).astype(np.float32) @ basis
              ) * 1.25 * center_scale \
            + key.normal(size=(n_bg, d)).astype(np.float32) * spread + shift
        x[key.choice(n, n_bg, replace=False)] = bg
    return x.astype(np.float32)


def _normalize(x: np.ndarray) -> np.ndarray:
    return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)


def exact_topk(base: np.ndarray, queries: np.ndarray, k: int, metric: str,
               chunk: int = 512) -> np.ndarray:
    """Exact ground truth by blocked brute force (numpy, host)."""
    out = np.empty((queries.shape[0], k), dtype=np.int64)
    for s in range(0, queries.shape[0], chunk):
        q = queries[s:s + chunk]
        if metric == "l2":
            d = ((q ** 2).sum(1)[:, None] + (base ** 2).sum(1)[None]
                 - 2.0 * q @ base.T)
        else:  # ip / cosine(pre-normalized)
            d = -(q @ base.T)
        out[s:s + chunk] = np.argpartition(d, k, axis=1)[:, :k]
        # exact ordering within the k set
        rows = np.arange(q.shape[0])[:, None]
        part = out[s:s + chunk]
        out[s:s + chunk] = part[rows, np.argsort(d[rows, part], axis=1)]
    return out


def exact_topk_device(base: np.ndarray, queries: np.ndarray, k: int,
                      metric: str, device, chunk: int = 1000) -> np.ndarray:
    """Exact ground truth on `device`: batch_dist over `chunk` queries at
    a time against the whole base, then a stable top-k of each tile (ties
    to the lower id). Returns (q, k) int64 ids."""
    import torch

    from repro_torch.core.build import stable_topk_smallest
    from repro_torch.kernels import ops as kops
    x = torch.as_tensor(base, dtype=torch.float32, device=device)
    out = np.empty((queries.shape[0], k), dtype=np.int64)
    for s in range(0, queries.shape[0], chunk):
        q = torch.as_tensor(queries[s:s + chunk], dtype=torch.float32,
                            device=device)
        d = kops.batch_dist(q, x, metric="l2" if metric == "l2" else "ip")
        _, idx = stable_topk_smallest(d, k)
        out[s:s + chunk] = idx.cpu().numpy()
        del d
    return out


def make_dataset(name: str, n: int = 20_000, n_queries: int = 200,
                 k: int = 100, seed: int = 0, device=None) -> VectorDataset:
    """The exact ground truth runs on `device`: None means the card (and
    raises without one, as KBest does), "cpu" the reference's host numpy
    path, any other device batch_dist tiles there."""
    import zlib
    if device is None:
        import torch
        if not torch.cuda.is_available():
            raise RuntimeError("make_dataset computes its ground truth on a "
                               "CUDA device by default and none is "
                               "available; pass device='cpu' for the host")
        device = "cuda"
    # stable per-dataset seed: python's hash() is randomized per process
    rng = np.random.default_rng(seed + zlib.crc32(name.encode()) % 65536)
    if name == "glove_like":
        d, metric = 100, "ip"
        # in-distribution: one draw, split into base/queries
        allx = _normalize(_mixture(rng, n + n_queries, d, n_clusters=48,
                                   spread=1.2))
        base, queries = allx[:n], allx[n:]
    elif name == "deep_like":
        d, metric = 96, "ip"
        rank = 32
        A = rng.normal(size=(rank, d)).astype(np.float32)
        allx = _normalize(
            rng.normal(size=(n + n_queries, rank)).astype(np.float32) @ A
            + 0.1 * rng.normal(size=(n + n_queries, d)).astype(np.float32))
        base, queries = allx[:n], allx[n:]
    elif name == "t2i_like":
        d, metric = 200, "ip"
        # OOD queries: SAME embedding subspace (the two towers land in a
        # shared space) but a different, shifted mixture (text vs image).
        basis = rng.normal(size=(24, d)).astype(np.float32)
        base = _mixture(rng, n, d, n_clusters=64, spread=1.0, basis=basis)
        queries = _mixture(rng, n_queries, d, n_clusters=24, spread=1.3,
                           shift=0.3, basis=basis)
        base /= np.sqrt(d)
        queries /= np.sqrt(d)
    elif name == "bigann_like":
        d, metric = 128, "l2"
        # SIFT-style non-negative ints via translation (L2-invariant, so the
        # search difficulty matches the underlying mixture, unlike abs()).
        allx = _mixture(rng, n + n_queries, d, n_clusters=64,
                        spread=1.0, rank=24, center_scale=2.0)
        allx = np.round((allx - allx.min()) * 10.0).astype(np.float32)
        base, queries = allx[:n], allx[n:]
    else:
        raise ValueError(name)
    if str(device) == "cpu":
        gt = exact_topk(base, queries, k, metric)
    else:
        gt = exact_topk_device(base, queries, k, metric, device)
    return VectorDataset(name=name, metric=metric, base=base,
                         queries=queries, gt_ids=gt)


def recall_at_k(found_ids: np.ndarray, gt_ids: np.ndarray, k: int) -> float:
    """recall@k = |found ∩ gt| / k averaged over queries (paper §2.1)."""
    hits = 0
    for f, g in zip(np.asarray(found_ids)[:, :k], gt_ids[:, :k]):
        hits += len(set(f.tolist()) & set(g.tolist()))
    return hits / (gt_ids.shape[0] * k)


ALL_DATASETS = ("glove_like", "deep_like", "t2i_like", "bigann_like")
