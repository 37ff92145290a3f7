"""kNN-graph construction (paper §3.2, phase 1 of index refinement).

The counterpart of the JAX package's `repro/core/build.py`. Two builders:
  * brute_force_knn — tiled exact kNN on batch_dist tiles (the Q-to-B
    workload of the batch_dist kernel) plus a stable top-k;
  * nn_descent — fixed-round NN-descent, chunked over rows so the
    (rows, k*sample, d) gather never holds the whole corpus at once.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch import spans
from repro_torch.core.distance import pairwise


def sortable_keys(d: torch.Tensor) -> torch.Tensor:
    """Map f32 distances to int64 keys that sort like (distance, column):
    the float's order-preserving int32 image in the high 32 bits (-0.0
    before +0.0, as XLA's total order puts them), the column index in the
    low 32. Every key is distinct, so any top-k over them is the stable
    one (ties go to the lower index, as `lax.top_k` breaks them), whatever
    order the device's top-k visits them in."""
    bits = d.contiguous().view(torch.int32)
    key = torch.where(bits >= 0, bits, bits ^ 0x7FFFFFFF).to(torch.int64)
    col = torch.arange(d.shape[-1], device=d.device, dtype=torch.int64)
    return (key << 32) | col


def stable_topk_smallest(d: torch.Tensor, k: int
                         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise k smallest of (rows, n) f32, ascending, ties to the lower
    index. Returns (values (rows, k), indices (rows, k) int64).

    A plain top-(k+1) on the floats is already the answer for every row
    whose k+1 smallest values are all distinct (the set and its order are
    then unique); only rows with a tie among them are redone on the
    distinct (distance, column) keys.

    A `meta` input (shapes only, no values) gets a plain top-k in the
    result's shapes and dtypes, with no tie repair: `torch.nonzero` has no
    meta version. The branch exists only so that the shape layer
    (`launch/specs.py`) can run the retrieval steps; on every real device
    nothing changes."""
    n = d.shape[1]
    if d.device.type == "meta":
        return torch.topk(d, min(k, n), dim=1, largest=False, sorted=True)
    vals, idx = torch.topk(d, min(k + 1, n), dim=1, largest=False,
                           sorted=True)
    tied = (vals[:, 1:] == vals[:, :-1]).any(dim=1)
    vals, idx = vals[:, :k], idx[:, :k]
    with spans.span("topk.tie_sync"):
        spans.count("sync")
        rows = torch.nonzero(tied).flatten()
        if len(rows):
            keys, _ = torch.topk(sortable_keys(d[rows]), k, dim=1,
                                 largest=False, sorted=True)
            ki = keys & 0xFFFFFFFF
            idx[rows] = ki
            vals[rows] = torch.gather(d[rows], 1, ki)
    return vals, idx


def _merge_topk(ids_a, dists_a, ids_b, dists_b, k
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Row-wise merge of two candidate sets with id-dedupe, keep k best."""
    ids = torch.cat([ids_a, ids_b], dim=-1)
    dists = torch.cat([dists_a, dists_b], dim=-1)
    # sort by id, kill duplicates (neighboring equal ids), re-sort by dist
    ids_s, order = torch.sort(ids, dim=-1, stable=True)
    dists_s = torch.gather(dists, -1, order)
    dup = torch.cat([torch.zeros_like(ids_s[..., :1], dtype=torch.bool),
                     ids_s[..., 1:] == ids_s[..., :-1]], dim=-1)
    dists_s = torch.where(dup | (ids_s < 0),
                          torch.full_like(dists_s, float("inf")), dists_s)
    _, order2 = torch.sort(dists_s, dim=-1, stable=True)
    order2 = order2[..., :k]
    return torch.gather(ids_s, -1, order2), torch.gather(dists_s, -1, order2)


def brute_force_knn(db: torch.Tensor, k: int, metric: str, chunk: int = 256
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact kNN. Returns (ids (n, k) int32, dists (n, k)), self excluded."""
    from repro_torch.kernels import ops as kops
    n = db.shape[0]
    ids, dists = [], []
    for s in range(0, n, chunk):
        e = min(s + chunk, n)
        dm = kops.batch_dist(db[s:e], db, metric=metric)        # (c, n)
        rows = torch.arange(s, e, device=db.device)
        dm[torch.arange(e - s, device=db.device), rows] = float("inf")
        v, i = stable_topk_smallest(dm, k)
        ids.append(i.to(torch.int32))
        dists.append(v)
    return torch.cat(ids, 0), torch.cat(dists, 0)


def _gather_dists(db: torch.Tensor, rows: torch.Tensor, ids: torch.Tensor,
                  metric: str) -> torch.Tensor:
    """d(db[rows[i]], db[ids[i, j]]) with -1 masked to inf. (nc, C)."""
    vecs = db[torch.clamp(ids, min=0).long()]                  # (nc, C, d)
    base = db[rows]
    if metric == "l2":
        diff = vecs - base[:, None, :]
        out = torch.sum(diff * diff, dim=-1)
    else:
        out = -torch.einsum("ncd,nd->nc", vecs, base)
    return torch.where(ids >= 0, out, torch.full_like(out, float("inf")))


def random_init_ids(n: int, k: int, seed: int = 0) -> torch.Tensor:
    """The default NN-descent start: (n, k) int32 uniform in [0, n) from a
    seeded torch.Generator (the JAX package draws from jax.random, which
    torch cannot reproduce; pass its draw as `init_ids` to match it)."""
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, n, (n, k), generator=g, dtype=torch.int32)


def nn_descent(db: torch.Tensor, k: int, metric: str, rounds: int = 6,
               sample: int = 12, seed: int = 0,
               init_ids: Optional[torch.Tensor] = None,
               row_chunk: int = 16384) -> Tuple[torch.Tensor, torch.Tensor]:
    """Approximate kNN graph by fixed-round NN-descent.

    Candidates per round: current neighbors ∪ (first `sample` neighbors of
    each neighbor). Each round reads the previous round's ids for every
    row and writes a new array, chunk by chunk, so the result does not
    depend on `row_chunk`.
    """
    n = db.shape[0]
    dev = db.device
    ids = (random_init_ids(n, k, seed) if init_ids is None
           else torch.as_tensor(init_ids, dtype=torch.int32))
    ids = ids.to(dev)
    ar = torch.arange(n, dtype=torch.int32, device=dev)
    # avoid trivial self edges
    ids = torch.where(ids == ar[:, None], (ids + 1) % n, ids)
    new_ids = torch.empty_like(ids)
    dists = torch.empty((n, k), dtype=torch.float32, device=dev)
    for s in range(0, n, row_chunk):
        e = min(s + row_chunk, n)
        d0 = _gather_dists(db, ar[s:e].long(), ids[s:e], metric)
        new_ids[s:e], dists[s:e] = _merge_topk(ids[s:e], d0, ids[s:e], d0, k)
    ids = new_ids

    for _ in range(rounds):
        new_ids = torch.empty_like(ids)
        new_dists = torch.empty_like(dists)
        for s in range(0, n, row_chunk):
            e = min(s + row_chunk, n)
            rows = ar[s:e]
            nbr2 = ids[torch.clamp(ids[s:e], min=0).long()][:, :, :sample]
            nbr2 = nbr2.reshape(e - s, -1)                      # (c, k*sample)
            nbr2 = torch.where(nbr2 == rows[:, None],
                               torch.full_like(nbr2, -1), nbr2)
            d2 = _gather_dists(db, rows.long(), nbr2, metric)
            new_ids[s:e], new_dists[s:e] = _merge_topk(
                ids[s:e], dists[s:e], nbr2, d2, k)
        ids, dists = new_ids, new_dists
    return ids, dists


def build_knn(db: torch.Tensor, k: int, metric: str, builder: str = "auto",
              rounds: int = 6, sample: int = 12, seed: int = 0,
              brute_threshold: int = 20_000,
              init_ids: Optional[torch.Tensor] = None,
              row_chunk: int = 16384) -> Tuple[torch.Tensor, torch.Tensor]:
    n = db.shape[0]
    if builder == "auto":
        builder = "brute" if n <= brute_threshold else "nn_descent"
    if builder == "brute":
        # tiles of about 4 GiB of distances; rows are independent lanes,
        # so the result does not depend on the chunk
        chunk = max(256, min(4096, (1 << 30) // max(n, 1)))
        return brute_force_knn(db, k, metric, chunk=chunk)
    return nn_descent(db, k, metric, rounds=rounds, sample=sample, seed=seed,
                      init_ids=init_ids, row_chunk=row_chunk)


def medoid(db: torch.Tensor, metric: str = "l2") -> int:
    """Entry point: the vector closest to the dataset mean (cheap medoid);
    the first index on ties, as jnp.argmin."""
    mean = torch.mean(db, dim=0, keepdim=True)
    d = pairwise(mean, db, "l2")[0]
    return int(torch.argmin(d))
