"""Fixed-size sorted candidate queue (the priority queue of Algorithm 1).

The counterpart of the JAX package's `repro/core/queue.py`, bit for bit.
The reference writes every function for one query and lifts it with
`jax.vmap`; here every function takes a leading batch axis of Q queries.
The queue is a struct-of-arrays of length L kept sorted ascending by
distance:

  dists   f32   (Q, L)  +inf in empty slots
  ids     int32 (Q, L)  -1   in empty slots
  visited bool  (Q, L)  True in empty slots (so they are never expanded)

Its one write operation is a merge: the new block is sorted once
(stable) and merged against the sorted queue by rank arithmetic, which
equals a stable argsort of the concatenation with existing entries
winning ties.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

INF = float("inf")


class Queue(NamedTuple):
    dists: torch.Tensor    # (Q, L) f32, ascending
    ids: torch.Tensor      # (Q, L) int32
    visited: torch.Tensor  # (Q, L) bool


def init_queue(Q: int, L: int, device=None) -> Queue:
    return Queue(
        dists=torch.full((Q, L), INF, dtype=torch.float32, device=device),
        ids=torch.full((Q, L), -1, dtype=torch.int32, device=device),
        visited=torch.ones((Q, L), dtype=torch.bool, device=device),
    )


def _where(mask, a, fill):
    return torch.where(mask, torch.full_like(a, fill), a)


# --------------------------------------------------------------------------
# Dedupe helpers
# --------------------------------------------------------------------------
def dup_prior_mask(ids: torch.Tensor) -> torch.Tensor:
    """(Q, M) ids -> (Q, M) bool: True where ids[i] equals ids[j] for some
    j < i. Negative ids never match anything."""
    m = ids.shape[-1]
    ar = torch.arange(m, device=ids.device)
    tri = ar[None, :] < ar[:, None]
    eq = ids[..., :, None] == ids[..., None, :]
    return torch.any(eq & tri & (ids >= 0)[..., :, None], dim=-1)


def dedupe_ids(ids: torch.Tensor) -> torch.Tensor:
    """Mask (to -1) ids duplicating an earlier position, and invalid ids."""
    return _where(dup_prior_mask(ids) | (ids < 0), ids, -1)


def in_queue_mask(q: Queue, ids: torch.Tensor) -> torch.Tensor:
    """(Q, M) ids -> (Q, M) bool: id already present in the queue."""
    return torch.any(ids[:, :, None] == q.ids[:, None, :], dim=2) & (ids >= 0)


def _dedupe_new(q: Queue, new_dists: torch.Tensor, new_ids: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Invalidate new entries that duplicate the queue or earlier new ones."""
    bad = in_queue_mask(q, new_ids) | dup_prior_mask(new_ids) | (new_ids < 0)
    return _where(bad, new_dists, INF), _where(bad, new_ids, -1)


# --------------------------------------------------------------------------
# Sorted-run merge
# --------------------------------------------------------------------------
def sort_block(dists: torch.Tensor, ids: torch.Tensor
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stable ascending sort of each row's candidate block by distance."""
    sd, order = torch.sort(dists, dim=-1, stable=True)
    return sd, torch.gather(ids, -1, order)


def merge_sorted_runs(q: Queue, sd: torch.Tensor, si: torch.Tensor) -> Queue:
    """Merge the sorted queue with an ascending-sorted candidate block.

    Entry i of the queue lands at i + |{block < queue[i]}|, entry j of the
    block at j + |{queue <= block[j]}| — a permutation of [0, L+B), so the
    result equals a stable argsort over the concatenation (queue entries
    first on ties). PRECONDITION: `si` is deduped against the queue and
    within itself (masked entries carry dist=+inf, id=-1).
    """
    Q, L = q.dists.shape
    B = sd.shape[1]
    dev = q.dists.device
    pos_q = (torch.arange(L, device=dev)[None, :]
             + torch.searchsorted(sd.contiguous(), q.dists.contiguous(),
                                  side="left"))
    pos_b = (torch.arange(B, device=dev)[None, :]
             + torch.searchsorted(q.dists.contiguous(), sd.contiguous(),
                                  side="right"))
    n = L + B
    md = torch.zeros((Q, n), dtype=q.dists.dtype, device=dev)
    md.scatter_(1, pos_q, q.dists).scatter_(1, pos_b, sd)
    mi = torch.zeros((Q, n), dtype=q.ids.dtype, device=dev)
    mi.scatter_(1, pos_q, q.ids).scatter_(1, pos_b, si)
    # new entries enter unvisited; only queue entries carry True flags
    mv = torch.zeros((Q, n), dtype=torch.bool, device=dev)
    mv.scatter_(1, pos_q, q.visited)
    return Queue(dists=md[:, :L], ids=mi[:, :L], visited=mv[:, :L])


def block_ranks(q: Queue, all_dists: torch.Tensor, bests: torch.Tensor,
                ties_prior: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Insertion rank of each `bests[:, w]` in the merged (queue + block)
    order: #entries strictly better + existing-entry ties, plus the
    earlier-expansion exact ties `ties_prior`, capped at L; +inf ranks L."""
    L = q.dists.shape[1]
    qd = q.dists[:, None, :]
    b = bests[:, :, None]
    better = (torch.sum(qd < b, dim=2)
              + torch.sum(all_dists[:, None, :] < b, dim=2)
              + torch.sum(qd == b, dim=2))
    if ties_prior is not None:
        better = better + ties_prior
    capped = torch.clamp(better, max=L)
    return torch.where(torch.isinf(bests), torch.full_like(capped, L),
                       capped).to(torch.int32)


def beam_tie_counts(block: torch.Tensor, bests: torch.Tensor) -> torch.Tensor:
    """(Q, W, M) block dists, (Q, W) per-expansion bests -> (Q, W) counts
    of earlier-expansion entries exactly tying bests[:, w]."""
    W = block.shape[1]
    eq = torch.sum(block[:, None, :, :] == bests[:, :, None, None], dim=3)
    ar = torch.arange(W, device=block.device)
    tri = (ar[None, :] < ar[:, None])[None]
    return torch.sum(torch.where(tri, eq, torch.zeros_like(eq)),
                     dim=2).to(torch.int32)


def merge_insert(q: Queue, new_dists: torch.Tensor, new_ids: torch.Tensor
                 ) -> Tuple[Queue, torch.Tensor, torch.Tensor]:
    """Merge (new_dists, new_ids) into the queue. Returns (queue',
    best_rank (Q,), n_inserted (Q,)): the merged-order rank of the best new
    candidate (L if nothing was inserted) and how many new entries beat
    the queue's last slot."""
    L = q.dists.shape[1]
    nd, ni = _dedupe_new(q, new_dists, new_ids)
    sd, si = sort_block(nd, ni)
    out = merge_sorted_runs(q, sd, si)
    best_rank = block_ranks(q, nd, torch.amin(nd, dim=1)[:, None])[:, 0]
    n_inserted = torch.sum((nd < q.dists[:, L - 1:L]) & (ni >= 0),
                           dim=1).to(torch.int32)
    return out, best_rank, n_inserted


def merge_expand(q: Queue, new_dists: torch.Tensor, new_ids: torch.Tensor,
                 n_beam: int) -> Tuple[Queue, torch.Tensor]:
    """Beam merge of a PRE-DEDUPED (Q, W*M) block, flat in beam order,
    with duplicates / in-queue / invalid entries already masked to
    (+inf, -1). Returns (queue', best_ranks (Q, W))."""
    Q = new_dists.shape[0]
    block = new_dists.reshape(Q, n_beam, -1)
    bests = torch.amin(block, dim=2)
    sd, si = sort_block(new_dists, new_ids)
    out = merge_sorted_runs(q, sd, si)
    return out, block_ranks(q, new_dists, bests, beam_tie_counts(block, bests))


def merge_insert_beam(q: Queue, new_dists: torch.Tensor,
                      new_ids: torch.Tensor, n_beam: int
                      ) -> Tuple[Queue, torch.Tensor]:
    """Safe-for-any-input beam merge: _dedupe_new, then merge_expand."""
    nd, ni = _dedupe_new(q, new_dists, new_ids)
    return merge_expand(q, nd, ni, n_beam)


# --------------------------------------------------------------------------
# Expansion picking
# --------------------------------------------------------------------------
def pick_top_w(q: Queue, w: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Slot indices of the w closest unvisited entries per row, plus the
    existence mask: the FIRST w unvisited finite slots in queue order.
    Returns (idxs (Q, w) clamped into [0, L), has (Q, w) bool)."""
    Q, L = q.dists.shape
    dev = q.dists.device
    unv = (~q.visited) & torch.isfinite(q.dists)
    rank = torch.cumsum(unv.to(torch.int64), dim=1) - 1
    take = unv & (rank < w)
    # scatter slot i to column rank[i]; non-taken slots go to the spare
    # column w, which is dropped
    tgt = torch.where(take, rank, torch.full_like(rank, w))
    idxs = torch.full((Q, w + 1), L, dtype=torch.int64, device=dev)
    src = torch.arange(L, device=dev).expand(Q, L)
    idxs.scatter_(1, tgt, torch.where(take, src, torch.full_like(src, L)))
    idxs = idxs[:, :w]
    has = idxs < L
    return torch.clamp(idxs, max=L - 1), has


def pick_unvisited(q: Queue) -> Tuple[torch.Tensor, torch.Tensor]:
    """Index of the closest unvisited entry per row and whether one
    exists — pick_top_w with a beam of one."""
    idxs, has = pick_top_w(q, 1)
    return idxs[:, 0], has[:, 0]


def mark_visited(q: Queue, idx: torch.Tensor, do: torch.Tensor) -> Queue:
    return mark_visited_many(q, idx[:, None], do[:, None])


def mark_visited_many(q: Queue, idxs: torch.Tensor, do: torch.Tensor) -> Queue:
    """Mark several slots per row at once (an OR over clamped duplicates
    of do=False lanes)."""
    hit = torch.zeros(q.visited.shape, dtype=torch.int32,
                      device=q.visited.device)
    hit.scatter_add_(1, idxs.long(), do.to(torch.int32))
    return q._replace(visited=q.visited | (hit > 0))


def topk(q: Queue, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Final result extraction (queue is sorted): first k entries."""
    return q.dists[:, :k], q.ids[:, :k]
