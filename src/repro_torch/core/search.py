"""Batched beam-parallel best-first traversal (paper Algorithm 1 + Eq. 3).

The counterpart of the JAX package's `repro/core/search.py` (DESIGN.md §2).
A batch of Q queries runs in lockstep with a per-query `active` mask; each
iteration expands the top-W unvisited candidates of every active query and
scores all W*M gathered neighbors in one (Q, W*M) distance step. Where the
reference runs a `jax.lax.while_loop`, this runs a host `while` over
eagerly launched tensor ops, with one device sync per iteration to read
the loop condition `any(active) & it < hops_bound`; an iteration's
candidate filter (the neighbor gather, dedupe, visited and in-queue
masks) is one call of `kernels.ops.beam_filter`. Each stage runs in a
span of `repro_torch.spans` (a no-op unless the recorder is on), and each
exit check counts one `sync`.

Visited-set semantics: "bitmap" keeps a packed per-query bitmap of the
nodes whose distance was computed (32 bits per int64 word, so the
scatter-add that sets disjoint bits equals a bitwise or); "queue" dedupes
only against the candidate queue.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import torch

from repro_torch import spans
from repro_torch.core import queue as qmod
from repro_torch.core.types import SearchConfig

# dist_fn(queries (Q, d), nbr_ids (Q, B) int32) -> (Q, B) float32
DistFn = Callable[[torch.Tensor, torch.Tensor], torch.Tensor]

# expand_fn(queries (Q, d), nbr_ids (Q, W*M) int32) ->
#   (sorted_dists (Q, T), sorted_ids (Q, T), bests (Q, W), ties (Q, W))
ExpandFn = Callable[[torch.Tensor, torch.Tensor],
                    Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                          torch.Tensor]]


class SearchStats(NamedTuple):
    n_hops: torch.Tensor            # (Q,) int32 nodes expanded
    n_dist: torch.Tensor            # (Q,) int32 distances computed
    early_terminated: torch.Tensor  # (Q,) bool
    iters: torch.Tensor             # () int32 lockstep iterations


def _bitmap_test(bitmap: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """(Q, nwords) int64 bitmap, (Q, M) ids -> (Q, M) bool seen."""
    safe = torch.clamp(ids, min=0).long()
    words = torch.gather(bitmap, 1, safe >> 5)
    bit = (words >> (safe & 31)) & 1
    return (bit == 1) & (ids >= 0)


def _bitmap_set_raw(bitmap: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Set bits via scatter-add. PRECONDITION: ids are deduped within each
    row AND none of their bits are already set, so the add equals an or."""
    valid = ids >= 0
    safe = torch.clamp(ids, min=0).long()
    word_idx = torch.where(valid, safe >> 5,
                           torch.full_like(safe, bitmap.shape[1] - 1))
    val = torch.where(valid, torch.ones_like(safe) << (safe & 31),
                      torch.zeros_like(safe))
    return bitmap.scatter_add(1, word_idx, val)


def _bitmap_set(bitmap: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Set bits for valid ids: safe for ANY input (dedupes, skips set
    bits)."""
    ids = qmod.dedupe_ids(ids)
    ids = torch.where(_bitmap_test(bitmap, ids), torch.full_like(ids, -1), ids)
    return _bitmap_set_raw(bitmap, ids)


def _dist_chunked(dist_fn: DistFn, queries: torch.Tensor, ids: torch.Tensor,
                  batch_B: int) -> torch.Tensor:
    """Distances over the candidate axis, optionally in batch_B chunks."""
    C = ids.shape[1]
    if batch_B <= 0 or batch_B >= C:
        return dist_fn(queries, ids)
    return torch.cat([dist_fn(queries, ids[:, s:s + batch_B].contiguous())
                      for s in range(0, C, batch_B)], dim=1)


def search(graph: torch.Tensor, queries: torch.Tensor,
           entry_ids: torch.Tensor, *, dist_fn: DistFn, cfg: SearchConfig,
           n_total: int, valid_mask: Optional[torch.Tensor] = None,
           expand_fn: Optional[ExpandFn] = None
           ) -> Tuple[torch.Tensor, torch.Tensor, SearchStats]:
    """Batched ANN search. Returns (dists (Q, k), ids (Q, k), stats).

    `valid_mask` marks real queries of a padded batch: invalid lanes start
    inactive and add no distance computations (their rows still hold the
    seed entries; `search_padded` masks them). `expand_fn`, when given and
    `cfg.batch_B == 0`, replaces dist_fn + block sort with the fused
    gather+distance+sort step for the per-iteration block.
    """
    from repro_torch.kernels import ops as kops

    dev = queries.device
    Q = queries.shape[0]
    L, k = cfg.L, cfg.k
    W = cfg.beam_width
    t_pos = int(cfg.et_t_frac * L)
    use_fused = expand_fn is not None and cfg.batch_B == 0
    inf = float("inf")

    # ---- init: seed the queue with the entry points ----------------------
    with spans.span("search.seed"):
        e_ids = entry_ids.to(device=dev, dtype=torch.int32)[None, :].expand(
            Q, entry_ids.shape[0]).contiguous()
        e_dists = dist_fn(queries, e_ids)
        queue, _, _ = qmod.merge_insert(qmod.init_queue(Q, L, dev), e_dists,
                                        e_ids)
        bitmap = None                  # queue mode keeps no visited set
        if cfg.visited_mode == "bitmap":
            bitmap = _bitmap_set(torch.zeros((Q, (n_total + 31) // 32),
                                             dtype=torch.int64, device=dev),
                                 e_ids)

        # seed distances count toward n_dist, on valid lanes only
        active = (torch.ones((Q,), dtype=torch.bool, device=dev)
                  if valid_mask is None else valid_mask.to(dev).bool())
        ndist = torch.where(active, torch.sum(e_ids >= 0, dim=1),
                            torch.zeros((), dtype=torch.int64, device=dev)
                            ).to(torch.int32)
        et_ctr = torch.zeros((Q,), dtype=torch.int32, device=dev)
        fired = torch.zeros((Q,), dtype=torch.bool, device=dev)
        hops = torch.zeros((Q,), dtype=torch.int32, device=dev)
        rows = torch.arange(Q, device=dev)[:, None]
    it = 0

    while it < cfg.hops_bound:
        # the loop's exit: the one host sync of an iteration
        with spans.span("search.exit_sync"):
            spans.count("sync")
            go = bool(active.any())
        if not go:
            break
        with spans.span("search.iter"):
            # the W closest unvisited candidates per lane
            idxs, has = qmod.pick_top_w(queue, W)
            exp_w = active[:, None] & has                       # (Q, W)
            any_has = has.any(dim=1)
            exp_any = active & any_has
            v = torch.where(exp_w, queue.ids[rows, idxs], torch.full_like(
                queue.ids[rows, idxs], -1))
            queue = qmod.mark_visited_many(queue, idxs, exp_w)

            with spans.span("search.iter.filter"):
                # all W neighbor lists at once, deduped in flat beam order,
                # bitmap-visited ones masked (their bits set in place),
                # counted, and those already in the queue masked BEFORE
                # the distance step (the merge would discard them; the
                # fused step requires it)
                flat, n_new = kops.beam_filter(v, graph,
                                               queue.ids.contiguous(), bitmap)

            with spans.span("search.iter.expand"):
                if use_fused:
                    sd, si, bests, ties = expand_fn(queries, flat)
                    merged = qmod.merge_sorted_runs(queue, sd, si)
                    ranks = qmod.block_ranks(queue, sd, bests, ties)
                else:
                    nd = _dist_chunked(dist_fn, queries, flat, cfg.batch_B)
                    nd = torch.where(flat >= 0, nd, torch.full_like(nd, inf))
                    merged, ranks = qmod.merge_expand(queue, nd, flat, W)
                sel = exp_any[:, None]
                queue = qmod.Queue(
                    torch.where(sel, merged.dists, queue.dists),
                    torch.where(sel, merged.ids, queue.ids),
                    torch.where(sel, merged.visited, queue.visited))

            with spans.span("search.iter.et"):
                # early termination, Eq. 3: per expansion, in beam order
                beyond = ranks > t_pos
                for w in range(W):
                    ex = exp_w[:, w]
                    et_ctr = torch.where(
                        ex, torch.where(beyond[:, w], et_ctr + 1,
                                        torch.zeros_like(et_ctr)), et_ctr)
                    if cfg.early_term:
                        fired = fired | (ex & (et_ctr >= cfg.et_patience))

                hops = hops + exp_w.sum(dim=1).to(torch.int32)
                ndist = ndist + torch.where(exp_any, n_new,
                                            torch.zeros_like(n_new))
                active = active & any_has & ~fired & (hops < cfg.hops_bound)
            it += 1

    with spans.span("search.topk"):
        dists_k, ids_k = qmod.topk(queue, k)
        stats = SearchStats(hops, ndist, fired,
                            torch.tensor(it, dtype=torch.int32))
    return dists_k, ids_k, stats


def make_dist_fn(db: torch.Tensor, metric: str, impl: str = "ref") -> DistFn:
    """Gather-then-distance backend over a database (n, d).

    impl="ref" is the plain gather + batched_one_to_many path; "kernel"
    routes through the gather_dist kernel (its plain version on the CPU).
    """
    if impl == "kernel":
        from repro_torch.kernels import ops as kops

        def fn(queries, nbr_ids):
            return kops.gather_dist(queries, db, nbr_ids, metric=metric)
        return fn

    from repro_torch.core.distance import batched_one_to_many

    def fn(queries, nbr_ids):
        vecs = db[torch.clamp(nbr_ids, min=0).long()]
        return batched_one_to_many(queries, vecs, metric)
    return fn


def make_expand_fn(db: torch.Tensor, metric: str, *, L: int,
                   n_beam: int) -> ExpandFn:
    """Fused gather+distance+sort backend for the beam traversal's
    per-iteration candidate block (the fused_expand kernel)."""
    from repro_torch.kernels import ops as kops

    def fn(queries, nbr_ids):
        return kops.fused_expand(queries, db, nbr_ids, metric=metric,
                                 L=L, n_beam=n_beam)
    return fn
