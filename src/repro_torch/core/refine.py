"""Index refinement (paper §3.2, A1): edge selection + 2-hop iteration.

The counterpart of the JAX package's `repro/core/refine.py`. Pipeline: kNN
graph -> edge-selection rule -> search-based refinement with a reverse
pass -> F rounds of {expand candidates to the 2-hop neighborhood,
re-select} -> reverse-edge fill -> connectivity repair. Selection rules:

  alpha (Vamana/NSG): accept c iff for every already-selected s,
        d(node, c) < alpha * d(s, c)            (hnsw == alpha with a=1.0)
  ssg:  accept c iff for every selected s, the angle at `node` between
        (c - node) and (s - node) is >= theta.

Every per-node step treats the rows as independent lanes, so the results
do not depend on `node_chunk`; the port runs large chunks on the card.
The host passes (`_reverse_proposals`, `add_reverse_edges`, the
reachability sweeps of `connectivity_repair`) are numpy, vectorised where
the output stays identical to the reference's Python loops.
"""
from __future__ import annotations

import time
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch.core.build import _merge_topk


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def select_edges(db: torch.Tensor, rows: torch.Tensor, cand_ids: torch.Tensor,
                 cand_dists: torch.Tensor, *, M: int, rule: str, metric: str,
                 alpha: float = 1.2, cos_theta: float = 0.5) -> torch.Tensor:
    """Greedy rule-based pruning of sorted candidates to <=M edges per node.

    rows: (nc,) node ids; cand_ids/cand_dists: (nc, C) sorted ascending,
    -1/inf padded. Returns (nc, M) int32.
    """
    nc, C = cand_ids.shape
    dev = db.device
    node_vecs = db[rows.long()]                     # (nc, d)
    sel_ids = torch.full((nc, M), -1, dtype=torch.int32, device=dev)
    sel_cnt = torch.zeros((nc,), dtype=torch.int32, device=dev)
    sel_vecs = torch.zeros((nc, M, db.shape[1]), dtype=db.dtype, device=dev)
    slots = torch.arange(M, device=dev)[None, :]
    for j in range(C):
        cid = cand_ids[:, j]
        cdist = cand_dists[:, j]
        cvec = db[torch.clamp(cid, min=0).long()]   # (nc, d)
        slot_mask = slots < sel_cnt[:, None]
        if rule == "ssg":
            u = cvec - node_vecs
            v = sel_vecs - node_vecs[:, None, :]
            num = torch.einsum("nmd,nd->nm", v, u)
            den = (torch.linalg.norm(v, dim=-1)
                   * torch.linalg.norm(u, dim=-1)[:, None])
            cos = num / torch.clamp(den, min=1e-12)
            violate = torch.any(slot_mask & (cos > cos_theta), dim=1)
        else:  # alpha / hnsw; diversity geometry in L2 of the raw vectors
            diff = sel_vecs - cvec[:, None, :]
            d_sc = torch.sum(diff * diff, dim=-1)
            d_pc = torch.sum((cvec - node_vecs) ** 2, dim=-1)
            violate = torch.any(
                slot_mask & (d_pc[:, None] >= (alpha * alpha) * d_sc), dim=1)
        accept = (cid >= 0) & torch.isfinite(cdist) & ~violate & (sel_cnt < M)
        pos = torch.clamp(sel_cnt, max=M - 1)
        hit = accept[:, None] & (slots == pos[:, None])
        sel_ids = torch.where(hit, cid[:, None], sel_ids)
        sel_vecs = torch.where(hit[:, :, None], cvec[:, None, :], sel_vecs)
        sel_cnt = sel_cnt + accept.to(torch.int32)
    # guarantee out-degree >= 1 (keep the closest candidate)
    empty = sel_cnt == 0
    sel_ids[:, 0] = torch.where(empty, cand_ids[:, 0], sel_ids[:, 0])
    return sel_ids


def _chunk_dists(db: torch.Tensor, rows: torch.Tensor, ids: torch.Tensor,
                 metric: str) -> torch.Tensor:
    """d(db[rows[i]], db[ids[i, j]]) with -1 masked to inf. (nc, C)."""
    vecs = db[torch.clamp(ids, min=0).long()]
    base = db[rows.long()]
    if metric == "l2":
        diff = vecs - base[:, None, :]
        out = torch.sum(diff * diff, dim=-1)
    else:
        out = -torch.einsum("ncd,nd->nc", vecs, base)
    return torch.where(ids >= 0, out, torch.full_like(out, float("inf")))


def _pad_merge(ids: torch.Tensor, dists: torch.Tensor, k: int
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """_merge_topk of one set against an empty (-1, inf) column."""
    nc = ids.shape[0]
    return _merge_topk(
        ids, dists,
        torch.full((nc, 1), -1, dtype=torch.int32, device=ids.device),
        torch.full((nc, 1), float("inf"), dtype=torch.float32,
                   device=ids.device), k)


def expand_two_hop(db: torch.Tensor, graph: torch.Tensor, rows: torch.Tensor,
                   *, C: int, metric: str) -> Tuple[torch.Tensor, torch.Tensor]:
    """Candidates = 1-hop ∪ 2-hop neighbors of `rows`, deduped, top-C."""
    g1 = graph[rows.long()]                                     # (nc, M)
    M = graph.shape[1]
    g2 = torch.where(g1[:, :, None] >= 0, graph[torch.clamp(g1, min=0).long()],
                     torch.full((1, 1, 1), -1, dtype=graph.dtype,
                                device=graph.device)
                     ).reshape(g1.shape[0], M * M)
    cands = torch.cat([g1, g2], dim=1)
    cands = torch.where(cands == rows[:, None], torch.full_like(cands, -1),
                        cands)
    dists = _chunk_dists(db, rows, cands, metric)
    return _pad_merge(cands, dists, C)


def _edge_keys(graph: np.ndarray, reverse: bool) -> np.ndarray:
    """Sorted int64 keys of the valid edges u->v: u*n+v, or v*n+u with
    `reverse`. Sorting (v, u) keys orders every target's proposers by u,
    which is the reference loops' edge order (u-major, then slot)."""
    n, M = graph.shape
    us = np.repeat(np.arange(n, dtype=np.int64), M)
    vs = graph.reshape(-1).astype(np.int64)
    ok = vs >= 0
    us, vs = us[ok], vs[ok]
    return np.sort(vs * n + us if reverse else us * n + vs)


def _rank_in_group(groups: np.ndarray) -> np.ndarray:
    """Position of each entry within its run of equal (sorted) values."""
    return np.arange(len(groups)) - np.searchsorted(groups, groups, "left")


def _reverse_proposals(graph: np.ndarray, cap: int) -> np.ndarray:
    """(n, cap) int32 of reverse-edge proposers per node (-1 padded): for
    each target, its first `cap` proposers in edge order — the same output
    as the reference's edge-by-edge loop."""
    n = graph.shape[0]
    out = np.full((n, cap), -1, dtype=np.int32)
    keys = _edge_keys(graph, reverse=True)
    vs, us = keys // n, keys % n
    rank = _rank_in_group(vs)
    keep = rank < cap
    out[vs[keep], rank[keep]] = us[keep]
    return out


def reverse_merge_select(db: torch.Tensor, graph: np.ndarray, *, M: int,
                         rule: str, metric: str, alpha: float,
                         cos_theta: float, node_chunk: int = 512,
                         rev_cap: Optional[int] = None) -> np.ndarray:
    """Vamana-style reverse-edge pass WITH re-pruning: each node re-runs
    the edge-selection rule over {current edges} ∪ {proposals}."""
    n = graph.shape[0]
    dev = db.device
    rev_cap = rev_cap or 2 * M
    rev = _reverse_proposals(np.asarray(graph), rev_cap)
    g = torch.as_tensor(np.asarray(graph), device=dev)
    rv = torch.as_tensor(rev, device=dev)
    rows_all = torch.arange(n, dtype=torch.int32, device=dev)
    outs = []
    for s in range(0, n, node_chunk):
        e = min(s + node_chunk, n)
        rows = rows_all[s:e]
        pool = torch.cat([g[s:e], rv[s:e]], dim=1)
        pool = torch.where(pool == rows[:, None], torch.full_like(pool, -1),
                           pool)
        d = _chunk_dists(db, rows, pool, metric)
        ci, cd = _pad_merge(pool, d, pool.shape[1])
        outs.append(select_edges(db, rows, ci, cd, M=M, rule=rule,
                                 metric=metric, alpha=alpha,
                                 cos_theta=cos_theta))
    return torch.cat(outs, dim=0).cpu().numpy()


def _add_reverse_edges_loop(graph: np.ndarray, max_degree: int
                            ) -> np.ndarray:
    """The reference's edge-by-edge loop, for graphs with -1 slots before
    valid ones (its row writes then overwrite edges it has yet to read)."""
    graph = np.asarray(graph).copy()
    n, M = graph.shape
    deg = (graph >= 0).sum(axis=1)
    existing = [set(row[row >= 0].tolist()) for row in graph]
    for u in range(n):
        for v in graph[u]:
            if v < 0:
                continue
            v = int(v)
            if deg[v] < max_degree and u not in existing[v]:
                graph[v, deg[v]] = u
                existing[v].add(u)
                deg[v] += 1
    return graph


def add_reverse_edges(graph: np.ndarray, max_degree: int) -> np.ndarray:
    """Fill -1 slots with reverse edges (host-side build step): every edge
    u->v proposes v->u, accepted while v has spare capacity and does not
    hold u yet.

    Vectorised with the reference loop's exact outcome when every row's
    -1 slots trail its edges (as select_edges leaves them): edges are
    taken in (u, slot) order; an edge added to row v before v is visited
    proposes v->u back to a row that already holds v, so only the original
    edges can be accepted. Per target v, the accepted proposers are the
    first `max_degree - deg(v)` distinct ones not already in v's row, in
    ascending u, written from slot deg(v) on. Other graphs take the
    loop."""
    graph = np.asarray(graph).copy()
    n, M = graph.shape
    assert max_degree <= M
    valid = graph >= 0
    if np.any(valid[:, 1:] & ~valid[:, :-1]):
        return _add_reverse_edges_loop(graph, max_degree)
    deg = valid.sum(axis=1)
    prop = _edge_keys(graph, reverse=True)              # v*n+u, sorted
    if len(prop) == 0:
        return graph
    prop = prop[np.r_[True, prop[1:] != prop[:-1]]]     # distinct (v, u)
    edges = _edge_keys(graph, reverse=False)            # u*n+v, sorted
    hit = np.minimum(np.searchsorted(edges, prop), len(edges) - 1)
    prop = prop[edges[hit] != prop]                     # u not in row v
    vs, us = prop // n, prop % n
    rank = _rank_in_group(vs)
    keep = deg[vs] + rank < max_degree
    graph[vs[keep], deg[vs[keep]] + rank[keep]] = us[keep]
    return graph


def search_candidates(db: torch.Tensor, graph: torch.Tensor, rows: torch.Tensor,
                      entry: int, metric: str, search_L: int
                      ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Search-based candidate generation: the batched traversal with
    db[rows] as queries over the current graph from the global entry
    point, returning the final candidate queue per node (the reference
    keeps dist_impl="ref" here, and so does the port)."""
    from repro_torch.core import search as search_mod
    from repro_torch.core.types import SearchConfig

    cfg = SearchConfig(L=search_L, k=search_L, early_term=False,
                       visited_mode="queue", n_entries=1)
    dist_fn = search_mod.make_dist_fn(db, metric, "ref")
    dists, ids, _ = search_mod.search(
        graph, db[rows.long()], torch.tensor([entry], dtype=torch.int32),
        dist_fn=dist_fn, cfg=cfg, n_total=db.shape[0])
    ids = torch.where(ids == rows[:, None], torch.full_like(ids, -1), ids)
    dists = torch.where(ids >= 0, dists, torch.full_like(dists, float("inf")))
    return ids.to(torch.int32), dists


def refine_graph(db: torch.Tensor, knn_ids: torch.Tensor,
                 knn_dists: torch.Tensor, *, M: int, rule: str, metric: str,
                 alpha: float, ssg_angle_deg: float, iters: int,
                 cand_cap: int, entry: int = 0, search_L: int = 48,
                 search_passes: int = 1, node_chunk: int = 512,
                 timings: Optional[Dict[str, float]] = None) -> np.ndarray:
    """Full A1 pipeline. Returns the final (n, M) int32 padded CSR graph
    (numpy). `timings`, when given, receives the seconds of each phase."""
    cos_theta = float(np.cos(np.deg2rad(ssg_angle_deg)))
    n = db.shape[0]
    dev = db.device
    all_rows = torch.arange(n, dtype=torch.int32, device=dev)
    times = timings if timings is not None else {}
    t0 = time.perf_counter()

    def _lap(name):
        nonlocal t0
        _sync(dev)
        t = time.perf_counter()
        times[name] = times.get(name, 0.0) + (t - t0)
        t0 = t

    def _select(cids, cdists):
        outs = []
        for s in range(0, n, node_chunk):
            e = min(s + node_chunk, n)
            outs.append(select_edges(
                db, all_rows[s:e], cids[s:e], cdists[s:e], M=M, rule=rule,
                metric=metric, alpha=alpha, cos_theta=cos_theta))
        return torch.cat(outs, dim=0)

    if rule == "none":
        graph = knn_ids[:, :M].contiguous()
    else:
        graph = _select(knn_ids, knn_dists)
    _lap("select_knn")

    # --- phase 2 of A1: search-based neighborhood refinement ----------------
    # The graph searched during refinement is {current graph} ∪ {R random
    # long edges per node} (numpy's default_rng(0), as in the reference).
    sel_rule = rule if rule != "none" else "alpha"
    rng = np.random.default_rng(0)
    n_rand = max(4, M // 4)
    for _ in range(0 if rule == "none" else search_passes):
        rand_edges = torch.as_tensor(
            rng.integers(0, n, size=(n, n_rand), dtype=np.int32), device=dev)
        search_graph = torch.cat([graph, rand_edges], dim=1)
        cid_chunks, cd_chunks = [], []
        for s in range(0, n, node_chunk):
            e = min(s + node_chunk, n)
            sc_ids, sc_d = search_candidates(
                db, search_graph, all_rows[s:e], entry, metric, search_L)
            # pool: search results ∪ current edges ∪ original kNN
            pool_ids = torch.cat([sc_ids, graph[s:e], knn_ids[s:e]], dim=1)
            pool_d = torch.cat(
                [sc_d, _chunk_dists(db, all_rows[s:e], graph[s:e], metric),
                 knn_dists[s:e]], dim=1)
            ci, cd = _pad_merge(pool_ids, pool_d, cand_cap)
            cid_chunks.append(ci)
            cd_chunks.append(cd)
        _lap("search_pass")
        graph = _select(torch.cat(cid_chunks, 0), torch.cat(cd_chunks, 0))
        _lap("select_search")
        # Vamana-style reverse pass with re-pruning: stitches islands.
        graph = torch.as_tensor(reverse_merge_select(
            db, graph.cpu().numpy(), M=M, rule=sel_rule, metric=metric,
            alpha=alpha, cos_theta=cos_theta, node_chunk=node_chunk),
            device=dev)
        _lap("reverse_merge_select")

    # --- phase 3 of A1: iterative 2-hop expansion ---------------------------
    for _ in range(iters):
        cid_chunks, cd_chunks = [], []
        for s in range(0, n, node_chunk):
            e = min(s + node_chunk, n)
            ci, cd = expand_two_hop(db, graph, all_rows[s:e], C=cand_cap,
                                    metric=metric)
            cid_chunks.append(ci)
            cd_chunks.append(cd)
        graph = _select(torch.cat(cid_chunks, 0), torch.cat(cd_chunks, 0))
        _lap("two_hop")

    graph = add_reverse_edges(graph.cpu().numpy(), M)
    _lap("add_reverse_edges")
    graph = connectivity_repair(db, graph, entry, metric)
    _lap("connectivity_repair")
    return graph


def _flood(g: np.ndarray, seen: np.ndarray, start: int) -> np.ndarray:
    """Mark everything reachable from `start` in `seen` (in place), one
    frontier at a time — the same reached set as a queue BFS — and return
    the newly marked nodes, ascending."""
    seen[start] = True
    frontier = np.array([start], dtype=np.int64)
    reached = [frontier]
    while len(frontier):
        nb = g[frontier].reshape(-1)
        nb = nb[nb >= 0]
        nb = np.unique(nb[~seen[nb]]).astype(np.int64)
        seen[nb] = True
        reached.append(nb)
        frontier = nb
    return np.sort(np.concatenate(reached))


_REPAIR_BLOCK = 512     # the reference's block of unreachable nodes
_REPAIR_BATCH = 256     # most candidate links examined per round trip


def connectivity_repair(db: torch.Tensor, graph: np.ndarray, entry: int,
                        metric: str) -> np.ndarray:
    """NSG-style spanning pass: guarantee every node is reachable from the
    entry by linking each unreachable region to its nearest reachable node
    (replacing the victim's worst edge if it has no spare slot).

    The reference recomputes every (reachable, unreachable) distance at
    each link, in blocks of 512 unreachable nodes, and takes the first
    minimum in (block, reachable id, unreachable id) order. Here each
    unreachable node keeps its nearest reachable node (lowest id on ties)
    on db's device, relaxed only by the nodes each link makes reachable,
    and the link is the minimum of (distance, block, reachable id,
    unreachable id) over the nodes still unreachable — the same choice,
    at a cost that grows with the newly reached nodes instead of n.

    An inner-product graph over 10^6 random vectors leaves about half its
    nodes unreachable, so links are taken in rounds of one device round
    trip each: the nearest unreachable nodes in order, for as long as
    each is provably the next link. That holds while its distance is
    unique among the nodes still unreachable and below the distance of
    every link before it in the round to its own nearest unreachable
    node (a lower bound on what that link can relax any node to, known
    before the round; a margin covers the rounding of the two
    computations), and every link before it reached that one node only.
    A tie ends the round; a tie at its head takes one link by the
    reference's whole order. The next round examines twice as many
    candidates as this one linked (each costs a row of distances)."""
    g = np.asarray(graph).copy()
    n, M = g.shape
    seen = np.zeros(n, dtype=bool)
    _flood(g, seen, entry)
    un = np.nonzero(~seen)[0]
    if len(un) == 0:
        return g
    dev = db.device
    xu = db[torch.as_tensor(un, device=dev)]
    uu = (xu ** 2).sum(1) if metric == "l2" else None
    U = len(un)
    best_d = torch.full((U,), float("inf"), device=dev)
    best_r = torch.full((U,), n, dtype=torch.int64, device=dev)
    alive = torch.ones(U, dtype=torch.bool, device=dev)
    inf = float("inf")

    def chunks(xs: torch.Tensor):
        """(start, distances of the rows xs to un[start:start+step])."""
        ss = (xs ** 2).sum(1)[:, None] if metric == "l2" else None
        step = max(1, (1 << 28) // max(1, len(xs)))   # ~1 GiB of d
        for s in range(0, U, step):
            if metric == "l2":
                yield s, ((ss + uu[None, s:s + step])
                          - 2.0 * xs @ xu[s:s + step].T)
            else:
                yield s, -(xs @ xu[s:s + step].T)

    def relax(src: np.ndarray) -> None:
        src_t = torch.as_tensor(src, device=dev)
        for s, d in chunks(db[src_t]):
            e = s + d.shape[1]
            dmin, row = torch.min(d, dim=0)          # first row on ties
            r = src_t[row]
            bd, br = best_d[s:e], best_r[s:e]
            better = (dmin < bd) | ((dmin == bd) & (r < br))
            best_d[s:e] = torch.where(better, dmin, bd)
            best_r[s:e] = torch.where(better, r, br)

    def nearest_alive(cand: torch.Tensor) -> list:
        """Each candidate's least distance to another unreachable node."""
        out = torch.full((len(cand),), inf, device=dev)
        for s, d in chunks(xu[cand]):
            cols = torch.arange(s, s + d.shape[1], device=dev)
            ok = (alive[None, s:s + d.shape[1]]
                  & (cols[None] != cand[:, None]))
            d = torch.where(ok, d, torch.full_like(d, inf))
            out = torch.minimum(out, d.min(dim=1).values)
        return out.tolist()

    def link(i: int, r: int) -> np.ndarray:
        """Link un[i] from r; returns the nodes this makes reachable."""
        spare = np.nonzero(g[r] < 0)[0]
        slot = spare[0] if len(spare) else M - 1   # replace worst (last) edge
        g[r, slot] = un[i]
        return _flood(g, seen, int(un[i]))

    def exact_link() -> np.ndarray:
        """One link by the reference's whole order (distance ties)."""
        big = torch.iinfo(torch.int64).max
        # the reference's block of each node among those still unreachable
        block = (torch.cumsum(alive.long(), 0) - 1) // _REPAIR_BLOCK
        dd = torch.where(alive, best_d, torch.full_like(best_d, inf))
        cand = alive & (dd == dd.min())
        for key in (block, best_r):
            k = torch.where(cand, key, torch.full_like(key, big))
            cand = cand & (k == k.min())
        i = int(torch.nonzero(cand)[0, 0])
        return link(i, int(best_r[i]))

    relax(np.nonzero(seen)[0])
    n_alive, guard, batch = U, 0, _REPAIR_BATCH
    while n_alive and guard < n:
        dd = torch.where(alive, best_d, torch.full_like(best_d, inf))
        vals, pos = torch.topk(dd, min(batch + 1, n_alive), largest=False,
                               sorted=True)
        v, p, rr = torch.stack([vals.double(), pos.double(),
                                best_r[pos].double()]).tolist()
        p = [int(x) for x in p]
        # the run of candidates with distinct distances; the last one
        # listed is not known to be distinct unless every node is listed
        J = next((j for j in range(len(v) - 1) if v[j] == v[j + 1]),
                 len(v) if len(v) == n_alive else len(v) - 1)
        if J == 0:
            reached = [exact_link()]
            guard += 1
        else:
            m = nearest_alive(torch.as_tensor(p[:J], device=dev))
            reached, low = [], inf
            for j in range(J):
                if guard >= n or (j and low <= v[j] + 1e-5 * (
                        abs(v[j]) + abs(low)) + 1e-30):
                    break
                reached.append(link(p[j], int(rr[j])))
                guard += 1
                low = min(low, m[j])
                if len(reached[-1]) > 1:
                    break
            batch = min(_REPAIR_BATCH, max(2, 2 * len(reached)))
        new = np.concatenate(reached)
        alive[torch.as_tensor(np.searchsorted(un, new), device=dev)] = False
        n_alive -= len(new)
        if n_alive:
            relax(new)
    return g
