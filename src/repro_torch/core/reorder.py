"""Graph reordering for memory locality (paper §3.2, Algorithm 2).

Host-side build-time transform (numpy), a copy of the JAX package's
`repro/core/reorder.py` so the permutation is the same bit for bit. The paper's algorithm:
  1. build an MST of the proximity graph (edge weight = vector distance),
  2. root it at the entry node,
  3. compute subtree sizes met(v) with an iterative DFS,
  4. emit nodes by a priority traversal that always pops the frontier node
     with the largest subtree — clustering dense regions contiguously while
     *preserving* the long-range shortcuts that Cuthill-McKee style BFS
     relabelling destroys.

On TPU the payoff is DMA locality: consecutive beam frontiers hit nearby
HBM rows, so the gather_dist kernel touches fewer distinct pages per step
(measured as `locality` in benchmarks/ablation.py).

Also provides Cuthill-McKee as the baseline the paper compares against, and
`apply_order` to physically permute vectors + graph.

Used by: `core/index.py: KBest.add` (graph family) as the step after
`core/refine.py`'s edge refinement, selected by `BuildConfig.reorder`
("mst" | "cm" | "none"); the tuned presets in `configs/kbest.py` all pick
"mst". The search path never sees the permutation — `KBest._search_impl`
translates result ids back through the stored order, and `save/load`
round-trips it. Ablated as `locality` in `benchmarks/ablation.py`.
"""
from __future__ import annotations

import heapq
from typing import Tuple

import numpy as np


def _mst_children(graph: np.ndarray, weights: np.ndarray, root: int
                  ) -> Tuple[list, np.ndarray]:
    """Kruskal MST over the (directed, padded) index graph, undirected view.

    Returns (children adjacency list rooted at `root`, parent array). Nodes
    disconnected from the root's component are attached under the root so
    the ordering is always a full permutation.

    The edges are taken in stable weight order and an edge is kept iff its
    ends lie in different components at that moment — which edges are kept
    does not depend on how the union-find is written, so this one keeps
    its parents in a Python list (path halving, inlined) and stops once
    n - 1 edges are kept (no later edge can join two components). The
    result equals the JAX package's `_DSU` loop bit for bit; at 1M nodes
    and 24M edges it is several times faster.
    """
    n, M = graph.shape
    us = np.repeat(np.arange(n), M)
    vs = graph.reshape(-1)
    ws = weights.reshape(-1)
    valid = vs >= 0
    us, vs, ws = us[valid], vs[valid], ws[valid]
    order = np.argsort(ws, kind="stable")

    p = list(range(n))
    adj = [[] for _ in range(n)]
    need = n - 1
    for u, v in zip(us[order].tolist(), vs[order].tolist()):
        a = u
        while p[a] != a:
            p[a] = p[p[a]]
            a = p[a]
        b = v
        while p[b] != b:
            p[b] = p[p[b]]
            b = p[b]
        if a == b:
            continue
        p[a] = b
        adj[u].append(v)
        adj[v].append(u)
        need -= 1
        if need == 0:
            break

    # root the forest at `root`; DFS assigns parents
    parent = [-1] * n
    seen = [False] * n
    children = [[] for _ in range(n)]
    stack = [root]
    seen[root] = True
    while stack:
        u = stack.pop()
        for v in adj[u]:
            if not seen[v]:
                seen[v] = True
                parent[v] = u
                children[u].append(v)
                stack.append(v)
    # attach stray components under the root
    for v in range(n):
        if not seen[v] and v != root:
            parent[v] = root
            children[root].append(v)
            seen[v] = True
    return children, np.asarray(parent, dtype=np.int64)


def _subtree_sizes(children: list, entry: int) -> list:
    """Lines 5-16 of Algorithm 2: subtree sizes via iterative post-order
    DFS."""
    met = [1] * len(children)
    stack = [(entry, False)]
    while stack:
        u, processed = stack.pop()
        if processed:
            for v in children[u]:
                met[u] += met[v]
        else:
            stack.append((u, True))
            for v in reversed(children[u]):
                stack.append((v, False))
    return met


def mst_reorder(graph: np.ndarray, weights: np.ndarray, entry: int) -> np.ndarray:
    """Algorithm 2. Returns `order`: order[i] = old id stored at new slot i."""
    n = graph.shape[0]
    children, _ = _mst_children(graph, weights, entry)
    met = _subtree_sizes(children, entry)

    # --- lines 17-23: priority traversal by descending subtree size -------
    # Interpretation note (DESIGN.md §10): with one GLOBAL heap, similarly
    # sized subtrees interleave and locality is lost; the paper's stated
    # goal ("frequently co-accessed nodes — those in large subtrees — are
    # stored contiguously") is realized by a largest-subtree-first DFS:
    # after emitting u, u's own children are prioritized before returning
    # to u's siblings. This keeps every subtree contiguous while visiting
    # larger subtrees first.
    order = []
    stack = [entry]
    while stack:
        u = stack.pop()
        order.append(u)
        # push children in ASCENDING met so the largest is popped first
        stack.extend(sorted(children[u], key=met.__getitem__))
    assert len(order) == n
    return np.asarray(order, dtype=np.int64)


def mst_reorder_global_heap(graph: np.ndarray, weights: np.ndarray,
                            entry: int) -> np.ndarray:
    """Literal global-priority-queue reading of Algorithm 2 lines 17-23
    (kept for the ablation comparison)."""
    n = graph.shape[0]
    children, _ = _mst_children(graph, weights, entry)
    met = _subtree_sizes(children, entry)
    order = np.empty(n, dtype=np.int64)
    heap = [(-met[entry], entry)]
    pos = 0
    while heap:
        _, u = heapq.heappop(heap)
        order[pos] = u
        pos += 1
        for v in children[u]:
            heapq.heappush(heap, (-met[v], v))
    assert pos == n
    return order


def cuthill_mckee(graph: np.ndarray, entry: int) -> np.ndarray:
    """Baseline: BFS relabelling, neighbors visited in ascending degree."""
    n, _ = graph.shape
    deg = (graph >= 0).sum(axis=1)
    seen = np.zeros(n, dtype=bool)
    order = np.empty(n, dtype=np.int64)
    pos = 0
    from collections import deque
    dq = deque([entry])
    seen[entry] = True
    while pos < n:
        if not dq:  # next unvisited component, lowest degree first
            rest = np.nonzero(~seen)[0]
            nxt = rest[np.argmin(deg[rest])]
            dq.append(int(nxt))
            seen[nxt] = True
        u = dq.popleft()
        order[pos] = u
        pos += 1
        nbrs = graph[u]
        nbrs = nbrs[nbrs >= 0]
        nbrs = nbrs[np.argsort(deg[nbrs], kind="stable")]
        for v in nbrs:
            if not seen[v]:
                seen[v] = True
                dq.append(int(v))
    return order


def apply_order(order: np.ndarray, db: np.ndarray, graph: np.ndarray
                ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Physically permute (db, graph) by `order`.

    Returns (db', graph', new_of_old) where new_of_old maps old->new ids
    (needed to translate the entry point and any external id references).
    """
    n = order.shape[0]
    new_of_old = np.empty(n, dtype=np.int64)
    new_of_old[order] = np.arange(n)
    db2 = np.asarray(db)[order]
    g = np.asarray(graph)[order]
    g2 = np.where(g >= 0, new_of_old[np.maximum(g, 0)], -1).astype(np.int32)
    return db2, g2, new_of_old


def bandwidth_stats(graph: np.ndarray) -> dict:
    """Locality metrics of a layout: mean/max |pi(u) - pi(v)| over edges."""
    n, _ = graph.shape
    us = np.repeat(np.arange(n), graph.shape[1])
    vs = graph.reshape(-1)
    valid = vs >= 0
    gaps = np.abs(us[valid] - vs[valid])
    return {
        "mean_gap": float(gaps.mean()),
        "p95_gap": float(np.percentile(gaps, 95)),
        "max_gap": int(gaps.max()),
    }
