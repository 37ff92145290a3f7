"""Deterministic synthetic data pipelines with per-host sharding and
background prefetch (numpy only: the port's own copy of the JAX package's
`data/pipeline.py`, stream for stream, so both packages train on equal
arrays; the trainer moves each batch to its device).

Every stream is: (a) deterministic in (seed, host_id, step) — restart-safe
and bitwise reproducible across elastic re-sharding; (b) host-sharded (each
host generates only its slice of the global batch); (c) wrapped by
Prefetcher, a one-deep background-thread pipeline that overlaps host batch
synthesis with device compute (the host-side analogue of H2).
"""
from __future__ import annotations

import queue
import threading
from typing import Callable, Dict, Iterator, Optional

import numpy as np


class Prefetcher:
    """Background-thread prefetch (depth-1 double buffering)."""

    def __init__(self, it: Iterator, depth: int = 2):
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._it = it
        self._done = object()
        self._thread = threading.Thread(target=self._work, daemon=True)
        self._thread.start()

    def _work(self):
        try:
            for x in self._it:
                self._q.put(x)
        finally:
            self._q.put(self._done)

    def __iter__(self):
        return self

    def __next__(self):
        x = self._q.get()
        if x is self._done:
            raise StopIteration
        return x


def _rng(seed: int, host: int, step: int) -> np.random.Generator:
    return np.random.default_rng(
        np.random.SeedSequence([seed, host, step]))


# ----------------------------------------------------------------- LM ------
def lm_batches(vocab: int, batch: int, seq: int, seed: int = 0,
               host_id: int = 0, n_hosts: int = 1,
               structured: bool = True) -> Iterator[Dict]:
    """Token batches (B_local, S+1). `structured` makes tokens learnable
    (Markov-ish repetition) so loss decreases in trainer tests."""
    assert batch % n_hosts == 0
    b_local = batch // n_hosts
    step = 0
    while True:
        r = _rng(seed, host_id, step)
        if structured:
            base = r.integers(0, vocab, size=(b_local, 8), dtype=np.int32)
            reps = int(np.ceil((seq + 1) / 8))
            toks = np.tile(base, (1, reps))[:, :seq + 1]
            noise = r.integers(0, vocab, size=toks.shape, dtype=np.int32)
            mask = r.random(toks.shape) < 0.05
            toks = np.where(mask, noise, toks)
        else:
            toks = r.integers(0, vocab, size=(b_local, seq + 1), dtype=np.int32)
        yield {"tokens": toks}
        step += 1


# -------------------------------------------------------------- recsys -----
def ctr_batches(n_fields: int, vocab: int, batch: int, seed: int = 0,
                host_id: int = 0, n_hosts: int = 1) -> Iterator[Dict]:
    """Criteo-like CTR batches with a planted logistic rule (learnable)."""
    b_local = batch // n_hosts
    step = 0
    w_plant = _rng(seed, 10_000, 0).normal(size=(n_fields,)).astype(np.float32)
    while True:
        r = _rng(seed, host_id, step)
        ids = r.integers(0, vocab, size=(b_local, n_fields), dtype=np.int32)
        score = ((ids % 97) / 97.0 - 0.5) @ w_plant
        label = (score + 0.3 * r.normal(size=b_local) > 0).astype(np.float32)
        yield {"sparse_ids": ids, "label": label}
        step += 1


def seq_batches(kind: str, n_items: int, batch: int, seq: int, seed: int = 0,
                host_id: int = 0, n_hosts: int = 1) -> Iterator[Dict]:
    """Behavior sequences for bst ("hist"+"target"+"label") and bert4rec
    ("seq"+"labels" with 15% masking)."""
    b_local = batch // n_hosts
    step = 0
    while True:
        r = _rng(seed, host_id, step)
        # sessions drift around a latent interest: random walk over items
        start = r.integers(0, n_items, size=(b_local, 1))
        walk = r.integers(-50, 51, size=(b_local, seq)).cumsum(axis=1)
        seqs = ((start + walk) % n_items).astype(np.int32)
        if kind == "bst":
            target = ((seqs[:, -1] + r.integers(-50, 51, size=b_local))
                      % n_items).astype(np.int32)
            label = (r.random(b_local) < 0.5).astype(np.float32)
            yield {"hist": seqs, "target": target, "label": label}
        else:
            labels = np.full((b_local, seq), -1, dtype=np.int32)
            mask = r.random((b_local, seq)) < 0.15
            labels[mask] = seqs[mask]
            masked = seqs.copy()
            masked[mask] = 0        # [MASK] id
            yield {"seq": masked, "labels": labels}
        step += 1


# ----------------------------------------------------------------- graph ---
def synthetic_graph(n_nodes: int, avg_degree: int, seed: int = 0):
    """CSR adjacency of a power-law-ish random graph (host-side numpy)."""
    r = np.random.default_rng(seed)
    deg = np.clip(r.zipf(1.6, size=n_nodes), 1, 20 * avg_degree)
    deg = (deg * (avg_degree / deg.mean())).astype(np.int64) + 1
    dst = r.integers(0, n_nodes, size=int(deg.sum()), dtype=np.int64)
    indptr = np.concatenate([[0], np.cumsum(deg)])
    return indptr, dst


def sample_neighbors(indptr, indices, seeds: np.ndarray, fanout: int,
                     rng: np.random.Generator) -> np.ndarray:
    """Uniform neighbor sampling with replacement: (len(seeds), fanout)."""
    starts = indptr[seeds]
    degs = indptr[seeds + 1] - starts
    offs = (rng.random((len(seeds), fanout)) * np.maximum(degs, 1)[:, None]
            ).astype(np.int64)
    nbrs = indices[starts[:, None] + offs]
    nbrs[degs == 0] = seeds[degs == 0, None]   # isolated: self loop
    return nbrs


def gnn_minibatches(n_nodes: int, d_feat: int, batch_nodes: int,
                    fanouts=(15, 10), n_classes: int = 16, seed: int = 0,
                    host_id: int = 0, n_hosts: int = 1,
                    triplet_cap: int = 8) -> Iterator[Dict]:
    """2-hop sampled subgraph batches for DimeNet (the `minibatch_lg` shape).

    Real neighbor sampler over a synthetic CSR graph; outputs fixed-shape
    padded arrays: remapped local node ids, edge lists, capped triplets, and
    stub positions (modality frontend per DESIGN.md).
    """
    indptr, indices = synthetic_graph(n_nodes, avg_degree=25, seed=seed)
    b_local = batch_nodes // n_hosts
    # static sizes
    n1 = b_local * fanouts[0]
    n2 = n1 * fanouts[1]
    max_nodes = b_local + n1 + n2
    max_edges = n1 + n2
    max_trip = max_edges * triplet_cap
    step = 0
    while True:
        r = _rng(seed, host_id, step)
        seeds = r.integers(0, n_nodes, size=b_local, dtype=np.int64)
        h1 = sample_neighbors(indptr, indices, seeds, fanouts[0], r).reshape(-1)
        h2 = sample_neighbors(indptr, indices, h1, fanouts[1], r).reshape(-1)
        nodes, inv = np.unique(np.concatenate([seeds, h1, h2]),
                               return_inverse=True)
        n_loc = len(nodes)
        # edges: hop-1 (h1 -> seeds), hop-2 (h2 -> h1), in local ids
        src = np.concatenate([inv[b_local:b_local + n1],
                              inv[b_local + n1:]])
        dst = np.concatenate([np.repeat(inv[:b_local], fanouts[0]),
                              np.repeat(inv[b_local:b_local + n1], fanouts[1])])
        e = len(src)
        # triplets: for edge (j -> i), pair with up to cap edges (k -> j)
        order = np.argsort(dst, kind="stable")
        by_dst_start = np.searchsorted(dst[order], np.arange(n_loc))
        by_dst_end = np.searchsorted(dst[order], np.arange(n_loc) + 1)
        tkj, tji = [], []
        cnt = by_dst_end - by_dst_start
        for ei in range(e):
            j = src[ei]
            c = min(int(cnt[j]), triplet_cap)
            if c:
                ks = order[by_dst_start[j]:by_dst_start[j] + c]
                tkj.append(ks)
                tji.append(np.full(c, ei, dtype=np.int64))
        tkj = np.concatenate(tkj) if tkj else np.zeros(0, np.int64)
        tji = np.concatenate(tji) if tji else np.zeros(0, np.int64)

        def pad(a, size, fill=-1):
            out = np.full(size, fill, dtype=np.int32)
            out[:min(len(a), size)] = a[:size]
            return out

        feats = r.normal(size=(max_nodes, d_feat)).astype(np.float32)
        feats[n_loc:] = 0
        pos = r.normal(size=(max_nodes, 3)).astype(np.float32)
        labels = np.full(max_nodes, -1, np.int32)
        labels[:b_local] = (nodes[inv[:b_local]] % n_classes)
        yield {
            "feats": feats, "pos": pos,
            "edge_src": pad(src, max_edges), "edge_dst": pad(dst, max_edges),
            "trip_kj": pad(tkj, max_trip), "trip_ji": pad(tji, max_trip),
            "labels": labels,
        }
        step += 1


def molecule_batches(n_atoms: int, n_edges: int, batch: int, d_feat: int,
                     seed: int = 0, triplet_cap: int = 8) -> Iterator[Dict]:
    """Batched small molecules flattened into one padded graph (the
    `molecule` shape): radius-graph edges from random 3-D conformers."""
    step = 0
    N = n_atoms * batch
    E = n_edges * batch
    T = E * triplet_cap
    while True:
        r = _rng(seed, 0, step)
        pos = r.normal(size=(batch, n_atoms, 3)).astype(np.float32) * 1.5
        feats = r.normal(size=(N, d_feat)).astype(np.float32)
        src_l, dst_l, tkj_l, tji_l = [], [], [], []
        e_base = 0
        for g in range(batch):
            d = np.linalg.norm(pos[g][:, None] - pos[g][None], axis=-1)
            np.fill_diagonal(d, np.inf)
            # k-nearest edges per atom to hit ~n_edges per molecule
            k = max(1, n_edges // n_atoms)
            nb = np.argsort(d, axis=1)[:, :k]
            s = nb.reshape(-1) + g * n_atoms
            t = np.repeat(np.arange(n_atoms), k) + g * n_atoms
            src_l.append(s)
            dst_l.append(t)
            e_base += len(s)
        src = np.concatenate(src_l)[:E]
        dst = np.concatenate(dst_l)[:E]
        # triplets within the flat edge list
        order = np.argsort(dst, kind="stable")
        starts = np.searchsorted(dst[order], np.arange(N))
        ends = np.searchsorted(dst[order], np.arange(N) + 1)
        tkj, tji = [], []
        for ei in range(len(src)):
            j = src[ei]
            c = min(int(ends[j] - starts[j]), triplet_cap)
            if c:
                tkj.append(order[starts[j]:starts[j] + c])
                tji.append(np.full(c, ei, dtype=np.int64))
        tkj = np.concatenate(tkj) if tkj else np.zeros(0, np.int64)
        tji = np.concatenate(tji) if tji else np.zeros(0, np.int64)

        def pad(a, size):
            out = np.full(size, -1, dtype=np.int32)
            out[:min(len(a), size)] = a[:size]
            return out

        yield {
            "feats": feats,
            "pos": pos.reshape(N, 3),
            "edge_src": pad(src, E), "edge_dst": pad(dst, E),
            "trip_kj": pad(tkj, T), "trip_ji": pad(tji, T),
            "node_graph": np.repeat(np.arange(batch, dtype=np.int32), n_atoms),
            "targets": r.normal(size=batch).astype(np.float32),
        }
        step += 1
