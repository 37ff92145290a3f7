"""SearchEngine — the shape-bucketed serving facade (DESIGN.md §11), the
counterpart of the JAX package's `repro/serve/engine.py`.

  1. **Shape buckets.** Incoming batches are padded up to the next
     power-of-two bucket (clamped to [min_bucket, max_bucket]); batches
     larger than max_bucket are split. A handful of buckets covers any
     traffic mix.
  2. **Padded lanes.** Padding rides `KBest.search_padded`: a graph
     index's padded rows enter the lockstep traversal inactive and cost
     no distance computations; an IVF index's padded lanes are scanned and
     then masked. Valid rows equal an unpadded `index.search` bit for bit.
  3. **Callable cache.** One callable per key (bucket, SearchConfig,
     index_type, quant_kind, n_shards) — the reference's cache key; the
     last component is the shard count of a `ShardedKBest`, which serves
     through the same facade. Where the reference compiles one XLA
     program per key, the port runs the eager search, and a "trace" is
     the first call for a key that completes (a call that raises is not
     cached, as a failed jax trace is not). So `n_traces` and `warmup`
     count the same keys as the reference's on the same call sequences.
  4. **Telemetry.** Each call records its wall latency — on a CUDA index
     the clock stops after `torch.cuda.synchronize`, so the device's work
     is inside it — the per-query distance counts and early-termination
     fires; `stats()` folds them into an `EngineStats` snapshot.

Results come back to the caller as numpy arrays, as the reference's do.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

from repro_torch.core.refine import _sync
from repro_torch.core.types import SearchConfig


def bucket_for(q: int, min_bucket: int = 8, max_bucket: int = 256) -> int:
    """Smallest power-of-two >= q, clamped to [min_bucket, max_bucket]."""
    assert q >= 1, q
    b = 1 << (q - 1).bit_length()
    return max(min_bucket, min(b, max_bucket))


def bucket_ladder(min_bucket: int = 8, max_bucket: int = 256
                  ) -> Tuple[int, ...]:
    """All buckets the engine can emit, ascending."""
    out = []
    b = max(1, min_bucket)
    while b < max_bucket:
        out.append(b)
        b <<= 1
    out.append(max_bucket)
    return tuple(out)


def percentiles(values) -> Tuple[float, float, float]:
    """(p50, p95, p99), (0, 0, 0) for an empty history (telemetry is read
    before traffic arrives and after drains that served nothing)."""
    arr = np.asarray(list(values), np.float64)
    if arr.size == 0:
        return 0.0, 0.0, 0.0
    return (float(np.percentile(arr, 50)), float(np.percentile(arr, 95)),
            float(np.percentile(arr, 99)))


@dataclasses.dataclass(frozen=True)
class EngineStats:
    """Telemetry snapshot over every call since construction/reset."""

    n_requests: int            # engine calls served (post-coalescing)
    n_queries: int             # TRUE query count (padding excluded)
    n_traces: int              # first calls of a cache key
    cache_hits: int
    cache_misses: int
    lat_p50_ms: float          # per-call wall latency percentiles
    lat_p95_ms: float
    lat_p99_ms: float
    mean_lat_ms: float
    dists_per_query: float     # mean over valid lanes (cross-family units)
    et_fire_rate: float        # fraction of valid lanes that early-terminated
    recall_at_k: Optional[float]   # only when gt_ids were supplied
    # ---- overload telemetry (DESIGN.md §17; fed by serve_loop) ----
    n_rejected: int = 0        # deadline-infeasible at admission
    n_shed: int = 0            # dropped at a full bounded queue
    n_failed: int = 0          # dispatch raised; failed its own result
    deadline_miss_rate: float = 0.0   # served-late / deadline-carrying
    degrade_occupancy: Tuple[Tuple[int, int], ...] = ()  # (level, dispatches)

    def summary(self) -> str:
        rec = ("-" if self.recall_at_k is None
               else f"{self.recall_at_k:.3f}")
        return (f"requests={self.n_requests} queries={self.n_queries} "
                f"traces={self.n_traces} "
                f"cache={self.cache_hits}h/{self.cache_misses}m | "
                f"lat p50={self.lat_p50_ms:.2f} p95={self.lat_p95_ms:.2f} "
                f"p99={self.lat_p99_ms:.2f} ms | "
                f"dists/q={self.dists_per_query:.0f} "
                f"et_rate={self.et_fire_rate:.2f} recall={rec} | "
                f"rej={self.n_rejected} shed={self.n_shed} "
                f"fail={self.n_failed} "
                f"miss={self.deadline_miss_rate:.2f}")


class SearchEngine:
    """Serving facade over one built index — KBest (graph or IVF) or a
    ShardedKBest (anything exposing config / device / db / _resolve_cfg /
    search_padded)."""

    def __init__(self, index, *, min_bucket: int = 8,
                 max_bucket: int = 256, name: str = "default"):
        assert index.db is not None, "serve a BUILT index (call add() first)"
        assert min_bucket >= 1 and max_bucket >= min_bucket
        # non-power-of-two bounds would make bucket_ladder (warmup) and
        # bucket_for (dispatch) disagree, so warmed traffic could re-trace
        assert min_bucket & (min_bucket - 1) == 0, min_bucket
        assert max_bucket & (max_bucket - 1) == 0, max_bucket
        self.index = index
        self.name = name
        self.min_bucket = min_bucket
        self.max_bucket = max_bucket
        self._cache: Dict[tuple, callable] = {}
        self.n_traces = 0
        self.cache_hits = 0
        self.cache_misses = 0
        self.reset_stats()

    # ------------------------------------------------------------ callables
    def _cache_key(self, bucket: int, scfg: SearchConfig) -> tuple:
        # scfg is the whole frozen SearchConfig, so every traversal-shape
        # knob (beam_width, batch_B, ...) keys a distinct entry; n_shards
        # is the shard count of a ShardedKBest
        cfg = self.index.config
        return (bucket, scfg, cfg.index_type, cfg.quant.kind, cfg.n_shards)

    def _compiled(self, bucket: int, scfg: SearchConfig):
        key = self._cache_key(bucket, scfg)
        fn = self._cache.get(key)
        if fn is None:
            self.cache_misses += 1
            index = self.index
            traced = [False]

            def run(q, mask):
                # the first call of a key that completes is its "trace"
                if not traced[0]:
                    self.n_traces += 1
                out = index.search_padded(q, mask, search_cfg=scfg,
                                          with_stats=True)
                traced[0] = True
                return out

            fn = self._cache[key] = run
        else:
            self.cache_hits += 1
        return fn

    def warmup(self, batch_sizes: Optional[Sequence[int]] = None,
               k: Optional[int] = None,
               search_cfg: Optional[SearchConfig] = None) -> int:
        """Run the buckets covering `batch_sizes` (default: the whole
        ladder) once for one SearchConfig. Returns the number of fresh
        traces."""
        scfg = self.index._resolve_cfg(k, search_cfg)
        if batch_sizes is None:
            buckets = bucket_ladder(self.min_bucket, self.max_bucket)
        else:
            buckets = sorted({bucket_for(b, self.min_bucket, self.max_bucket)
                              for b in batch_sizes})
        before = self.n_traces
        d = self.index.db.shape[1]
        for b in buckets:
            q = np.zeros((b, d), np.float32)
            mask = np.zeros((b,), bool)
            mask[0] = True     # one live lane: exercise the real loop body
            self._compiled(b, scfg)(q, mask)
            _sync(self.index.device)
        return self.n_traces - before

    # --------------------------------------------------------------- search
    def search(self, queries, k: Optional[int] = None,
               search_cfg: Optional[SearchConfig] = None,
               gt_ids: Optional[np.ndarray] = None
               ) -> Tuple[np.ndarray, np.ndarray]:
        """Serve one request batch. queries: (Q, d), any Q >= 1.

        Pads to the shape bucket, dispatches through the callable cache and
        returns exactly (Q, k) numpy results. Batches beyond max_bucket are
        split into max_bucket chunks. With gt_ids (Q, >=k), recall@k is
        folded into the telemetry with the TRUE served count as the
        denominator.
        """
        queries = np.asarray(queries, np.float32)
        assert queries.ndim == 2, queries.shape
        Q = queries.shape[0]
        scfg = self.index._resolve_cfg(k, search_cfg)
        if Q > self.max_bucket:
            parts = [self.search(queries[s:s + self.max_bucket],
                                 search_cfg=scfg,
                                 gt_ids=None if gt_ids is None
                                 else gt_ids[s:s + self.max_bucket])
                     for s in range(0, Q, self.max_bucket)]
            return (np.concatenate([p[0] for p in parts]),
                    np.concatenate([p[1] for p in parts]))

        bucket = bucket_for(Q, self.min_bucket, self.max_bucket)
        qp = np.zeros((bucket, queries.shape[1]), np.float32)
        qp[:Q] = queries
        mask = np.zeros((bucket,), bool)
        mask[:Q] = True

        fn = self._compiled(bucket, scfg)
        t0 = time.perf_counter()
        dists, ids, stats = fn(qp, mask)
        _sync(self.index.device)
        dt_ms = (time.perf_counter() - t0) * 1e3

        self._lat_ms.append(dt_ms)
        self._n_queries += Q
        self._sum_dists += int(stats.n_dist.sum())
        self._sum_et += int(stats.early_terminated.sum())

        dists = dists[:Q].cpu().numpy()
        ids = ids[:Q].cpu().numpy()
        if gt_ids is not None:
            from repro_torch.data.vectors import recall_at_k
            self._gt_hits += recall_at_k(ids, np.asarray(gt_ids)[:Q],
                                         scfg.k) * Q
            self._gt_queries += Q
        return dists, ids

    # ----------------------------------------------------------- telemetry
    def note_rejected(self, n: int = 1) -> None:
        self._n_rejected += n

    def note_shed(self, n: int = 1) -> None:
        self._n_shed += n

    def note_failed(self, n: int = 1) -> None:
        self._n_failed += n

    def note_deadline(self, missed: bool) -> None:
        """One served deadline-carrying request: hit or miss."""
        self._n_deadline += 1
        self._n_deadline_missed += int(missed)

    def note_degrade(self, level: int) -> None:
        """One dispatch served at this degrade-ladder level."""
        self._degrade_occ[level] = self._degrade_occ.get(level, 0) + 1

    def stats(self) -> EngineStats:
        p50, p95, p99 = percentiles(self._lat_ms)
        lat = np.asarray(self._lat_ms, np.float64)
        nq = max(self._n_queries, 1)
        return EngineStats(
            n_requests=lat.size,
            n_queries=self._n_queries,
            n_traces=self.n_traces,
            cache_hits=self.cache_hits,
            cache_misses=self.cache_misses,
            lat_p50_ms=p50,
            lat_p95_ms=p95,
            lat_p99_ms=p99,
            mean_lat_ms=float(lat.mean()) if lat.size else 0.0,
            dists_per_query=self._sum_dists / nq,
            et_fire_rate=self._sum_et / nq,
            recall_at_k=(self._gt_hits / self._gt_queries
                         if self._gt_queries else None),
            n_rejected=self._n_rejected,
            n_shed=self._n_shed,
            n_failed=self._n_failed,
            deadline_miss_rate=(self._n_deadline_missed / self._n_deadline
                                if self._n_deadline else 0.0),
            degrade_occupancy=tuple(sorted(self._degrade_occ.items())),
        )

    def reset_stats(self) -> None:
        """Clear telemetry; the callable cache (and n_traces) is kept —
        traces are a property of the cache, not of a measurement window."""
        self._lat_ms: list = []
        self._n_queries = 0
        self._sum_dists = 0
        self._sum_et = 0
        self._gt_hits = 0.0
        self._gt_queries = 0
        self._n_rejected = 0
        self._n_shed = 0
        self._n_failed = 0
        self._n_deadline = 0
        self._n_deadline_missed = 0
        self._degrade_occ: Dict[int, int] = {}
