"""Batch-serving engine for KBest indexes (DESIGN.md §11, §17), the
counterpart of the JAX package's `repro.serve`.

    from repro_torch.serve import SearchEngine, Request, serve_loop

`SearchEngine(index)` turns a built `KBest` (or `ShardedKBest`) into a
serving endpoint: incoming batches are padded to a small ladder of
power-of-two shape buckets and dispatched through a callable cache keyed
on (bucket, SearchConfig, index_type, quant kind, n_shards).
`serve_loop` drains a queue of heterogeneous `Request`s — mixed batch
sizes, mixed k, graph and IVF engines side by side — with true
served-count accounting, and owns the overload story: deadline admission
control (`Request.deadline_ms` + `LatencyModel`), bounded-queue shedding,
graceful degradation down a pre-tuned SearchConfig ladder
(`DegradePolicy`), and a per-request error boundary. `serve.faults` is the
matching fault-injection harness.
"""
from repro_torch.serve.degrade import DegradePolicy, LatencyModel
from repro_torch.serve.engine import (EngineStats, SearchEngine,
                                      bucket_for, bucket_ladder, percentiles)
from repro_torch.serve.faults import EngineFault, FaultInjector, InjectedCrash
from repro_torch.serve.scheduler import (Request, RequestResult, ServeReport,
                                         STATUS_FAILED, STATUS_OK,
                                         STATUS_REJECTED, STATUS_SHED,
                                         serve_loop)

__all__ = [
    "SearchEngine", "EngineStats", "bucket_for", "bucket_ladder",
    "percentiles",
    "Request", "RequestResult", "ServeReport", "serve_loop",
    "STATUS_OK", "STATUS_REJECTED", "STATUS_SHED", "STATUS_FAILED",
    "DegradePolicy", "LatencyModel",
    "FaultInjector", "EngineFault", "InjectedCrash",
]
