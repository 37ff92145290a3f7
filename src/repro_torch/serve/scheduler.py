"""Request scheduler: coalesce + dispatch heterogeneous request traffic,
overload-safe (DESIGN.md §11, §17). The counterpart of the JAX package's
`repro/serve/scheduler.py`, decision for decision: the same requests,
fault plan and clock give the same statuses and degrade levels.

`serve_loop` drains a FIFO of `Request`s that may differ in batch size, k,
SearchConfig, and even target index family (graph and IVF engines side by
side). Consecutive requests that share a (engine, resolved SearchConfig)
key are coalesced into one padded bucket batch — small requests ride the
same engine callable and the same lockstep dispatch, which is exactly the
batching economics of the paper's serving scenario — and the results are
sliced back per request.

Accounting is per TRUE query: a request of 22 queries coalesced into a
64-bucket contributes 22 to the served count and its recall denominator,
never the padded size (the historical serve_ann bug: counting
`ceil`-batches * batch_size over a partial final batch overstates served
queries and understates recall).

Overload behavior (all off by default — a plain drain is unchanged):

  admission   — requests carrying `deadline_ms` are REJECTED up front when
                `t_start + slack * ŝ > t_arrival + deadline`, with ŝ the
                calibrated per-(engine, config, bucket) latency model
                (serve.degrade.LatencyModel). Rejecting costs ~nothing and
                beats serving an answer nobody is waiting for.
  bounded queue — `max_queue > 0` sheds arrivals that find that many
                admitted requests still pending (status "shed").
  degradation — a `DegradePolicy` observes the pre-dispatch queue delay
                and swaps in cheaper SearchConfig rungs under sustained
                overload (status stays "ok"; `degrade_level` records the
                rung served).
  error boundary — a dispatch that raises fails ONLY the offending
                request(s): coalesced groups are retried singly so one
                poisoned request cannot take down its batch, let alone the
                loop (status "failed", exception in `error`).

Time is a virtual clock in ms: request `arrival_ms` (monotone
non-decreasing, as produced by an open-loop arrival process) meets the
measured per-dispatch service time (the module's `time.perf_counter`),
a single-server queue. All decisions use RELATIVE times only, so a
constant clock skew on arrivals (faults.FaultInjector.skew_ms) cannot
change any outcome.
"""
from __future__ import annotations

import dataclasses
import time
from collections import deque
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from repro_torch.core.types import SearchConfig
from repro_torch.serve.degrade import DegradePolicy, LatencyModel
from repro_torch.serve.engine import EngineStats, SearchEngine, percentiles
from repro_torch.serve.faults import FaultInjector

# RequestResult.status codes
STATUS_OK = "ok"
STATUS_REJECTED = "rejected"   # deadline infeasible at admission
STATUS_SHED = "shed"           # bounded queue full at arrival
STATUS_FAILED = "failed"       # dispatch raised; see .error


@dataclasses.dataclass
class Request:
    """One serving request: a query batch plus per-request knobs."""

    queries: np.ndarray                      # (Q, d) float32
    k: Optional[int] = None                  # None => engine's config k
    search_cfg: Optional[SearchConfig] = None
    engine: str = "default"                  # routing key into the engine map
    gt_ids: Optional[np.ndarray] = None      # (Q, >=k) optional ground truth
    request_id: int = -1                     # filled by serve_loop if -1
    arrival_ms: float = 0.0                  # open-loop arrival (virtual clock)
    deadline_ms: float = 0.0                 # relative deadline; 0 => none

    @property
    def n_queries(self) -> int:
        return int(np.asarray(self.queries).shape[0])


@dataclasses.dataclass
class RequestResult:
    request_id: int
    engine: str
    dists: np.ndarray          # (Q, k); +inf rows when not served
    ids: np.ndarray            # (Q, k); -1 rows when not served
    n_served: int              # TRUE query count; 0 unless status == "ok"
    latency_ms: float          # wall time of the (possibly shared) dispatch
    recall: Optional[float]    # only when the request carried gt_ids
    status: str = STATUS_OK
    error: Optional[str] = None        # repr of the exception when "failed"
    queue_delay_ms: float = 0.0        # dispatch start - arrival
    sojourn_ms: float = 0.0            # finish - arrival (queue + service)
    deadline_missed: bool = False      # served, but past its deadline
    degrade_level: int = 0             # ladder rung this dispatch served at


@dataclasses.dataclass
class ServeReport:
    """Aggregate of one serve_loop drain."""

    results: List[RequestResult]
    n_requests: int
    n_served: int                          # sum of TRUE per-request counts
    n_dispatches: int                      # engine calls (post-coalescing)
    recall_at_k: Optional[float]           # served-count-weighted
    lat_p50_ms: float                      # service-time percentiles (served)
    lat_p95_ms: float
    lat_p99_ms: float
    engine_stats: Dict[str, EngineStats]
    n_rejected: int = 0
    n_shed: int = 0
    n_failed: int = 0
    n_deadline_missed: int = 0
    sojourn_p50_ms: float = 0.0            # queue + service (served requests)
    sojourn_p95_ms: float = 0.0
    sojourn_p99_ms: float = 0.0
    t_end_ms: float = 0.0                  # virtual makespan of the drain

    def summary(self) -> str:
        rec = "-" if self.recall_at_k is None else f"{self.recall_at_k:.3f}"
        out = (f"served {self.n_served} queries in {self.n_requests} "
               f"requests ({self.n_dispatches} dispatches) | "
               f"recall={rec} | lat p50={self.lat_p50_ms:.2f} "
               f"p95={self.lat_p95_ms:.2f} p99={self.lat_p99_ms:.2f} ms")
        if self.n_rejected or self.n_shed or self.n_failed:
            out += (f" | rej={self.n_rejected} shed={self.n_shed} "
                    f"fail={self.n_failed}")
        return out


def _coalesce_key(engines: Dict[str, SearchEngine], r: Request) -> tuple:
    eng = engines[r.engine]
    return (r.engine, eng.index._resolve_cfg(r.k, r.search_cfg))


def _not_served(r: Request, k: int, status: str, *,
                error: Optional[str] = None,
                queue_delay_ms: float = 0.0) -> RequestResult:
    q = r.n_queries
    return RequestResult(
        request_id=r.request_id, engine=r.engine,
        dists=np.full((q, k), np.inf, np.float32),
        ids=np.full((q, k), -1, np.int32),
        n_served=0, latency_ms=0.0, recall=None, status=status,
        error=error, queue_delay_ms=queue_delay_ms)


def _dispatch(eng: SearchEngine, group: List[Request], scfg: SearchConfig,
              faults: Optional[FaultInjector]):
    """One engine call for a coalesced group; returns (dists, ids, dt_ms).
    Raises whatever the fault injector or the engine raises — the caller's
    error boundary owns attribution."""
    batch = np.concatenate([np.asarray(r.queries, np.float32)
                            for r in group], axis=0)
    # forward ground truth into the engine telemetry when the whole group
    # carries it (same column count), so per-engine EngineStats.recall_at_k
    # is populated, not just the report's
    gts = [r.gt_ids for r in group]
    gt = None
    if all(g is not None for g in gts):
        cols = {np.asarray(g).shape[1] for g in gts}
        if len(cols) == 1:
            gt = np.concatenate([np.asarray(g) for g in gts], axis=0)
    if faults is not None:
        faults.check(group)
    t0 = time.perf_counter()
    dists, ids = eng.search(batch, search_cfg=scfg, gt_ids=gt)
    dt_ms = (time.perf_counter() - t0) * 1e3
    if faults is not None:
        dt_ms += faults.extra_ms(group)
    return dists, ids, dt_ms


def serve_loop(engines: Union[SearchEngine, Dict[str, SearchEngine]],
               requests: Sequence[Request], *,
               coalesce: bool = True,
               max_queue: int = 0,
               admission: Optional[bool] = None,
               latency_model: Optional[LatencyModel] = None,
               degrade: Optional[DegradePolicy] = None,
               faults: Optional[FaultInjector] = None) -> ServeReport:
    """Drain `requests` (FIFO) through the engine map and return the report.

    With coalesce=True, maximal runs of CONSECUTIVE requests sharing a
    coalesce key are packed into one dispatch, capped at the engine's
    max_bucket rows (FIFO order is preserved — the scheduler never reorders
    across requests, so tail latency stays honest under mixed traffic); a
    request can only join a dispatch that starts at or after its arrival.

    admission=None auto-enables deadline admission iff any request carries
    one; pass False to measure the no-policy baseline under deadline
    traffic. max_queue/degrade/faults: see the module docstring.
    """
    if isinstance(engines, SearchEngine):
        engines = {engines.name: engines}
    skew = faults.skew_ms if faults is not None else 0.0

    def arr(r: Request) -> float:
        return r.arrival_ms + skew

    admission_on = (any(r.deadline_ms > 0 for r in requests)
                    if admission is None else bool(admission))
    model = latency_model
    if model is None and admission_on:
        model = LatencyModel()

    q = deque(requests)
    results: List[RequestResult] = []
    finishes: List[float] = []        # virtual finish times of served reqs
    next_id = 0
    n_dispatches = 0
    t_free = 0.0

    def assign_id(r: Request) -> Request:
        nonlocal next_id
        if r.request_id < 0:
            r.request_id = next_id
        next_id = max(next_id, r.request_id) + 1
        return r

    def record_served(group, dists, ids, dt_ms, start, scfg, eng, level):
        """Slice a successful dispatch back per request; returns finish."""
        finish = start + dt_ms
        s = 0
        for r in group:
            e = s + r.n_queries
            rec = None
            if r.gt_ids is not None:
                from repro_torch.data.vectors import recall_at_k
                rec = recall_at_k(ids[s:e], np.asarray(r.gt_ids), scfg.k)
            sojourn = finish - arr(r)
            missed = r.deadline_ms > 0 and sojourn > r.deadline_ms
            if r.deadline_ms > 0:
                eng.note_deadline(missed)
            results.append(RequestResult(
                request_id=r.request_id, engine=r.engine,
                dists=dists[s:e], ids=ids[s:e], n_served=r.n_queries,
                latency_ms=dt_ms, recall=rec, status=STATUS_OK,
                queue_delay_ms=start - arr(r), sojourn_ms=sojourn,
                deadline_missed=missed, degrade_level=level))
            finishes.append(finish)
            s = e
        if degrade is not None:
            eng.note_degrade(level)
        if model is not None:
            model.observe(eng, scfg, sum(r.n_queries for r in group), dt_ms)
        return finish

    while q:
        r0 = assign_id(q.popleft())
        eng = engines[r0.engine]
        key = _coalesce_key(engines, r0)
        base_cfg: SearchConfig = key[1]
        a0 = arr(r0)
        start = max(t_free, a0)

        # ---- bounded queue: shed an arrival that finds it full
        if max_queue > 0 and \
                sum(1 for f in finishes if f > a0) >= max_queue:
            results.append(_not_served(r0, base_cfg.k, STATUS_SHED))
            eng.note_shed()
            continue

        # ---- degradation: observe load, pick the rung this dispatch serves
        level = 0
        scfg = base_cfg
        if degrade is not None:
            level = degrade.observe(start - a0)
            scfg = degrade.apply(base_cfg)

        # ---- admission: reject a deadline the predicted finish busts
        if admission_on and r0.deadline_ms > 0:
            pred = model.slack * model.predict_ms(eng, scfg, r0.n_queries)
            if start + pred > a0 + r0.deadline_ms:
                results.append(_not_served(
                    r0, base_cfg.k, STATUS_REJECTED,
                    queue_delay_ms=start - a0))
                eng.note_rejected()
                continue

        group = [r0]
        rows = r0.n_queries
        while (coalesce and q and rows < eng.max_bucket
               and _coalesce_key(engines, q[0]) == key
               and rows + q[0].n_queries <= eng.max_bucket
               and arr(q[0]) <= start):
            r = assign_id(q.popleft())
            if admission_on and r.deadline_ms > 0:
                pred = model.slack * model.predict_ms(eng, scfg, r.n_queries)
                if start + pred > arr(r) + r.deadline_ms:
                    results.append(_not_served(
                        r, base_cfg.k, STATUS_REJECTED,
                        queue_delay_ms=start - arr(r)))
                    eng.note_rejected()
                    continue
            rows += r.n_queries
            group.append(r)

        try:
            dists, ids, dt_ms = _dispatch(eng, group, scfg, faults)
        except Exception as exc:                      # ---- error boundary
            if len(group) == 1:
                results.append(_not_served(
                    r0, base_cfg.k, STATUS_FAILED, error=repr(exc),
                    queue_delay_ms=start - a0))
                eng.note_failed()
                continue          # a failed dispatch charges no service time
            # un-coalesce: re-dispatch singly so only the poisoned
            # request(s) fail — the group must not share their fate
            t = start
            for r in group:
                try:
                    d1, i1, one_ms = _dispatch(eng, [r], scfg, faults)
                except Exception as exc1:
                    results.append(_not_served(
                        r, base_cfg.k, STATUS_FAILED, error=repr(exc1),
                        queue_delay_ms=t - arr(r)))
                    eng.note_failed()
                    continue
                n_dispatches += 1
                t = record_served([r], d1, i1, one_ms, t, scfg, eng, level)
            t_free = max(t_free, t)
            continue

        n_dispatches += 1
        t_free = record_served(group, dists, ids, dt_ms, start, scfg, eng,
                               level)

    served = [r for r in results if r.status == STATUS_OK]
    n_served = sum(r.n_served for r in served)
    with_gt = [(r.recall, r.n_served) for r in served if r.recall is not None]
    recall = (sum(rc * ns for rc, ns in with_gt)
              / max(sum(ns for _, ns in with_gt), 1)) if with_gt else None
    lat_p50, lat_p95, lat_p99 = percentiles([r.latency_ms for r in served])
    soj_p50, soj_p95, soj_p99 = percentiles([r.sojourn_ms for r in served])
    return ServeReport(
        results=results,
        n_requests=len(results),
        n_served=n_served,
        n_dispatches=n_dispatches,
        recall_at_k=recall,
        lat_p50_ms=lat_p50,
        lat_p95_ms=lat_p95,
        lat_p99_ms=lat_p99,
        engine_stats={name: e.stats() for name, e in engines.items()},
        n_rejected=sum(r.status == STATUS_REJECTED for r in results),
        n_shed=sum(r.status == STATUS_SHED for r in results),
        n_failed=sum(r.status == STATUS_FAILED for r in results),
        n_deadline_missed=sum(r.deadline_missed for r in results),
        sojourn_p50_ms=soj_p50,
        sojourn_p95_ms=soj_p95,
        sojourn_p99_ms=soj_p99,
        t_end_ms=max(finishes) if finishes else 0.0,
    )
