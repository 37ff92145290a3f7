"""One run of one cell: set-up, the measured window, the check, the
metrics, and the result line.

    set-up   the corpus and query pool from --seed (pb.data), the index
             built by the program (`KBest.add`), warm-up calls of each
             request size the mix sends;
    window   the mix's requests (pb.traffic) for --seconds: in a closed
             loop each request's answers reach the host before the next
             goes out, in an open loop each goes out at its arrival time
             or, when the caller is late, as soon as the last is
             answered; with --trace 1 under the profiler (pb.tracing);
             then the metric readers that count a kernel's needs replay
             the window's requests (pb.roofline);
    check    once the window has closed and the peak memory is read, the
             program's state is freed and the plain reference judges
             every answer served (pb.check).

`run` returns the result; `main` in run.py prints it.
"""
from __future__ import annotations

import gc
import sys
import time
from typing import Callable

from pb import check, data, spec
from pb.traffic import Traffic
from pb.tracing import Tracer

# modules the measured process may not hold once the window has closed,
# compared by whole top-level name: the JAX package and JAX itself
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
WARM_CALLS = 2


class Run:
    """What a metric reader sees of one run."""

    def __init__(self, cell: spec.Cell, trace: bool, device: str, t0: float):
        self.cell, self.trace, self.device, self.t0 = cell, trace, device, t0
        self.system = None           # pb.system.KBestSystem, until judged
        self.setup_s = 0.0
        self.window_s = 0.0
        self.calls = []              # (request, dists, ids) as served
        self.latencies = []          # seconds from arrival to answers
        self.done_at = []            # seconds into the window, answers in
        self.queries = 0             # queries served in the window
        self.stats = []              # the program's SearchStats, traced runs
        self.build_times = {}
        self.summary = None          # pb.tracing.TraceSummary, traced runs
        self.traffic = None          # pb.traffic.Traffic
        self.counters = {}           # what the readers' replays count
        self.verdict = None          # pb.check.judge's result
        self.marks = {}              # set-up phase -> perf_counter at start


def forbidden_modules(modules=None) -> list:
    """The FORBIDDEN top-level names among `modules` (loaded ones by
    default)."""
    names = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def prepare(cell: spec.Cell, seed: int):
    """(corpus, query pool, metric, traffic) of a cell under `seed`."""
    base, pool, metric = data.make(cell.config["data"],
                                   cell.traffic["query_pool"], seed,
                                   cell.base)
    traffic = Traffic(cell.traffic, pool, seed)
    return base, traffic.pool, metric, traffic


def measure(r: Run, call: Callable, traffic: Traffic, seconds: float,
            min_calls: int = 1) -> None:
    """Warm-up, then the window: the mix's requests for `seconds` (and at
    least `min_calls`), under the profiler when `r.trace`. A closed loop
    stops once a request ends past `seconds`; an open loop sends every
    request that arrives before it and waits for its answers."""
    import torch
    k = traffic.k
    r.traffic = traffic
    r.marks["warm-up"] = time.perf_counter()
    for b in traffic.warm_batches():
        for _ in range(WARM_CALLS):
            call(traffic.batch(b), k)
    on_card = torch.device(r.device).type == "cuda"
    tracer = Tracer(r.trace, on_card)
    if on_card:
        torch.cuda.synchronize()
    if r.trace:
        r.marks["profiler"] = time.perf_counter()
    with tracer:
        start = time.perf_counter()
        r.setup_s = start - r.t0
        r.marks["window"] = start
        for b, q, due in traffic.requests():
            if due is not None:
                if due >= seconds and len(r.calls) >= min_calls:
                    break
                wait = start + due - time.perf_counter()
                if wait > 0:
                    time.sleep(wait)
                t_sent = start + due
            else:
                t_sent = time.perf_counter()
            d, i, st = call(q, k)
            t_done = time.perf_counter()
            r.calls.append((b, d, i))
            r.latencies.append(t_done - t_sent)
            r.done_at.append(t_done - start)
            r.queries += len(q)
            if r.trace:
                r.stats.append(st)
            if due is None and t_done - start >= seconds \
                    and len(r.calls) >= min_calls:
                break
        r.window_s = time.perf_counter() - start
    print(f"window: {halves(r)}", file=sys.stderr)
    if r.trace:
        r.summary = tracer.summary()
        print(f"trace: {r.summary.describe()}", file=sys.stderr)


def setup_phases(r: Run) -> str:
    """Where set-up went: the seconds of each phase (imports from the
    process's start), then the program's build stages."""
    names = ["imports", *r.marks]
    times = [r.t0, *r.marks.values()]
    parts = [f"{a} {t1 - t0:.3f} s" for a, t0, t1 in
             zip(names, times, times[1:])]
    stages = ", ".join(f"{k} {v:.3f}" for k, v in r.build_times.items())
    return f"{'; '.join(parts)} (of {r.setup_s:.3f} s); build: {stages}"


def halves(r: Run) -> str:
    """The rate of each half of the window, by when answers came in: two
    halves that agree while runs differ put the spread between runs."""
    if not r.calls:
        return "no requests"
    mid = r.window_s / 2
    first = sum(len(r.traffic.batch(b)) for (b, _, _), t in
                zip(r.calls, r.done_at) if t <= mid)
    return (f"{len(r.calls)} requests, {r.queries} queries in "
            f"{r.window_s:.3f} s; queries/s by half: {first / mid:.1f}, "
            f"{(r.queries - first) / (r.window_s - mid):.1f}")


def judge(r: Run, base, pool, metric: str, traffic: Traffic) -> dict:
    """The plain reference's verdict on every answer of the window."""
    from pb.reference import exact_topk
    _, gt = exact_topk(base, pool, traffic.k, metric, device=r.device)
    r.verdict = check.judge(r.calls, traffic, base, gt, metric,
                            r.cell.limits)
    return r.verdict


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool,
        device: str, t0: float) -> dict:
    """One run of the benchmark; `t0` is the process's start on
    perf_counter's clock."""
    import torch

    from pb.system import KBestSystem

    r = Run(cell, trace, device, t0)
    r.marks["data"] = time.perf_counter()
    base, pool, metric, traffic = prepare(cell, seed)
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    r.marks["build"] = time.perf_counter()
    system = KBestSystem(cell.config, device)
    system.build(base)
    r.build_times = system.build_times
    r.system = system
    readers = [spec.reader(m["name"], cell.base)
               for m in cell.metrics(trace)]
    measure(r, system.search, traffic, seconds)
    print(f"setup: {setup_phases(r)}", file=sys.stderr)
    memory_peak = torch.cuda.max_memory_allocated() if on_card else 0
    if trace:                    # counts that replay the window's batches
        for mod in readers:
            if hasattr(mod, "replay"):
                mod.replay(r)
    # the program's state is freed before the reference runs
    system.close()
    del system
    r.system = None
    gc.collect()
    if on_card:
        torch.cuda.empty_cache()
    v = judge(r, base, pool, metric, traffic)

    metrics = {}
    for m, mod in zip(cell.metrics(trace), readers):
        value = mod.read(r)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    result = {"correct": bool(v["correct"]), "attempted": v["attempted"],
              "failed": v["failed"], "metrics": metrics,
              "device": device_entry(device, cell.chips, memory_peak)}
    if trace:
        result["device"]["busy_s"] = r.summary.busy_s()
        result["device"]["window_s"] = r.window_s
        result["breakdown"] = r.summary.breakdown()
    result["checks"] = checks(r)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"the measured process holds {found} after the "
                         f"window: the benchmark runs without JAX and "
                         f"without the JAX package")
    return result


def checks(r: Run) -> dict:
    """Each compared number beside its limit."""
    return {name: {"value": r.verdict["numbers"][name],
                   "limit": r.cell.limits[name]} for name in check.NUMBERS}


def device_entry(device: str, chips: int, memory_peak: int) -> dict:
    import torch
    if torch.device(device).type == "cuda":
        kind = torch.cuda.get_device_name(0)
    else:
        kind = "cpu"
    return {"platform": "gpu" if kind != "cpu" else "cpu", "kind": kind,
            "count": chips, "memory_peak_bytes": int(memory_peak)}
