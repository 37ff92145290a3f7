"""The one traffic generator: a mix's parameters in, the requests out.

A mix is a data file, traffic/<name>.json, that this generator reads:

    "query_pool": N          queries the data generator draws after the
                             corpus
    "k": 10                  neighbours asked for
    "loop": "closed"         one caller; the next request goes out once
                             the previous one's answers are on the host
        "queries_per_call": Q    queries in each request
    "loop": "open"           requests go out at arrival times on the wall
                             clock, whether or not the last is answered;
                             a request that goes out late counts its wait
        "request_sizes": [lo, hi]   queries in a request, uniform in
                                    lo..hi
        "rate_per_s": R          mean arrivals a second
        "burst": {"factor": F, "every_s": P, "for_s": S}   optional: the
                                 rate is F * R for S seconds of every P,
                                 from the window's start
        "schedule_seed": s       optional (default 0): the seed of the
                                 sizes and the arrival times

The pool, in the data generator's order, is cut into requests of
consecutive rows: N / Q of Q queries (closed), or of the sizes drawn from
`schedule_seed` (open). The run's seed orders the requests and the
queries within each, and the requests cycle in that order; the arrival
times come from `schedule_seed` alone. So every seed sends the same
requests at the same times, the same work in another order: in a
lockstep traversal a call lasts as long as its slowest query, so which
queries share a request sets the work.
"""
from __future__ import annotations

from typing import Iterator, List, Optional, Tuple

import numpy as np


class Traffic:
    def __init__(self, mix: dict, pool: np.ndarray, seed: int):
        self.k = int(mix["k"])
        self.open = mix.get("loop") == "open"
        if mix.get("loop") not in ("closed", "open"):
            raise ValueError(f"unknown loop {mix.get('loop')!r}: "
                             f"'closed' or 'open'")
        n = len(pool)
        if self.open:
            sizes = _sizes(mix, n)
        else:
            Q = int(mix["queries_per_call"])
            if n % Q or not n:
                raise ValueError(f"query_pool {n} is not a whole number of "
                                 f"calls of {Q}")
            sizes = np.full(n // Q, Q)
        starts = np.concatenate([[0], np.cumsum(sizes)[:-1]])
        rng = np.random.default_rng(int(seed))
        order = rng.permutation(len(sizes))
        rows = np.concatenate([starts[b] + rng.permutation(sizes[b])
                               for b in order])
        self.pool = pool[rows]          # the pool in the order it is sent
        self.sizes = sizes[order]
        self.offsets = np.concatenate([[0], np.cumsum(self.sizes)])
        self.n_batches = len(sizes)
        self.mix = mix

    def rows(self, b: int) -> slice:
        """Request b's rows of the pool, in the order it is sent."""
        return slice(int(self.offsets[b]), int(self.offsets[b + 1]))

    def batch(self, b: int) -> np.ndarray:
        return self.pool[self.rows(b)]

    def warm_batches(self) -> List[int]:
        """One request of each distinct size: the shapes the mix sends."""
        first = {}
        for b, s in enumerate(self.sizes):
            first.setdefault(int(s), b)
        return sorted(first.values())

    def requests(self) -> Iterator[Tuple[int, np.ndarray, Optional[float]]]:
        """(request, queries, due) forever, cycling through the requests;
        due is the arrival in seconds after the window's start (open
        loop), None in a closed loop."""
        times = _arrivals(self.mix) if self.open else None
        b = 0
        while True:
            yield b, self.batch(b), (next(times) if times else None)
            b = (b + 1) % self.n_batches


def _sizes(mix: dict, n: int) -> np.ndarray:
    lo, hi = (int(v) for v in mix["request_sizes"])
    rng = np.random.default_rng(int(mix.get("schedule_seed", 0)))
    sizes = rng.integers(lo, hi + 1, size=n // lo + 1)
    sizes = sizes[:int(np.searchsorted(np.cumsum(sizes), n)) + 1]
    sizes[-1] -= sizes.sum() - n      # the last request ends the pool
    return sizes[sizes > 0]


def _arrivals(mix: dict) -> Iterator[float]:
    """Poisson arrivals at `rate_per_s`, `factor` times that during each
    burst, drawn by thinning from `schedule_seed`."""
    rate = float(mix["rate_per_s"])
    burst = mix.get("burst")
    peak = rate * (float(burst["factor"]) if burst else 1.0)
    rng = np.random.default_rng(int(mix.get("schedule_seed", 0)) + 1)
    t = 0.0
    while True:
        t += rng.exponential(1.0 / peak)
        now = rate
        if burst and t % float(burst["every_s"]) < float(burst["for_s"]):
            now = peak
        if rng.random() * peak < now:
            yield t
