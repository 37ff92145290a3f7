"""A kernel entry point's share of its roofline, for the metric readers.

The traced window runs the program untouched. Once it has closed, the
system still built, `replay` serves each distinct batch of the window
once more with entry points of the program's `kernels/ops.py` wrapped:
after each call, a `cost(args, kwargs)` function of the reader counts
what the call needed (bytes and operations, pb.bounds). The calls are
the same as the window's (the same index, queries and search), so each
batch's counts stand for every time the window served it.

`share` sets the least time those needs take on the card (bytes over the
HBM peak or operations over the float32 peak, whichever is larger, call
by call) against the trace's device time of the kernels whose names the
reader gives: the kernels those entry points launch.
"""
from __future__ import annotations

from collections import Counter
from typing import Callable, Dict, Optional

from pb import bounds


def replay(run, costs: Dict[str, Callable]) -> None:
    """Serve each batch of the window once with `ops.<name>` wrapped by
    its cost function; run.counters[name] gets the least milliseconds of
    all the window's calls of it."""
    from repro_torch.kernels import ops
    served = Counter(b for b, _, _ in run.calls)
    origs = {name: getattr(ops, name) for name in costs}
    records = {name: [] for name in costs}

    def wrapped(name):
        orig, cost = origs[name], costs[name]

        def fn(*args, **kwargs):
            out = orig(*args, **kwargs)
            records[name].append(cost(args, kwargs))
            return out
        return fn

    for name in costs:
        setattr(ops, name, wrapped(name))
    try:
        for b, times in served.items():
            for name in costs:
                records[name].clear()
            run.system.search(run.traffic.batch(b), run.traffic.k)
            for name in costs:
                least = sum(bounds.bound(float(nbytes), float(flops))[0]
                            for nbytes, flops in records[name])
                run.counters[name] = run.counters.get(name, 0.0) \
                    + least * times
    finally:
        for name, orig in origs.items():
            setattr(ops, name, orig)


def share(run, names, kernels: str) -> Optional[float]:
    """100 * (least device seconds of the window's calls of `names`) /
    (device seconds of the kernels matching `kernels`); None where there
    is nothing to read."""
    if run.summary is None:
        return None
    least_s = sum(run.counters.get(n, 0.0) for n in names) / 1e3
    device_s = run.summary.device_s(kernels)
    if device_s <= 0 or least_s <= 0:
        return None
    return 100.0 * least_s / device_s
