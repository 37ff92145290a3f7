"""device_idle_share: the share of the traced window in which no device
activity ran: 100 * (1 - union of the profiler's kernel, copy and fill
intervals / window wall). The benchmark's own counting is left out."""


def read(run):
    if run.summary is None:
        return None
    busy = run.summary.busy_s()
    if busy <= 0:
        return None
    return 100.0 * (1.0 - busy / run.window_s)
