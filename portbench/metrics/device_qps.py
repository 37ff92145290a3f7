"""device_qps: queries answered in the traced window over the seconds in
which the device was busy (the union of the profiler's kernel, copy and
fill intervals): the rate the card would reach if the host never kept it
waiting. It counts the same work as `qps` but not the host's pace, so it
holds steadier between runs and hosts."""


def read(run):
    if run.summary is None or not run.queries:
        return None
    busy = run.summary.busy_s()
    return run.queries / busy if busy > 0 else None
