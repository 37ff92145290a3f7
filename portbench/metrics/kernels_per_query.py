"""kernels_per_query: CUDA kernels the profiler saw in the traced window
(every torch op's and the hand-written ones), per query answered. The
benchmark's own counting is left out."""


def read(run):
    if run.summary is None or not run.queries:
        return None
    n = len(run.summary.kernels())
    return n / run.queries if n else None
