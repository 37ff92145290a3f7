"""idle_in_search_ms: the device's idle time inside the program's search
calls, per call, in the traced window: the complement of the union of
the trace's device intervals (`run.summary.device`), within the window,
that overlaps the program's `search` spans (repro_torch/spans.py, on the
profiler's clock), over the window's calls.

Importing this reader turns the program's span recorder on
(pb.program_spans). Its read also prints one line to standard error: the
window's idle seconds by innermost span and "outside the program", each
span's self time, and how many of the window's kernel launches, the
host's `cudaLaunchKernel` and `cudaLaunchKernelExC` events that the
profiler records beside the device's (`run.summary._host`), start inside
a `search` span: every kernel is launched from inside `KBest.search`, so
it reads about 100% where the two clocks agree."""
import sys

from pb import program_spans

program_spans.recorder()


def read(run):
    if run.summary is None or not run.summary.device:
        return None
    w = program_spans.window(run)
    if w is None:
        return None
    rep = program_spans.idle_report(w, run.summary)
    print(f"spans: {program_spans.describe(rep, w)}", file=sys.stderr)
    return rep["in_calls"] / 1e6 / len(w.calls)
