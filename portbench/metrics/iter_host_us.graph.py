"""iter_host_us.graph: the mean duration of the traced window's
`search.iter` spans (core/search.py, repro_torch/spans.py): the host's
time to enqueue one lockstep iteration of the traversal, without the
exit check's sync. Importing this reader turns the program's span
recorder on (pb.program_spans)."""
from pb import program_spans

program_spans.recorder()


def read(run):
    w = program_spans.window(run)
    if w is None:
        return None
    d = w.durations("search.iter")
    return sum(d) / len(d) / 1e3 if d else None
