"""syncs_per_call: the program's `sync` counts (repro_torch/spans.py:
one at each of the two host syncs that the port's sync lint allows, the
traversal's exit check and the stable top-k's tie check) in the traced
window, over the window's `search` calls. Importing this reader turns
the program's span recorder on (pb.program_spans)."""
from pb import program_spans

program_spans.recorder()


def read(run):
    w = program_spans.window(run)
    if w is None:
        return None
    return w.counts["sync"] / len(w.calls)
