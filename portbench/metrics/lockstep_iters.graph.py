"""lockstep_iters.graph: the traversal's lockstep iterations a call
(`SearchStats.iters`), mean over the traced window's calls."""


def read(run):
    iters = [int(st.iters) for st in run.stats if st is not None]
    return sum(iters) / len(iters) if iters else None
