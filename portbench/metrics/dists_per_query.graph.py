"""dists_per_query.graph: distances the traversal computed a query
(`SearchStats.n_dist`), over the traced window's queries."""


def read(run):
    n = [int(st.n_dist.sum()) for st in run.stats if st is not None]
    return sum(n) / run.queries if n else None
