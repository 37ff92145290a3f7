"""expand_roofline.graph: the graph traversal's distance kernels
(`ops.fused_expand`, the W > 1 step, and `ops.gather_dist`, the entry
seeds) against their roofline, in the traced window.

A call needs, once each: the sectors of the distinct valid rows it
gathers, the (Q, d) queries, the (Q, C) ids, and its outputs (fused_expand:
(Q, T) sorted distances and ids, (Q, W) bests and ties; gather_dist:
(Q, M) distances), and three operations a dimension for every valid
(query, id) pair. Counted with pb.bounds as the port's smoke test counts
the same kernels, except that a row several queries gather is read once.
The device time is that of the kernels these entry points launch:
`expand_kernel` and `warp_step_kernel` (csrc/traverse_step.cu) and
`gather_kernel` (csrc/gather_dist.cu).
"""
from pb import bounds
from pb.roofline import replay as _replay
from pb.roofline import share

NAMES = ("fused_expand", "gather_dist")
KERNELS = r"::(expand_kernel|warp_step_kernel|gather_kernel)<"


def replay(run):
    spans = {}

    def rows(db):
        key = (db.shape[0], db.shape[1] * db.element_size())
        if key not in spans:
            spans[key] = bounds.row_sectors(*key, db.device)
        return spans[key]

    def expand_cost(args, kw):
        q, db, ids = args[:3]
        Q, d = q.shape
        C = ids.shape[1]
        T, W = min(kw["L"], C), kw.get("n_beam", 1)
        io = Q * d * 4 + Q * C * 4 + Q * T * 8 + Q * W * 8
        return (bounds.distinct_row_bytes(ids, rows(db)) + io,
                bounds.valid_count(ids) * 3 * d)

    def gather_cost(args, kw):
        q, db, ids = args[:3]
        Q, d = q.shape
        io = Q * d * 4 + Q * ids.shape[1] * 8
        return (bounds.distinct_row_bytes(ids, rows(db)) + io,
                bounds.valid_count(ids) * 3 * d)

    _replay(run, {"fused_expand": expand_cost, "gather_dist": gather_cost})


def read(run):
    return share(run, NAMES, KERNELS)
