"""kernels_per_query.graph: `kernels_per_query` (metrics/kernels_per_query.py), read the same way, in the
cells of the graph traversal, whose end-to-end rate is `qps.graph`."""
from pb import spec

read = spec.reader("kernels_per_query").read
