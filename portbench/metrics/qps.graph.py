"""qps.graph: `qps` (metrics/qps.py), read the same way, in the cells of
the graph traversal. Its calls are paced by the host's Python between
launches, so it spreads more from host to host than the IVF cells' rate,
and it has a bound of its own; `device_qps.graph` is its steady twin."""
from pb import spec

read = spec.reader("qps").read
