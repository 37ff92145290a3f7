"""syncs_per_call.graph: `syncs_per_call` (metrics/syncs_per_call.py),
read the same way, in the cells of the graph traversal, whose end-to-end
rate is `qps.graph`."""
from pb import spec

read = spec.reader("syncs_per_call").read
