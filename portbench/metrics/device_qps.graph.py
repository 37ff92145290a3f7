"""device_qps.graph: `device_qps` (metrics/device_qps.py), read the same way, in the
cells of the graph traversal, whose end-to-end rate is `qps.graph`."""
from pb import spec

read = spec.reader("device_qps").read
