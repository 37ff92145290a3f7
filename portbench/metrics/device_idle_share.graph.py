"""device_idle_share.graph: `device_idle_share` (metrics/device_idle_share.py), read the same way, in the
cells of the graph traversal, whose end-to-end rate is `qps.graph`."""
from pb import spec

read = spec.reader("device_idle_share").read
