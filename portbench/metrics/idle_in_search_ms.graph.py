"""idle_in_search_ms.graph: `idle_in_search_ms`
(metrics/idle_in_search_ms.py), read the same way, in the cells of the
graph traversal, whose end-to-end rate is `qps.graph`."""
from pb import spec

read = spec.reader("idle_in_search_ms").read
