"""Seeded violation for registry: a hand-enumerated quant sweep."""
KINDS = ["full", "pq8", "zq"]
