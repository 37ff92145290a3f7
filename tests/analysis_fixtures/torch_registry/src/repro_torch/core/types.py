"""Seeded violation for registry: kind "zq" is registered here but
appears in no quant_variants entry, dispatch branch, save/load path or
preset."""
QUANT_KINDS = ("none", "pq", "zq")
