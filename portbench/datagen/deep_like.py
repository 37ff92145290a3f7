"""deep_like: a frozen copy of the generator of the same name in the
port's `repro_torch/data/vectors.py` (numpy). The same seed gives the
same vectors, bit for bit, so a later change to the program's generator
cannot change what the benchmark serves. It draws `n + n_queries` rows at
once; the first `n` are the corpus, the rest the query pool, as the
original does.

Deep1M (1M x 96 CNN descriptors, inner product on unit vectors) cannot be
fetched here, so a low-rank gaussian plus noise, normalised, stands in for
it: rank 32 in d = 96.
"""
import zlib

import numpy as np


def _normalize(x):
    return x / np.maximum(np.linalg.norm(x, axis=1, keepdims=True), 1e-12)


def generate(n: int, n_queries: int, seed: int):
    """(base (n, 96) f32, queries (n_queries, 96) f32, metric "ip")."""
    rng = np.random.default_rng(seed + zlib.crc32(b"deep_like") % 65536)
    d, rank = 96, 32
    a = rng.normal(size=(rank, d)).astype(np.float32)
    allx = _normalize(
        rng.normal(size=(n + n_queries, rank)).astype(np.float32) @ a
        + 0.1 * rng.normal(size=(n + n_queries, d)).astype(np.float32))
    return allx[:n], allx[n:], "ip"
