"""The benchmark's data: a configuration's `data` entry names a generator,
`datagen/<generator>.py`, found by name like a metric's reader. Each is a
frozen copy kept with the yardstick, with `generate(n, n_queries, seed)`
giving (corpus, query pool, metric) as float32 arrays.
"""
from __future__ import annotations

from pathlib import Path
from typing import Tuple

import numpy as np

from pb import spec


def make(data: dict, n_queries: int, seed: int, base: Path = spec.HERE
         ) -> Tuple[np.ndarray, np.ndarray, str]:
    """The corpus and query pool of a configuration's `data` entry
    ({"generator": name, "n": rows, "seed": the generator's seed}), the
    corpus in the order that the run's `seed` gives.

    Every run serves the same vectors: the generator draws them from the
    configuration's own seed, and the run's seed permutes the corpus's
    rows, the order the program is handed them (pb.traffic orders the
    queries). So every seed brings the same work in another order, and
    the spread between runs is the system's, not the data's."""
    try:
        gen = spec.module("datagen", data["generator"], base)
    except FileNotFoundError as e:
        raise ValueError(f"unknown data generator {data['generator']!r}: "
                         f"{e}") from None
    corpus, pool, metric = gen.generate(int(data["n"]), int(n_queries),
                                        int(data["seed"]))
    rng = np.random.default_rng(int(seed))
    return corpus[rng.permutation(len(corpus))], pool, metric
