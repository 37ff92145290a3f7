"""The system under test: the port's `KBest` facade, built from a
configuration file's `index` entry (the fields of the port's
`IndexConfig` and its nested `build`, `search`, `quant` and `ivf`
groups), and served as the configuration's optional `front_end` entry
says: by default each request is one `KBest.search`; with
`{"engine": {"min_bucket": 8, "max_bucket": 256}}` the port's
`SearchEngine` pads it to a shape bucket (serve/engine.py). The benchmark
reaches the program only here, in the metric readers that wrap its
kernel entry points, and in the faults that pb/faults.py plants for the
checks of the comparison.
"""
from __future__ import annotations

import numpy as np


def index_config(index: dict):
    from repro_torch.core.types import (BuildConfig, IndexConfig, IVFConfig,
                                        QuantConfig, SearchConfig)
    groups = dict(build=BuildConfig, search=SearchConfig, quant=QuantConfig,
                  ivf=IVFConfig)
    kw = {k: (groups[k](**v) if k in groups else v) for k, v in index.items()}
    return IndexConfig(**kw)


class KBestSystem:
    def __init__(self, config: dict, device: str):
        from repro_torch.core.index import KBest
        self.index = KBest(index_config(config["index"]), device=device)
        self.front_end = config.get("front_end", {})
        self.engine = None

    def build(self, base: np.ndarray) -> None:
        self.index.add(base)
        if "engine" in self.front_end:
            from repro_torch.serve.engine import SearchEngine
            self.engine = SearchEngine(self.index,
                                       **self.front_end["engine"])

    @property
    def build_times(self) -> dict:
        return dict(self.index.build_times)

    def search(self, queries: np.ndarray, k: int):
        """One call as a client makes it: host queries in, (dists, ids)
        on the host out, and the program's SearchStats (left on the
        device; None through the engine)."""
        if self.engine is not None:
            d, i = self.engine.search(queries, k=k)
            return np.asarray(d), np.asarray(i), None
        d, i, stats = self.index.search(queries, k=k, with_stats=True)
        return d.cpu().numpy(), i.cpu().numpy(), stats

    def close(self) -> None:
        self.index = self.engine = None
