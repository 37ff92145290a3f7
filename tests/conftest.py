import os
import sys

# tests must see ONE cpu device (the dry-run sets 512 itself; never here)
os.environ.setdefault("JAX_PLATFORMS", "cpu")
sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np
import pytest


@pytest.fixture(scope="session")
def deep_ds():
    from repro.data.vectors import make_dataset
    return make_dataset("deep_like", n=2000, n_queries=40, k=10)


@pytest.fixture(scope="session")
def bigann_ds():
    from repro.data.vectors import make_dataset
    return make_dataset("bigann_like", n=2000, n_queries=40, k=10)


def _build(ds, **kw):
    from repro.core.index import KBest
    from repro.core.types import BuildConfig, IndexConfig, SearchConfig
    build = dict(M=24, knn_k=32, builder="brute", refine_iters=1,
                 refine_cands=64)
    build.update(kw)
    cfg = IndexConfig(dim=ds.base.shape[1], metric=ds.metric,
                      build=BuildConfig(**build),
                      search=SearchConfig(L=64, k=10, early_term=False))
    return KBest(cfg).add(ds.base)


@pytest.fixture(scope="session")
def deep_index(deep_ds):
    return _build(deep_ds)


@pytest.fixture(scope="session")
def bigann_index(bigann_ds):
    return _build(bigann_ds)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU (run on the card with "
        "`PYTHONPATH=src python -m pytest -m cuda tests/test_torch_*.py`); "
        "skips elsewhere")
