"""The port's graph search against the JAX package's, on reference-built
graphs.

The reference builds the conftest indexes (deep_like and bigann_like,
n=2,000, 40 queries); the port takes them over through both routes —
`convert.from_reference_arrays` and `KBest.load` of a reference save —
and must return the same ids (tie-aware: tests/test_torch_parity.py)
and all four SearchStats fields, over W ∈ {1, 2, 4} × {queue, bitmap} ×
dist_impl ∈ {ref, kernel}. Distances
agree to the kernels' tolerance (rtol=3e-5, atol=3e-4); on CPU the port's
"kernel" path runs the kernels' plain versions, the reference's runs its
Pallas kernels in interpret mode.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core.index import KBest as RefKBest
from repro_torch.core.convert import from_reference_arrays
from repro_torch.core.index import KBest
from repro_torch.core.types import SearchConfig
from test_torch_parity import assert_same_ranking
from torch_reference_cache import jax_maps_below_limit  # noqa: F401

# parallel test workers share the cores: one torch thread each keeps the
# many small eager ops from oversubscribing them
torch.set_num_threads(1)


def _arrays(ref):
    return {"db": np.asarray(ref.db), "graph": np.asarray(ref.graph),
            "order": ref.order}


def _port(ref):
    return from_reference_arrays(_arrays(ref), ref.entry,
                                 dataclasses.asdict(ref.config), "cpu")


@pytest.fixture(scope="module")
def port_deep(deep_index):
    return _port(deep_index)


def _same(ref_out, port_out):
    (d0, i0, s0), (d1, i1, s1) = ref_out, port_out
    assert_same_ranking(d1.numpy(), i1.numpy(), d0, i0)
    for name in ("n_hops", "n_dist", "early_terminated", "iters"):
        assert np.array_equal(np.asarray(getattr(s0, name)),
                              getattr(s1, name).numpy()), name


def _queries(ds, impl):
    """The reference runs its Pallas kernels in interpret mode, one grid
    step per (query, candidate): kernel cases take 8 of the 40 queries."""
    return ds.queries[:8] if impl == "kernel" else ds.queries


def _scfg(base, W, mode, impl, **kw):
    return dataclasses.replace(base, beam_width=W, visited_mode=mode,
                               dist_impl=impl, early_term=True, **kw)


@pytest.mark.parametrize("impl", ["ref", "kernel"])
@pytest.mark.parametrize("mode", ["queue", "bitmap"])
@pytest.mark.parametrize("W", [1, 2, 4])
def test_search_matches_reference(deep_index, port_deep, deep_ds, W, mode,
                                  impl):
    s = _scfg(deep_index.config.search, W, mode, impl, et_patience=8)
    q = _queries(deep_ds, impl)
    _same(deep_index.search(q, search_cfg=s, with_stats=True),
          port_deep.search(q, search_cfg=s, with_stats=True))


@pytest.mark.parametrize("W,mode,impl", [(1, "bitmap", "kernel"),
                                         (4, "queue", "kernel"),
                                         (2, "queue", "ref")])
def test_search_matches_reference_l2(bigann_index, bigann_ds, W, mode, impl):
    port = _port(bigann_index)
    s = _scfg(bigann_index.config.search, W, mode, impl)
    q = _queries(bigann_ds, impl)
    _same(bigann_index.search(q, search_cfg=s, with_stats=True),
          port.search(q, search_cfg=s, with_stats=True))


def test_load_of_reference_save_equals_convert(deep_index, port_deep,
                                               deep_ds, tmp_path):
    deep_index.save(str(tmp_path / "deep.graph"))
    loaded = KBest.load(str(tmp_path / "deep.graph"), device="cpu")
    assert loaded.entry == port_deep.entry
    assert loaded.config == port_deep.config
    assert torch.equal(loaded.db, port_deep.db)
    assert torch.equal(loaded.graph, port_deep.graph)
    assert np.array_equal(loaded.order, port_deep.order)
    s = _scfg(deep_index.config.search, 4, "queue", "ref")
    _same(deep_index.search(deep_ds.queries, search_cfg=s, with_stats=True),
          loaded.search(deep_ds.queries, search_cfg=s, with_stats=True))


def test_search_padded_matches_reference(deep_index, port_deep, deep_ds):
    vm = np.ones(len(deep_ds.queries), bool)
    vm[::3] = False
    s = _scfg(deep_index.config.search, 2, "queue", "ref")
    ref = deep_index.search_padded(deep_ds.queries, vm, search_cfg=s,
                                   with_stats=True)
    out = port_deep.search_padded(deep_ds.queries, vm, search_cfg=s,
                                  with_stats=True)
    _same(ref, out)
    d, i, st = out
    assert torch.isinf(d[~torch.as_tensor(vm)]).all()
    assert (i[~torch.as_tensor(vm)] == -1).all()
    assert int(st.n_dist[~torch.as_tensor(vm)].sum()) == 0
    d2, i2 = port_deep.search(deep_ds.queries[vm], search_cfg=s)
    assert torch.equal(i[torch.as_tensor(vm)], i2)


@pytest.mark.parametrize("k", [5, 80])
def test_k_override_matches_reference(deep_index, port_deep, deep_ds, k):
    d0, i0 = deep_index.search(deep_ds.queries, k=k)
    d1, i1 = port_deep.search(deep_ds.queries, k=k)
    assert i1.shape == (len(deep_ds.queries), k)
    assert_same_ranking(d1.numpy(), i1.numpy(), d0, i0)


def test_cosine_matches_reference(deep_index, deep_ds):
    cfg = dataclasses.replace(deep_index.config, metric="cosine")
    ref = RefKBest(cfg)
    ref.db, ref.graph = deep_index.db, deep_index.graph
    ref.entry, ref.order = deep_index.entry, deep_index.order
    port = from_reference_arrays(_arrays(deep_index), deep_index.entry,
                                 dataclasses.asdict(cfg), "cpu")
    q = deep_ds.queries * 3.0          # unnormalized: prep must normalize
    s = _scfg(cfg.search, 4, "queue", "ref")
    _same(ref.search(q, search_cfg=s, with_stats=True),
          port.search(q, search_cfg=s, with_stats=True))


@pytest.mark.parametrize("family", ["ivf", "pq4", "bin"])
def test_unported_families_raise(family):
    """Every family is ported now: the IVF index and the pq4 and bin
    kinds build and search a tiny set."""
    from repro_torch.core.types import (BuildConfig, IndexConfig, IVFConfig,
                                        QuantConfig, SearchConfig)
    x = np.random.default_rng(0).normal(size=(200, 8)).astype(np.float32)
    if family == "ivf":
        cfg = IndexConfig(dim=8, index_type="ivf",
                          ivf=IVFConfig(nlist=4, list_pad=8),
                          search=SearchConfig(L=16, k=5, nprobe=4),
                          quant=QuantConfig(kind="pq", pq_m=4,
                                            kmeans_iters=2))
        d, i = KBest(cfg, device="cpu").add(x).search(x[:6])
        assert i.shape == (6, 5) and torch.isfinite(d).all()
        assert bool((i[:, 0] == torch.arange(6)).all())
        return
    cfg = IndexConfig(dim=8, build=BuildConfig(M=8, knn_k=12, builder="brute"),
                      search=SearchConfig(L=16, k=5),
                      quant=QuantConfig(kind=family, pq_m=4, kmeans_iters=2))
    d, i = KBest(cfg, device="cpu").add(x).search(x[:6])
    assert i.shape == (6, 5) and torch.isfinite(d).all()
    assert bool((i[:, 0] == torch.arange(6)).all())


def test_default_device_is_the_card():
    from repro_torch.core.types import IndexConfig
    if torch.cuda.is_available():
        assert KBest(IndexConfig(dim=8)).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            KBest(IndexConfig(dim=8))


def test_search_config_is_the_reference_one():
    from repro.core.types import SearchConfig as RefSearchConfig
    assert dataclasses.asdict(SearchConfig()) == \
        dataclasses.asdict(RefSearchConfig())
