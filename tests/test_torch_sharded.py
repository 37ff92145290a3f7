"""The port's sharded composition (repro_torch.core.sharded) against the
JAX package's, on the CPU.

deep_like (ip, d=96), n=800, 24 queries, k=10, with the reference's small
configs of tests/test_sharded.py. What must hold:
- `shard_bounds`, `merge_stats` and `pad_to_shard_boundary` equal the
  reference's on the same inputs;
- with one shard, ShardedKBest is bit-identical to the port's KBest (ids,
  distances and every SearchStats field) for graph `none`, graph `pq4`,
  IVF `pq` and IVF `pq4`;
- the cross-shard merge breaks ties toward the lower column and sorts
  +inf / -1 slots last, as the reference's `lax.top_k(-d, k)` does (the
  reference's own `_search_impl` over the same per-shard outputs);
- an uneven 3-shard split returns global ids whose distances recompute;
  two shards reach at least one index's recall at equal per-shard L;
- shards the reference built and saved load into the port and give its
  ids (tie-aware: tests/test_torch_parity.py) and exactly its merged
  stats; the reference loads the port's saves.
Distances to the kernels' tolerance (rtol=3e-5, atol=3e-4).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import sharded as jsh
from repro.core import search as jsearch
from repro.core.types import BuildConfig as RefBuildConfig
from repro.core.types import IndexConfig as RefIndexConfig
from repro.core.types import IVFConfig as RefIVFConfig
from repro.core.types import QuantConfig as RefQuantConfig
from repro.core.types import SearchConfig as RefSearchConfig
from repro.data.vectors import make_dataset, recall_at_k
from repro_torch.core import search as tsearch
from repro_torch.core.index import KBest, _config_from_dict
from repro_torch.core.sharded import (ShardedKBest, merge_stats,
                                      pad_to_shard_boundary, shard_bounds)
from test_torch_parity import TOL, assert_same_ranking
from torch_reference_cache import jax_maps_below_limit  # noqa: F401

torch.set_num_threads(1)

N, Q, K = 800, 24, 10
FAMILIES = [("graph", "none"), ("graph", "pq4"), ("ivf", "pq"),
            ("ivf", "pq4")]


@pytest.fixture(scope="module")
def ds():
    return make_dataset("deep_like", n=N, n_queries=Q, k=K)


def _ref_cfg(ds, family, quant, n_shards=1) -> RefIndexConfig:
    """tests/test_sharded.py's configs, as the reference's dataclasses."""
    dim, metric = ds.base.shape[1], ds.metric
    if family == "graph":
        q = (RefQuantConfig() if quant == "none" else
             RefQuantConfig(kind=quant, pq_m=8, kmeans_iters=3))
        return RefIndexConfig(
            dim=dim, metric=metric, n_shards=n_shards, quant=q,
            build=RefBuildConfig(M=16, knn_k=24, builder="brute",
                                 refine_iters=1, refine_cands=48,
                                 reorder="mst"),
            search=RefSearchConfig(L=32, k=K, early_term=quant != "none",
                                   n_entries=4))
    return RefIndexConfig(
        dim=dim, metric=metric, index_type="ivf", n_shards=n_shards,
        ivf=RefIVFConfig(nlist=16, kmeans_iters=3, list_pad=16),
        quant=RefQuantConfig(kind=quant, pq_m=8, kmeans_iters=3),
        search=RefSearchConfig(L=48, k=K, nprobe=6))


def _cfg(ds, family, quant, n_shards=1):
    """The same config as the port's dataclasses."""
    return _config_from_dict(dataclasses.asdict(
        _ref_cfg(ds, family, quant, n_shards)))


@pytest.fixture(scope="module")
def built(ds):
    """Memoizing builder: get(family, quant, n_shards); n_shards=None is the
    port's plain KBest."""
    cache = {}

    def get(family, quant, n_shards=None):
        key = (family, quant, n_shards)
        if key not in cache:
            cfg = _cfg(ds, family, quant)
            if n_shards is None:
                cache[key] = KBest(cfg, device="cpu").add(ds.base)
            else:
                cache[key] = ShardedKBest(cfg, n_shards=n_shards,
                                          device="cpu").add(ds.base)
        return cache[key]

    return get


def _assert_stats_equal(s0, s1):
    for name in tsearch.SearchStats._fields:
        a, b = getattr(s0, name), getattr(s1, name)
        a = a.numpy() if isinstance(a, torch.Tensor) else np.asarray(a)
        b = b.numpy() if isinstance(b, torch.Tensor) else np.asarray(b)
        assert np.array_equal(a, b), name


# ------------------------------------------------------------ the helpers
@pytest.mark.parametrize("n,p", [(10, 3), (8, 4), (800, 3), (7, 1),
                                 (5, 5)])
def test_shard_bounds_matches_reference(n, p):
    got = shard_bounds(n, p)
    assert np.array_equal(got, jsh.shard_bounds(n, p))
    assert got[0] == 0 and got[-1] == n


def test_shard_bounds_rejects_more_shards_than_rows():
    with pytest.raises(AssertionError):
        shard_bounds(2, 3)
    with pytest.raises(AssertionError):
        jsh.shard_bounds(2, 3)


@pytest.mark.parametrize("n_shards", [1, 2, 3])
def test_merge_stats_matches_reference(n_shards):
    rng = np.random.default_rng(n_shards)
    per = [dict(n_hops=rng.integers(0, 50, 6).astype(np.int32),
                n_dist=rng.integers(0, 900, 6).astype(np.int32),
                early_terminated=rng.random(6) < 0.6,
                iters=np.int32(rng.integers(1, 40)))
           for _ in range(n_shards)]
    got = merge_stats([tsearch.SearchStats(
        **{k: torch.as_tensor(v) for k, v in s.items()}) for s in per])
    exp = jsh.merge_stats([jsearch.SearchStats(
        **{k: jnp.asarray(v) for k, v in s.items()}) for s in per])
    _assert_stats_equal(exp, got)


def test_pad_to_shard_boundary_matches_reference():
    db = np.arange(10 * 4, dtype=np.float32).reshape(10, 4)
    graph = np.arange(10 * 3, dtype=np.int32).reshape(10, 3) % 10
    for p in (4, 5, 3):
        got = pad_to_shard_boundary(db, graph, p)
        exp = jsh.pad_to_shard_boundary(db, graph, p)
        assert got[2] == exp[2]
        for a, b in zip(got[:2], exp[:2]):
            assert a.dtype == b.dtype and np.array_equal(a, b)


# ------------------------------------------------- one shard == KBest
@pytest.mark.parametrize("family,quant", FAMILIES)
def test_single_shard_bit_parity(ds, built, family, quant):
    """One shard reproduces the port's KBest bit for bit: ids, distances
    and every SearchStats field, for search and search_padded."""
    single = built(family, quant)
    sharded = built(family, quant, 1)
    assert sharded.shards[0].config.n_shards == 1
    d0, i0, s0 = single.search(ds.queries, with_stats=True)
    d1, i1, s1 = sharded.search(ds.queries, with_stats=True)
    assert torch.equal(i0, i1) and torch.equal(d0, d1)
    _assert_stats_equal(s0, s1)
    vm = np.ones(Q, bool)
    vm[::5] = False
    d0, i0, s0 = single.search_padded(ds.queries, vm, with_stats=True)
    d1, i1, s1 = sharded.search_padded(ds.queries, vm, with_stats=True)
    assert torch.equal(i0, i1) and torch.equal(d0, d1)
    _assert_stats_equal(s0, s1)


# ----------------------------------------------------------- the merge
class _StubShard:
    """A shard whose search returns fixed per-shard outputs."""

    def __init__(self, d, i, torch_side: bool):
        self.d, self.i, self.torch_side = d, i, torch_side

    def _search_impl(self, q, scfg, valid_mask=None, with_stats=True):
        n = self.d.shape[0]
        stats = dict(n_hops=np.ones(n, np.int32), n_dist=np.ones(n, np.int32),
                     early_terminated=np.zeros(n, bool), iters=np.int32(1))
        if self.torch_side:
            return (torch.as_tensor(self.d), torch.as_tensor(self.i),
                    tsearch.SearchStats(**{k: torch.as_tensor(v)
                                           for k, v in stats.items()}))
        return (jnp.asarray(self.d), jnp.asarray(self.i),
                jsearch.SearchStats(**{k: jnp.asarray(v)
                                       for k, v in stats.items()}))


def test_merge_breaks_cross_shard_ties_as_lax_top_k():
    """Sorted per-shard top-4 rows with exact ties inside and across
    shards, and +inf / -1 tails (padded lanes, shards with fewer than k
    hits): the port's merge gives the reference's ids and distances."""
    inf = np.inf
    d = [np.array([[0.1, 0.5, 0.5, 0.9], [0.2, 0.2, inf, inf],
                   [inf, inf, inf, inf], [0.3, 0.3, 0.3, 0.3]], np.float32),
         np.array([[0.5, 0.5, 0.7, inf], [0.2, 0.4, 0.4, 0.4],
                   [0.0, inf, inf, inf], [0.3, 0.3, 0.3, 0.3]], np.float32),
         np.array([[0.05, 0.5, inf, inf], [inf, inf, inf, inf],
                   [inf, inf, inf, inf], [0.3, 0.31, 0.31, 0.4]],
                  np.float32)]
    ids = [np.where(np.isinf(x), -1,
                    np.arange(x.size).reshape(x.shape) + 7 * s
                    ).astype(np.int32) for s, x in enumerate(d)]
    offsets = np.array([0, 100, 200, 300])
    cfg = _config_from_dict(dataclasses.asdict(RefIndexConfig(
        dim=4, metric="l2", search=RefSearchConfig(L=8, k=4))))
    port = ShardedKBest(cfg, n_shards=3, device="cpu")
    port.offsets = offsets
    port.shards = [_StubShard(a, b, True) for a, b in zip(d, ids)]
    ref = jsh.ShardedKBest(RefIndexConfig(dim=4, metric="l2"), n_shards=3)
    ref.offsets = offsets
    ref.shards = [_StubShard(a, b, False) for a, b in zip(d, ids)]
    scfg = cfg.search
    got_d, got_i, got_s = port._search_impl(torch.zeros(4, 4), scfg, None)
    exp_d, exp_i, exp_s = ref._search_impl(
        jnp.zeros((4, 4)), RefSearchConfig(L=8, k=4), valid_mask=None,
        with_stats=True)
    assert np.array_equal(got_i.numpy(), np.asarray(exp_i))
    assert np.array_equal(got_d.numpy(), np.asarray(exp_d))
    _assert_stats_equal(exp_s, got_s)
    # the lower shard wins a cross-shard tie; empty slots stay (+inf, -1)
    assert got_i[0].tolist() == [214, 0, 1, 2]
    assert got_i[2].tolist() == [115, -1, -1, -1]


# ------------------------------------------------- several shards, port
def test_uneven_three_shard_split_global_ids(ds):
    """P=3 over n=800 (267/267/266): every id is a global row id whose
    recomputed exact distance is the returned one."""
    sharded = ShardedKBest(_cfg(ds, "graph", "none"), n_shards=3,
                           device="cpu").add(ds.base)
    assert [len(s.db) for s in sharded.shards] == [267, 267, 266]
    assert sharded.n_total == N and sharded.mesh_shape == (3,)
    d, i = sharded.search(ds.queries)
    d, i = d.numpy(), i.numpy()
    assert ((i >= 0) & (i < N)).all()
    for row in i:                      # no cross-shard duplicate ids
        assert len(set(row.tolist())) == len(row)
    exact = -np.einsum("qd,qkd->qk", ds.queries, ds.base[i])      # ip
    np.testing.assert_allclose(d, exact, **TOL)
    assert recall_at_k(i, ds.gt_ids, K) >= 0.8


@pytest.mark.parametrize("family,quant", [("graph", "none"), ("ivf", "pq4")])
def test_two_shard_recall_floor(ds, built, family, quant):
    """Two shards at equal per-shard L reach at least one index's
    recall@10: every shard runs its own full search."""
    _, i0 = built(family, quant).search(ds.queries)
    _, i1 = built(family, quant, 2).search(ds.queries)
    r0 = recall_at_k(i0.numpy(), ds.gt_ids, K)
    r1 = recall_at_k(i1.numpy(), ds.gt_ids, K)
    assert r1 >= r0, (r1, r0)
    assert r1 >= 0.8, r1


def test_stats_merge_across_two_shards(ds, built):
    sharded = built("graph", "none", 2)
    _, _, st = sharded.search(ds.queries, with_stats=True)
    per = [sh.search(ds.queries, with_stats=True)[2]
           for sh in sharded.shards]
    assert torch.equal(st.n_dist, per[0].n_dist + per[1].n_dist)
    assert torch.equal(st.n_hops, per[0].n_hops + per[1].n_hops)
    assert torch.equal(st.early_terminated,
                       per[0].early_terminated & per[1].early_terminated)
    assert int(st.iters) == max(int(s.iters) for s in per)


def test_search_padded_masks_lanes(ds, built):
    sharded = built("graph", "none", 2)
    nq = 5
    qp = np.zeros((8, ds.base.shape[1]), np.float32)
    qp[:nq] = ds.queries[:nq]
    mask = np.zeros((8,), bool)
    mask[:nq] = True
    d, i, st = sharded.search_padded(qp, mask, with_stats=True)
    d0, i0, st0 = sharded.search(ds.queries[:nq], with_stats=True)
    assert torch.equal(i[:nq], i0) and torch.equal(d[:nq], d0)
    assert bool(torch.isinf(d[nq:]).all()) and bool((i[nq:] == -1).all())
    assert int(st.n_dist[nq:].sum()) == 0 and int(st.n_hops[nq:].sum()) == 0
    assert torch.equal(st.n_dist[:nq], st0.n_dist)


def test_kbest_rejects_sharded_config(ds):
    cfg = _cfg(ds, "graph", "none", n_shards=2)
    with pytest.raises(AssertionError, match="ShardedKBest"):
        KBest(cfg, device="cpu").add(ds.base)
    # the constructor's override stamps the config
    one = dataclasses.replace(cfg, n_shards=1)
    assert ShardedKBest(one, n_shards=4, device="cpu").config.n_shards == 4


# ---------------------------------------- saves across the two packages
# (family, quant, n_shards) of the reference-built manifests
MANIFESTS = [("graph", "none", 2), ("graph", "pq4", 2), ("ivf", "pq", 3),
             ("ivf", "pq4", 2)]


@pytest.fixture(scope="module")
def ref_saved(ds, tmp_path_factory):
    """Reference-built ShardedKBest indexes, saved: name -> (index, path)."""
    root = tmp_path_factory.mktemp("ref_sharded")
    out = {}
    for family, quant, p in MANIFESTS:
        ref = jsh.ShardedKBest(_ref_cfg(ds, family, quant, p)).add(ds.base)
        path = str(root / f"{family}-{quant}")
        ref.save(path)
        out[(family, quant, p)] = (ref, path)
    return out


@pytest.mark.parametrize("case", MANIFESTS, ids=lambda c: f"{c[0]}-{c[1]}")
@pytest.mark.parametrize("impl", ["ref", "kernel"])
def test_reference_manifest_loads_in_port(ds, ref_saved, case, impl):
    """The port loads the reference's manifest and shards and searches
    them as the reference does: ids tie-aware, merged stats exactly (the
    reference on 8 queries through its interpret-mode kernels)."""
    ref, path = ref_saved[case]
    port = ShardedKBest.load(path, device="cpu")
    assert port.config == _cfg(ds, case[0], case[1], case[2])
    assert np.array_equal(port.offsets, ref.offsets)
    q = ds.queries if impl == "ref" else ds.queries[:8]
    rs = dataclasses.replace(ref.config.search, dist_impl=impl)
    ts = dataclasses.replace(port.config.search, dist_impl=impl)
    d0, i0, s0 = ref.search(q, search_cfg=rs, with_stats=True)
    d1, i1, s1 = port.search(q, search_cfg=ts, with_stats=True)
    assert_same_ranking(d1.numpy(), i1.numpy(), np.asarray(d0),
                        np.asarray(i0))
    _assert_stats_equal(s0, s1)


def test_port_save_loads_in_reference(ds, built, tmp_path):
    """The reference's ShardedKBest.load reads a port save, manifest and
    shards, and answers as the port does."""
    port = built("ivf", "pq4", 2)
    path = str(tmp_path / "mesh.idx")
    port.save(path)
    assert (tmp_path / "mesh.idx.sharded.json").exists()
    for s in range(2):
        assert (tmp_path / f"mesh.idx.shard{s}.npz").exists()
        assert (tmp_path / f"mesh.idx.shard{s}.json").exists()
    ref = jsh.ShardedKBest.load(path)
    assert dataclasses.asdict(ref.config) == dataclasses.asdict(port.config)
    assert np.array_equal(ref.offsets, port.offsets)
    d0, i0, s0 = ref.search(ds.queries, with_stats=True)
    d1, i1, s1 = port.search(ds.queries, with_stats=True)
    assert_same_ranking(d1.numpy(), i1.numpy(), np.asarray(d0),
                        np.asarray(i0))
    _assert_stats_equal(s0, s1)
    back = ShardedKBest.load(path, device="cpu")
    d2, i2 = back.search(ds.queries)
    assert torch.equal(i2, i1) and torch.equal(d2, d1)
