"""The port's graph build against the JAX package's.

Stage by stage, on the same numpy inputs: brute-force kNN (batch_dist
tiles + stable top-k), NN-descent with the reference's jax.random start
passed in, edge selection, 2-hop expansion, the reverse passes,
connectivity repair, refinement and MST reordering; then the whole add()
at n=2,000 against the conftest indexes, node_chunk independence, and
format-2 save/load in both directions.

Distances are summed in another order than XLA's, so they may differ in
the last ulp, and two candidates that tie to within an ulp may swap: kNN
ids are compared where neighbouring distances are apart by more than the
tolerance, and a whole add() must give the reference's graph, order and
entry bit for bit or, failing that, differ in under 2% of the rows and
reach search recall within 0.005 of the reference graph's at equal config
(ROADMAP.md's bar, recorded under its "Faults").
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import build as rbuild
from repro.core import refine as rrefine
from repro.core import reorder as rreorder
from repro.core.index import KBest as RefKBest
from repro.data.vectors import recall_at_k
from repro_torch.core import build as tbuild
from repro_torch.core.convert import from_reference_arrays
from repro_torch.core import refine as trefine
from repro_torch.core import reorder as treorder
from repro_torch.core.index import KBest

# parallel test workers share the cores: one torch thread each keeps the
# many small eager ops from oversubscribing them
torch.set_num_threads(1)

TOL = dict(rtol=3e-5, atol=3e-4)


def _t(a):
    return torch.as_tensor(np.array(a))


def _cfg_dict(ref):
    return dataclasses.asdict(ref.config)


@pytest.fixture(scope="module")
def bigann_x(bigann_ds):
    return bigann_ds.base


@pytest.fixture(scope="module")
def bigann_knn(bigann_x):
    ids, d = rbuild.brute_force_knn(jnp.asarray(bigann_x), 32, "l2")
    return np.asarray(ids), np.asarray(d)


def _separated(d):
    """Slots whose distance is apart from both neighbours by more than the
    tolerance: there the order cannot depend on summation order."""
    gap = np.diff(d, axis=1) > TOL["atol"] + TOL["rtol"] * np.abs(d[:, 1:])
    sep = np.ones_like(d, bool)
    sep[:, 1:] &= gap
    sep[:, :-1] &= gap
    return sep


@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_brute_force_knn_matches_reference(metric, deep_ds):
    x = deep_ds.base[:800]
    rid, rd = [np.asarray(a) for a in rbuild.brute_force_knn(
        jnp.asarray(x), 16, metric)]
    tid, td = tbuild.brute_force_knn(_t(x), 16, metric)
    np.testing.assert_allclose(td.numpy(), rd, **TOL)
    sep = _separated(rd)
    assert np.array_equal(tid.numpy()[sep], rid[sep])
    assert sep.mean() > 0.8
    # build_knn's tiles (one here) give the same lists as 256-row tiles
    bid, bd = tbuild.build_knn(_t(x), 16, metric, builder="brute")
    assert torch.equal(bid, tid) and torch.equal(bd, td)


def test_stable_topk_breaks_ties_to_lower_index():
    d = torch.tensor([[3.0, 1.0, 1.0, 0.0, 1.0, -0.0],     # ties
                      [5.0, 4.0, 3.0, 2.0, 1.0, 0.0],      # none
                      [2.0, 2.0, 2.0, 2.0, 2.0, 2.0]])     # all tie
    v, i = tbuild.stable_topk_smallest(d, 5)
    neg, pos = jax.lax.top_k(-jnp.asarray(d.numpy()), 5)
    # -0.0 sorts before +0.0 (XLA's total order), equal values by index
    assert i.tolist() == np.asarray(pos).tolist()
    assert i[0].tolist() == [5, 3, 1, 2, 4]
    assert np.array_equal(v.numpy(), -np.asarray(neg))


def test_nn_descent_with_reference_init(bigann_x):
    x = bigann_x[:800]
    n, k = x.shape[0], 16
    init = jax.random.randint(jax.random.PRNGKey(3), (n, k), 0, n,
                              dtype=jnp.int32)
    rid, rd = rbuild.nn_descent(jnp.asarray(x), k, "l2", rounds=3,
                                sample=6, seed=3)
    tid, td = tbuild.nn_descent(_t(x), k, "l2", rounds=3, sample=6,
                                init_ids=_t(init), row_chunk=250)
    assert np.array_equal(tid.numpy(), np.asarray(rid))
    assert np.array_equal(td.numpy(), np.asarray(rd))
    # chunking over rows changes nothing
    tid2, _ = tbuild.nn_descent(_t(x), k, "l2", rounds=3, sample=6,
                                init_ids=_t(init), row_chunk=4096)
    assert torch.equal(tid, tid2)


@pytest.mark.parametrize("rule", ["alpha", "hnsw", "ssg"])
def test_select_edges_matches_reference(bigann_x, bigann_knn, rule):
    n = 700
    rows = np.arange(n, dtype=np.int32)
    kw = dict(M=16, rule=rule, metric="l2", alpha=1.0 if rule == "hnsw"
              else 1.2, cos_theta=0.5)
    ref = rrefine.select_edges(jnp.asarray(bigann_x), jnp.asarray(rows),
                               jnp.asarray(bigann_knn[0][:n]),
                               jnp.asarray(bigann_knn[1][:n]), **kw)
    out = trefine.select_edges(_t(bigann_x), _t(rows),
                               _t(bigann_knn[0][:n]), _t(bigann_knn[1][:n]),
                               **kw)
    assert np.array_equal(out.numpy(), np.asarray(ref))


def test_expand_two_hop_matches_reference(bigann_index, bigann_x):
    g = np.asarray(bigann_index.graph)
    rows = np.arange(0, 2000, 3, dtype=np.int32)
    ri, rd = rrefine.expand_two_hop(jnp.asarray(bigann_x), jnp.asarray(g),
                                    jnp.asarray(rows), C=64, metric="l2")
    ti, td = trefine.expand_two_hop(_t(bigann_x), _t(g), _t(rows), C=64,
                                    metric="l2")
    assert np.array_equal(ti.numpy(), np.asarray(ri))
    assert np.array_equal(td.numpy(), np.asarray(rd))


def _random_graph(seed, n=400, M=10, holes=0.15, trailing=True):
    r = np.random.default_rng(seed)
    g = ((np.arange(n)[:, None] + r.integers(-30, 30, size=(n, M))) % n)
    g = g.astype(np.int32)
    g[r.random((n, M)) < holes] = -1
    g = -np.sort(-g, axis=1)                  # -1 slots trailing
    g[n - 20:] = -1                           # a tail nobody leaves from
    g[:n - 20][g[:n - 20] >= n - 20] = -1     # ...and nobody enters
    g[n - 20:, 0] = np.arange(n - 19, n + 1) % n + 0
    g[n - 1, 0] = n - 20                      # an island cycle
    if trailing:                              # as select_edges leaves rows
        g = -np.sort(-g, axis=1)
    return g


@pytest.mark.parametrize("seed,trailing", [(0, True), (1, True), (2, False)])
def test_host_passes_match_reference(seed, trailing, bigann_x):
    g = _random_graph(seed, trailing=trailing)
    assert np.array_equal(trefine._reverse_proposals(g, 12),
                          rrefine._reverse_proposals(g, 12))
    assert np.array_equal(trefine.add_reverse_edges(g, 10),
                          rrefine.add_reverse_edges(g, 10))
    x = bigann_x[:g.shape[0]]
    assert np.array_equal(
        trefine.connectivity_repair(_t(x), g, 0, "l2"),
        rrefine.connectivity_repair(jnp.asarray(x), g, 0, "l2"))
    w = np.random.default_rng(seed).integers(0, 20, size=g.shape
                                             ).astype(np.float32)
    assert np.array_equal(treorder.mst_reorder(g, w, 5),
                          rreorder.mst_reorder(g, w, 5))
    assert np.array_equal(treorder.mst_reorder_global_heap(g, w, 5),
                          rreorder.mst_reorder_global_heap(g, w, 5))


def test_refine_graph_matches_reference(bigann_x, bigann_knn):
    x = bigann_x[:300]
    ids, d = [np.asarray(a) for a in rbuild.brute_force_knn(
        jnp.asarray(x), 16, "l2")]
    kw = dict(M=8, rule="alpha", metric="l2", alpha=1.2,
              ssg_angle_deg=60.0, iters=1, cand_cap=24, entry=7,
              search_L=16, search_passes=1)
    ref = rrefine.refine_graph(jnp.asarray(x), jnp.asarray(ids),
                               jnp.asarray(d), **kw)
    out = trefine.refine_graph(_t(x), _t(ids), _t(d), node_chunk=128, **kw)
    assert np.array_equal(out, np.asarray(ref))


@pytest.mark.parametrize("name", ["bigann", "deep"])
def test_add_matches_reference(name, request):
    """The whole add() at n=2,000 (brute kNN, the conftest config): the
    reference's graph, order and entry, or ROADMAP.md's recall bar."""
    ref = request.getfixturevalue(f"{name}_index")
    ds = request.getfixturevalue(f"{name}_ds")
    port = KBest(ref.config, device="cpu").add(ds.base)
    assert np.array_equal(port.db.numpy()[np.argsort(port.order)], ds.base)
    same = (port.entry == ref.entry
            and np.array_equal(port.order, ref.order)
            and np.array_equal(port.graph.numpy(), np.asarray(ref.graph)))
    if same:
        return
    g0 = np.asarray(ref.graph)[np.argsort(ref.order)]
    g1 = port.graph.numpy()[np.argsort(port.order)]
    rows = int((np.sort(ref.order[np.maximum(g0, 0)] * (g0 >= 0), 1)
                != np.sort(port.order[np.maximum(g1, 0)] * (g1 >= 0), 1)
                ).any(1).sum())
    assert rows < 0.02 * len(g0), rows
    # both graphs searched by the port (search parity with the reference
    # is pinned in test_torch_search.py)
    ref_in_port = from_reference_arrays(
        {"db": np.asarray(ref.db), "graph": np.asarray(ref.graph),
         "order": ref.order}, ref.entry, _cfg_dict(ref), "cpu")
    s = dataclasses.replace(ref.config.search, L=32)
    _, ri = ref_in_port.search(ds.queries, search_cfg=s)
    _, ti = port.search(ds.queries, search_cfg=s)
    r_ref = recall_at_k(np.asarray(ri), ds.gt_ids, 10)
    r_port = recall_at_k(ti.numpy(), ds.gt_ids, 10)
    assert abs(r_ref - r_port) <= 0.005, (r_ref, r_port)


def test_add_does_not_depend_on_node_chunk(deep_ds):
    from repro_torch.core.types import BuildConfig, IndexConfig
    x = deep_ds.base[:1000]
    cfg = IndexConfig(dim=96, metric="ip", build=BuildConfig(
        M=12, knn_k=16, builder="nn_descent", nn_descent_rounds=2,
        refine_cands=32, search_L=24))
    a = KBest(cfg, device="cpu", node_chunk=512).add(x)
    b = KBest(cfg, device="cpu", node_chunk=97).add(x)
    assert a.entry == b.entry
    assert np.array_equal(a.order, b.order)
    assert torch.equal(a.graph, b.graph)


def test_save_load_round_trips_both_ways(bigann_index, bigann_ds, tmp_path):
    s = dataclasses.replace(bigann_index.config.search, dist_impl="ref")
    _, want = bigann_index.search(bigann_ds.queries, search_cfg=s)
    # reference save -> port load
    bigann_index.save(str(tmp_path / "ref.graph"))
    port = KBest.load(str(tmp_path / "ref.graph"), device="cpu")
    _, got = port.search(bigann_ds.queries, search_cfg=s)
    assert np.array_equal(got.numpy(), np.asarray(want))
    # port save -> reference load: same arrays, checksums and config
    port.save(str(tmp_path / "port.graph"))
    back = RefKBest.load(str(tmp_path / "port.graph"))
    assert back.entry == bigann_index.entry
    assert back.config == bigann_index.config
    assert np.array_equal(np.asarray(back.graph),
                          np.asarray(bigann_index.graph))
    assert np.array_equal(back.order, bigann_index.order)
    _, again = back.search(bigann_ds.queries, search_cfg=s)
    assert np.array_equal(np.asarray(again), np.asarray(want))
    # and the port reads its own save back
    port2 = KBest.load(str(tmp_path / "port.graph"), device="cpu")
    assert torch.equal(port2.graph, port.graph)


def test_load_rejects_corrupt_save(bigann_index, tmp_path):
    from repro_torch.core.persist import IndexCorruptError
    bigann_index.save(str(tmp_path / "a.graph"))
    npz = tmp_path / "a.graph.npz"
    raw = bytearray(npz.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    npz.write_bytes(bytes(raw))
    with pytest.raises(IndexCorruptError):
        KBest.load(str(tmp_path / "a.graph"), device="cpu")


def test_config_from_dict_warns_on_unknown_keys():
    from repro_torch.core.index import _config_from_dict
    from repro_torch.core.types import IndexConfig
    d = dataclasses.asdict(IndexConfig(dim=8))
    d["search"]["future_knob"] = 3
    with pytest.warns(UserWarning, match="future_knob"):
        cfg = _config_from_dict(d)
    assert cfg == IndexConfig(dim=8)
