"""The port's quantized graph search (kinds "sq" and "pq") against the
JAX package's, on reference-built state.

The reference's conftest graph (deep_like, n=2,000, 40 queries) gets each
quantizer attached the way the reference's tuner does it (a clone sharing
db, graph, entry and order, then `_train_quant`). The port takes the whole
state, codes and codebooks included, over through both routes —
`convert.from_reference_arrays` and `KBest.load` of a reference save — and
must return the same ids and all four SearchStats fields (n_dist counting
the exact re-rank) for W ∈ {1, 4} × dist_impl ∈ {ref, kernel}. Distances
agree to the kernels' tolerance (rtol=3e-5, atol=3e-4). On CPU the port's
"kernel" path runs the kernels' plain versions, the reference's runs its
Pallas kernels in interpret mode.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.core import quantize as jqz
from repro.core.index import KBest as RefKBest
from repro.core.types import QuantConfig as RefQuantConfig
from repro.data.vectors import recall_at_k
from repro_torch.core import quantize as tqz
from repro_torch.core import search as search_mod
from repro_torch.core.convert import from_reference_arrays
from repro_torch.core.index import QUANT_ARRAYS, KBest

# parallel test workers share the cores: one torch thread each keeps the
# many small eager ops from oversubscribing them
torch.set_num_threads(1)

TOL = dict(rtol=3e-5, atol=3e-4)
QUANTS = {"sq": dict(kind="sq"),
          "pq": dict(kind="pq", pq_m=16, kmeans_iters=4)}


def _ref_quant(base, kind):
    """The reference index `base` with quantizer `kind` attached."""
    cfg = dataclasses.replace(base.config,
                              quant=RefQuantConfig(**QUANTS[kind]))
    ref = RefKBest(cfg)
    ref.db, ref.graph, ref.entry, ref.order = (base.db, base.graph,
                                               base.entry, base.order)
    ref._train_quant(ref.db)
    return ref


def _arrays(ref):
    out = {"db": ref.db, "graph": ref.graph, "order": ref.order}
    if ref.pq is not None:
        out.update(pq_codebooks=ref.pq.codebooks, pq_codes=ref.pq_codes)
    if ref.sq is not None:
        out.update(sq_scale=ref.sq.scale, sq_zero=ref.sq.zero,
                   sq_codes=ref.sq_codes)
    return {k: None if v is None else np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def refs(deep_index):
    return {kind: _ref_quant(deep_index, kind) for kind in QUANTS}


@pytest.fixture(scope="module")
def ports(refs):
    return {kind: from_reference_arrays(_arrays(r), r.entry,
                                        dataclasses.asdict(r.config), "cpu")
            for kind, r in refs.items()}


def _same(ref_out, port_out):
    (d0, i0, s0), (d1, i1, s1) = ref_out, port_out
    assert np.array_equal(np.asarray(i0), i1.numpy())
    np.testing.assert_allclose(d1.numpy(), np.asarray(d0), **TOL)
    for name in ("n_hops", "n_dist", "early_terminated", "iters"):
        assert np.array_equal(np.asarray(getattr(s0, name)),
                              getattr(s1, name).numpy()), name


def _scfg(base, W, impl, **kw):
    return dataclasses.replace(base, beam_width=W, dist_impl=impl,
                               early_term=True, et_patience=8, **kw)


def _queries(ds, impl):
    """The reference runs its Pallas kernels in interpret mode, one grid
    step per (query, candidate): kernel cases take 8 of the 40 queries."""
    return ds.queries[:8] if impl == "kernel" else ds.queries


@pytest.mark.parametrize("impl", ["ref", "kernel"])
@pytest.mark.parametrize("W", [1, 4])
@pytest.mark.parametrize("kind", ["sq", "pq"])
def test_search_matches_reference(refs, ports, deep_ds, kind, W, impl):
    ref, port = refs[kind], ports[kind]
    s = _scfg(ref.config.search, W, impl)
    q = _queries(deep_ds, impl)
    _same(ref.search(q, search_cfg=s, with_stats=True),
          port.search(q, search_cfg=s, with_stats=True))


@pytest.mark.parametrize("kind", ["sq", "pq"])
def test_n_dist_counts_the_rerank(ports, deep_ds, kind):
    """n_dist = the first pass's distances + the exact re-rank's 4k."""
    port = ports[kind]
    s = _scfg(port.config.search, 4, "ref")
    q = torch.as_tensor(deep_ds.queries)
    wide = dataclasses.replace(s, L=max(s.L, 4 * s.k), k=max(s.L, 4 * s.k))
    operand = (tqz.pq_query_tables(port.pq.codebooks, q, "ip")
               if kind == "pq" else q)
    _, ids, first = search_mod.search(
        port.graph, operand, port._entry_ids(s.n_entries, 2000),
        dist_fn=port._get_dist_fn(kind, "ref"), cfg=wide, n_total=2000)
    _, _, st = port.search(deep_ds.queries, search_cfg=s, with_stats=True)
    n_exact = (ids[:, :4 * s.k] >= 0).sum(1)
    assert torch.equal(st.n_dist, first.n_dist + n_exact)
    assert int(n_exact.min()) == 4 * s.k


@pytest.mark.parametrize("kind", ["sq", "pq"])
def test_load_of_reference_save_equals_convert(refs, ports, deep_ds, kind,
                                               tmp_path):
    ref, port = refs[kind], ports[kind]
    ref.save(str(tmp_path / f"{kind}.graph"))
    loaded = KBest.load(str(tmp_path / f"{kind}.graph"), device="cpu")
    assert loaded.config == port.config and loaded.entry == port.entry
    for name in ("db", "graph", "pq_codes", "sq_codes"):
        a, b = getattr(loaded, name), getattr(port, name)
        assert (a is None and b is None) or torch.equal(a, b), name
    s = _scfg(ref.config.search, 4, "ref")
    _same(ref.search(deep_ds.queries, search_cfg=s, with_stats=True),
          loaded.search(deep_ds.queries, search_cfg=s, with_stats=True))


@pytest.mark.parametrize("kind", ["sq", "pq"])
def test_port_save_loads_in_reference(refs, ports, deep_ds, kind, tmp_path):
    """Format 2 both ways: the port's save, read by the reference, and
    read back by the port, answers as the reference index does."""
    ref, port = refs[kind], ports[kind]
    port.save(str(tmp_path / f"{kind}.graph"))
    back = RefKBest.load(str(tmp_path / f"{kind}.graph"))
    again = KBest.load(str(tmp_path / f"{kind}.graph"), device="cpu")
    names = {"sq": ("sq_codes",), "pq": ("pq_codes",)}[kind]
    for name in names:
        assert np.array_equal(np.asarray(getattr(back, name)),
                              np.asarray(getattr(ref, name)))
    s = _scfg(ref.config.search, 1, "ref")
    exp = ref.search(deep_ds.queries, search_cfg=s, with_stats=True)
    _same(exp, again.search(deep_ds.queries, search_cfg=s, with_stats=True))
    _, i = back.search(deep_ds.queries, search_cfg=s)
    assert np.array_equal(np.asarray(i), np.asarray(exp[1]))


@pytest.mark.parametrize("kind", ["sq", "pq"])
def test_search_padded_matches_reference(refs, ports, deep_ds, kind):
    ref, port = refs[kind], ports[kind]
    vm = np.ones(len(deep_ds.queries), bool)
    vm[::3] = False
    s = _scfg(ref.config.search, 4, "ref")
    out = port.search_padded(deep_ds.queries, vm, search_cfg=s,
                             with_stats=True)
    _same(ref.search_padded(deep_ds.queries, vm, search_cfg=s,
                            with_stats=True), out)
    d, i, st = out
    inv = ~torch.as_tensor(vm)
    assert torch.isinf(d[inv]).all() and (i[inv] == -1).all()
    assert int(st.n_dist[inv].sum()) == 0
    _, i2 = port.search(deep_ds.queries[vm], search_cfg=s)
    assert torch.equal(i[~inv], i2)


@pytest.mark.parametrize("kind,k", [("sq", 5), ("pq", 20)])
def test_k_override_matches_reference(refs, ports, deep_ds, kind, k):
    d0, i0 = refs[kind].search(deep_ds.queries, k=k)
    d1, i1 = ports[kind].search(deep_ds.queries, k=k)
    assert i1.shape == (len(deep_ds.queries), k)
    assert np.array_equal(np.asarray(i0), i1.numpy())
    np.testing.assert_allclose(d1.numpy(), np.asarray(d0), **TOL)


@pytest.mark.parametrize("kind", ["sq", "pq"])
def test_port_built_index_recall(refs, deep_ds, kind):
    """add() in the port with the quantizer configured: the graph is the
    port's own build and PQ's k-means starts from the port's seeded draw,
    so the index is compared by recall at equal config."""
    ref = refs[kind]
    port = KBest(ref.config, device="cpu").add(deep_ds.base)
    assert "train_quant" in port.build_times
    assert tqz.code_bytes_per_vector(port) == jqz.code_bytes_per_vector(ref)
    s = _scfg(ref.config.search, 4, "ref")
    _, i0 = ref.search(deep_ds.queries, search_cfg=s)
    _, i1 = port.search(deep_ds.queries, search_cfg=s)
    r0 = recall_at_k(np.asarray(i0), deep_ds.gt_ids, 10)
    r1 = recall_at_k(i1.numpy(), deep_ds.gt_ids, 10)
    assert abs(r0 - r1) <= 0.005, (r0, r1)


def test_quant_arrays_are_the_reference_sidecars(refs, tmp_path):
    """Every quantizer array a reference sq/pq save holds is one the port
    loads, and nothing else."""
    names = set()
    for kind, ref in refs.items():
        ref.save(str(tmp_path / kind))
        names |= set(np.load(str(tmp_path / f"{kind}.npz")).files)
    assert names - {"db", "graph", "order"} == set(QUANT_ARRAYS)
