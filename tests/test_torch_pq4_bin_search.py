"""The port's pq4 and bin graph search against the JAX package's, on
reference-built state.

The reference's conftest graph (deep_like, n=2,000, 40 queries) gets each
quantizer attached the way the reference's tuner does it (a clone sharing
db, graph, entry and order, then `_train_quant`): `pq4` and `pq4+u8lut`
(pq_m=16, 16 centroids a subspace, 8 B/vector) and `bin` (96 sign bits,
12 B/vector, re-rank of its rescore_factor * k = 80 overfetch, which
widens the queue past L=64). The port takes the whole state, codes,
codebooks and rotation included, over through both routes —
`convert.from_reference_arrays` and `KBest.load` of a reference save —
and must return the same ids (tie-aware: tests/test_torch_parity.py)
and all four SearchStats fields (n_dist counting the exact re-rank) for
W ∈ {1, 4} × dist_impl ∈ {ref, kernel}.
Distances agree to the kernels' tolerance (rtol=3e-5, atol=3e-4). On CPU
the port's "kernel" path runs the kernels' plain versions, the
reference's runs its Pallas kernels in interpret mode. The bin search
walks with the port's own query codes, so they are first held equal to
the reference's.

`pq4+u8lut` walks the reference's query tables, handed in: the port's
tables (torch's einsum) and the reference's (XLA's dot, whose order of
summing the 6-term products depends on the shape) differ in the last
bit, within tolerance (tests/test_torch_pq4_bin.py); the u8
requantization turns such a bit into a shifted step of a whole table and
then into exact ties of sums, broken one way or the other. Given equal
tables the requantization, the ADC sums (in order j = 0 .. m-1, as the
reference sums) and the searches are equal; with the port's own tables
the ids agree on at least 99.5% of (query, rank), the bar the kernels
are held to against their plain versions on the card.
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
from repro_torch.core.index import KBest
from repro_torch.core.types import SearchConfig
from test_torch_parity import assert_same_ranking
from torch_reference_cache import jax_maps_below_limit  # noqa: F401

# parallel test workers share the cores: one torch thread each keeps the
# many small eager ops from oversubscribing them
torch.set_num_threads(1)

QUANTS = {"pq4": dict(kind="pq4", pq_m=16, kmeans_iters=4),
          "pq4+u8lut": dict(kind="pq4", pq_m=16, kmeans_iters=4,
                            pq4_lut_u8=True),
          "bin": dict(kind="bin")}


def _ref_quant(base, name):
    """The reference index `base` with quantizer `name` attached."""
    cfg = dataclasses.replace(base.config,
                              quant=RefQuantConfig(**QUANTS[name]))
    ref = RefKBest(cfg)
    ref.db, ref.graph, ref.entry, ref.order = (base.db, base.graph,
                                               base.entry, base.order)
    ref._train_quant(ref.db)
    return ref


def _arrays(ref):
    out = {"db": ref.db, "graph": ref.graph, "order": ref.order}
    if ref.pq is not None:
        out.update(pq_codebooks=ref.pq.codebooks, pq_codes=ref.pq_codes)
    if ref.bin is not None:
        out.update(bin_rot=ref.bin.rot, bin_codes=ref.bin_codes)
    return {k: None if v is None else np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def refs(deep_index):
    return {name: _ref_quant(deep_index, name) for name in QUANTS}


@pytest.fixture(scope="module")
def ports(refs):
    return {name: from_reference_arrays(_arrays(r), r.entry,
                                        dataclasses.asdict(r.config), "cpu")
            for name, r in refs.items()}


def _hand_ref_tables(monkeypatch, ref):
    """For u8-requantized tables, make the port walk the reference's
    (module docstring)."""
    if not ref.config.quant.pq4_lut_u8:
        return
    books = ref.pq.codebooks

    def tables(_books, q, metric, lut_u8=False):
        return torch.as_tensor(np.array(jqz.pq4_query_tables(
            books, q.numpy(), metric, lut_u8=lut_u8)))
    monkeypatch.setattr(tqz, "pq4_query_tables", tables)


def _same(ref_out, port_out):
    (d0, i0, s0), (d1, i1, s1) = ref_out, port_out
    assert_same_ranking(d1.numpy(), i1.numpy(), d0, i0)
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


def test_bin_query_codes_match_reference(refs, ports, deep_ds):
    """The bin traversal walks with each package's own query codes: on
    the shared rotation they must agree bit for bit (0 differ)."""
    q = deep_ds.queries
    out = tqz.bin_query_codes(ports["bin"].bin, torch.as_tensor(q)).numpy()
    exp = np.asarray(jqz.bin_query_codes(refs["bin"].bin, q))
    n_diff = int(np.sum(tqz.unpack_signs(torch.as_tensor(out), 96).numpy()
                        != np.asarray(jqz.unpack_signs(exp, 96))))
    assert n_diff == 0, f"{n_diff} query sign bits differ"
    assert np.array_equal(out.view(np.uint32), exp)


@pytest.mark.parametrize("impl", ["ref", "kernel"])
@pytest.mark.parametrize("W", [1, 4])
@pytest.mark.parametrize("name", list(QUANTS))
def test_search_matches_reference(refs, ports, deep_ds, name, W, impl,
                                  monkeypatch):
    ref, port = refs[name], ports[name]
    _hand_ref_tables(monkeypatch, ref)
    s = _scfg(ref.config.search, W, impl)
    q = _queries(deep_ds, impl)
    _same(ref.search(q, search_cfg=s, with_stats=True),
          port.search(q, search_cfg=s, with_stats=True))


def test_bin_n_dist_counts_the_rescore(ports, deep_ds):
    """n_dist = the Hamming pass's distances + the exact re-rank of the
    rescore_factor * k overfetch, through a queue widened to hold it."""
    port = ports["bin"]
    s = _scfg(port.config.search, 4, "ref")
    want = s.rescore_factor * s.k
    assert want > s.L                       # the queue must widen
    q = torch.as_tensor(deep_ds.queries)
    wide = dataclasses.replace(s, L=want, k=want)
    _, ids, first = search_mod.search(
        port.graph, tqz.bin_query_codes(port.bin, q),
        port._entry_ids(s.n_entries, 2000),
        dist_fn=port._get_dist_fn("bin", "ref"), cfg=wide, n_total=2000)
    _, _, st = port.search(deep_ds.queries, search_cfg=s, with_stats=True)
    n_exact = (ids >= 0).sum(1)
    assert ids.shape[1] == want
    assert torch.equal(st.n_dist, first.n_dist + n_exact)


@pytest.mark.parametrize("name", list(QUANTS))
def test_load_of_reference_save_equals_convert(refs, ports, deep_ds, name,
                                               tmp_path, monkeypatch):
    ref, port = refs[name], ports[name]
    _hand_ref_tables(monkeypatch, ref)
    ref.save(str(tmp_path / "idx.graph"))
    loaded = KBest.load(str(tmp_path / "idx.graph"), device="cpu")
    assert loaded.config == port.config and loaded.entry == port.entry
    for attr in ("db", "graph", "pq_codes", "bin_codes"):
        a, b = getattr(loaded, attr), getattr(port, attr)
        assert (a is None and b is None) or torch.equal(a, b), attr
    s = _scfg(ref.config.search, 4, "ref")
    _same(ref.search(deep_ds.queries, search_cfg=s, with_stats=True),
          loaded.search(deep_ds.queries, search_cfg=s, with_stats=True))


@pytest.mark.parametrize("name", list(QUANTS))
def test_port_save_loads_in_reference(refs, ports, deep_ds, name, tmp_path,
                                      monkeypatch):
    """Format 2 both ways: the port's save, read by the reference (bin
    codes as its uint32 words), and read back by the port, answers as the
    reference index does."""
    ref, port = refs[name], ports[name]
    _hand_ref_tables(monkeypatch, ref)
    port.save(str(tmp_path / "idx.graph"))
    back = RefKBest.load(str(tmp_path / "idx.graph"))
    again = KBest.load(str(tmp_path / "idx.graph"), device="cpu")
    attr = "bin_codes" if name == "bin" else "pq_codes"
    a, b = np.asarray(getattr(back, attr)), np.asarray(getattr(ref, attr))
    assert a.dtype == b.dtype and np.array_equal(a, b)
    s = _scfg(ref.config.search, 1, "ref")
    exp = ref.search(deep_ds.queries, search_cfg=s, with_stats=True)
    _same(exp, again.search(deep_ds.queries, search_cfg=s, with_stats=True))
    _, i = back.search(deep_ds.queries, search_cfg=s)
    assert np.array_equal(np.asarray(i), np.asarray(exp[1]))


@pytest.mark.parametrize("name", list(QUANTS))
def test_search_padded_matches_reference(refs, ports, deep_ds, name,
                                         monkeypatch):
    ref, port = refs[name], ports[name]
    _hand_ref_tables(monkeypatch, ref)
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


@pytest.mark.parametrize("W", [1, 4])
def test_u8lut_with_the_ports_own_tables(refs, ports, deep_ds, W):
    ref, port = refs["pq4+u8lut"], ports["pq4+u8lut"]
    s = _scfg(ref.config.search, W, "ref")
    _, i0 = ref.search(deep_ds.queries, search_cfg=s)
    d1, i1 = port.search(deep_ds.queries, search_cfg=s)
    same = float(np.mean(np.asarray(i0) == i1.numpy()))
    assert same >= 0.995, same
    assert torch.isfinite(d1).all()


@pytest.mark.parametrize("name,want", [("pq4", 8), ("pq4+u8lut", 8),
                                       ("bin", 12)])
def test_code_bytes_per_vector(refs, ports, name, want):
    assert tqz.code_bytes_per_vector(ports[name]) == want
    assert jqz.code_bytes_per_vector(refs[name]) == want


def test_rescore_factor_zero_raises():
    with pytest.raises(AssertionError):
        SearchConfig(rescore_factor=0)


@pytest.fixture(scope="module")
def port_built(refs, deep_ds):
    """The port's own add() with pq4 configured; bin attached to the same
    port-built graph with _train_quant."""
    pq4 = KBest(refs["pq4"].config, device="cpu").add(deep_ds.base)
    b = KBest(refs["bin"].config, device="cpu")
    b._set_state(pq4.db, pq4.graph, pq4.entry, pq4.order)
    b._train_quant(b.db)
    return {"pq4": pq4, "bin": b}


@pytest.mark.parametrize("name", ["pq4", "bin"])
def test_port_built_index_recall(refs, port_built, deep_ds, name):
    """The graph is the port's own build, and PQ4's k-means start and the
    bin rotation are the port's seeded draws, so the index is compared by
    recall at equal config."""
    ref, port = refs[name], port_built[name]
    assert "train_quant" in port_built["pq4"].build_times
    assert tqz.code_bytes_per_vector(port) == jqz.code_bytes_per_vector(ref)
    s = _scfg(ref.config.search, 4, "ref")
    _, i0 = ref.search(deep_ds.queries, search_cfg=s)
    _, i1 = port.search(deep_ds.queries, search_cfg=s)
    r0 = recall_at_k(np.asarray(i0), deep_ds.gt_ids, 10)
    r1 = recall_at_k(i1.numpy(), deep_ds.gt_ids, 10)
    assert abs(r0 - r1) <= 0.02, (r0, r1)
