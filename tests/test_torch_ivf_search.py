"""The port's IVF index (KBest with index_type="ivf") against the JAX
package's, on reference-built state.

The reference builds each IVF index over the conftest's sets (deep_like,
ip, d=96, and bigann_like, l2, d=128; n=2,000, 40 queries; nlist=16,
list_pad=8): 8-bit PQ with residual codes under ip (the centroid bias
added after the per-list top-L) and under l2 (a table per probe), raw
codes under l2, PQ4 under ip, PQ4 with u8 tables under l2, bin under ip
(re-rank of its rescore_factor * k overfetch) and PQ with a set
`QuantConfig.rerank`. The port takes the whole state over through both
routes — `convert.from_reference_arrays` and `KBest.load` of a reference
save — and must return the same ids (tie-aware: tests/
test_torch_parity.py) and all four SearchStats fields (n_hops the lists
probed, n_dist the codes scanned plus the exact
re-rank, no early termination, iters 0) for dist_impl in {ref, kernel};
distances agree to the kernels' tolerance (rtol=3e-5, atol=3e-4). On the
CPU the port's "kernel" path runs the kernels' plain versions, the
reference's its Pallas kernels in interpret mode (8 queries).

u8 tables: the port's tables (torch's einsum) and the reference's (XLA's
dot) differ in the last bit, which the requantization can turn into a
step and then into differently broken exact ties (ROADMAP Faults). The
u8 parity cases hand the reference's tables in; with the port's own the
ids agree on at least 99.5% of (query, rank).
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import kbest as jpresets
from repro.core import quantize as jqz
from repro.core.index import KBest as RefKBest
from repro.core.types import IndexConfig as RefIndexConfig
from repro.core.types import IVFConfig as RefIVFConfig
from repro.core.types import QuantConfig as RefQuantConfig
from repro.core.types import SearchConfig as RefSearchConfig
from repro.data.vectors import recall_at_k
from repro_torch.configs import kbest as tpresets
from repro_torch.core import ivf as tivf
from repro_torch.core import quantize as tqz
from repro_torch.core.convert import from_reference_arrays
from repro_torch.core.index import IVF_ARRAYS, KBest
from test_torch_parity import assert_same_ranking
from torch_reference_cache import jax_maps_below_limit  # noqa: F401

# parallel test workers share the cores: one torch thread each keeps the
# many small eager ops from oversubscribing them
torch.set_num_threads(1)

# name: (dataset fixture, QuantConfig kwargs, residual, SearchConfig kwargs)
CASES = {
    "pq-ip": ("deep_ds", dict(kind="pq", pq_m=16), True, {}),
    "pq-l2": ("bigann_ds", dict(kind="pq", pq_m=16), True, {}),
    "pq-l2-raw": ("bigann_ds", dict(kind="pq", pq_m=16), False, {}),
    "pq4-ip": ("deep_ds", dict(kind="pq4", pq_m=16), True, {}),
    "pq4u8-l2": ("bigann_ds", dict(kind="pq4", pq_m=16, pq4_lut_u8=True),
                 True, {}),
    "bin-ip": ("deep_ds", dict(kind="bin"), True,
               dict(L=128, rescore_factor=8)),
    "pq-ip-rerank": ("deep_ds", dict(kind="pq", pq_m=16, rerank=20), True,
                     {}),
}


def _config(ds, quant, residual, search):
    return RefIndexConfig(
        dim=ds.base.shape[1], metric=ds.metric, index_type="ivf",
        ivf=RefIVFConfig(nlist=16, kmeans_iters=4, list_pad=8,
                         residual=residual),
        quant=RefQuantConfig(kmeans_iters=4, **quant),
        search=RefSearchConfig(**{"L": 64, "k": 10, "nprobe": 6, **search}))


def _arrays(ref):
    ivf = ref.ivf
    out = {"db": ref.db, "ivf_centroids": ivf.centroids,
           "ivf_list_ids": ivf.list_ids, "ivf_list_codes": ivf.list_codes}
    if ivf.pq is not None:
        out["ivf_codebooks"] = ivf.pq.codebooks
    if ivf.bin is not None:
        out["ivf_bin_rot"] = ivf.bin.rot
    return {k: np.asarray(v) for k, v in out.items()}


@pytest.fixture(scope="module")
def built(request):
    """name -> (reference index, its port by from_reference_arrays, ds)."""
    out = {}
    for name, (fx, quant, residual, search) in CASES.items():
        ds = request.getfixturevalue(fx)
        ref = RefKBest(_config(ds, quant, residual, search)).add(ds.base)
        port = from_reference_arrays(_arrays(ref), ref.entry,
                                     dataclasses.asdict(ref.config), "cpu")
        out[name] = (ref, port, ds)
    return out


def _hand_ref_tables(monkeypatch, ref):
    """For u8-requantized tables, make the port scan with the reference's
    (module docstring)."""
    if not ref.config.quant.pq4_lut_u8:
        return

    def tables(books, q, metric):
        return torch.as_tensor(np.array(jqz.pq_query_tables(
            jnp.asarray(books.numpy()), jnp.asarray(q.numpy()), metric)))
    monkeypatch.setattr(tqz, "pq_query_tables", tables)


def _same(ref_out, port_out):
    (d0, i0, s0), (d1, i1, s1) = ref_out, port_out
    assert_same_ranking(d1.numpy(), i1.numpy(), d0, i0)
    for name in ("n_hops", "n_dist", "early_terminated", "iters"):
        assert np.array_equal(np.asarray(getattr(s0, name)),
                              getattr(s1, name).numpy()), name


@pytest.mark.parametrize("impl", ["ref", "kernel"])
@pytest.mark.parametrize("name", list(CASES))
def test_search_matches_reference(built, name, impl, monkeypatch):
    ref, port, ds = built[name]
    _hand_ref_tables(monkeypatch, ref)
    s = dataclasses.replace(ref.config.search, dist_impl=impl)
    q = ds.queries[:8] if impl == "kernel" else ds.queries
    _same(ref.search(q, search_cfg=s, with_stats=True),
          port.search(q, search_cfg=s, with_stats=True))


def test_stats_count_the_scan_and_the_rerank(built):
    """n_dist = valid codes of the probed lists + the exact distances of
    the re-rank (the whole queue, rerank, or the bin overfetch)."""
    for name in ("pq-ip", "pq-ip-rerank", "bin-ip"):
        _, port, ds = built[name]
        s = port.config.search
        _, _, st = port.search(ds.queries, search_cfg=s, with_stats=True)
        n_valid = (port.ivf.list_ids >= 0).sum(1)
        probes = tivf.select_probes(port.ivf, torch.as_tensor(ds.queries),
                                    s.nprobe, ds.metric)
        scanned = n_valid[probes.long()].sum(1)
        depth = {"pq-ip": max(s.L, 4 * s.k), "pq-ip-rerank": 20,
                 "bin-ip": s.rescore_factor * s.k}[name]
        assert torch.equal(st.n_dist, (scanned + depth).to(torch.int32))
        assert bool((st.n_hops == s.nprobe).all())


@pytest.mark.parametrize("name", list(CASES))
def test_load_of_reference_save_equals_convert(built, name, tmp_path,
                                               monkeypatch):
    ref, port, ds = built[name]
    _hand_ref_tables(monkeypatch, ref)
    ref.save(str(tmp_path / "idx.ivf"))
    saved = set(np.load(str(tmp_path / "idx.ivf.npz")).files)
    assert saved - {"db"} <= set(IVF_ARRAYS)
    loaded = KBest.load(str(tmp_path / "idx.ivf"), device="cpu")
    assert loaded.config == port.config and loaded.graph is None
    for attr in ("centroids", "list_ids", "list_codes"):
        assert torch.equal(getattr(loaded.ivf, attr),
                           getattr(port.ivf, attr)), attr
    assert (loaded.ivf.packed, loaded.ivf.residual) == (
        port.ivf.packed, port.ivf.residual)
    _same(ref.search(ds.queries, with_stats=True),
          loaded.search(ds.queries, with_stats=True))


@pytest.fixture(scope="module")
def port_built(built):
    """The port's own add() (its seeded draws) for pq, pq4 and bin."""
    return {name: KBest(built[name][0].config, device="cpu").add(
        built[name][2].base) for name in ("pq-l2", "pq4-ip", "bin-ip")}


@pytest.mark.parametrize("name", ["pq-l2", "pq4-ip", "bin-ip"])
def test_port_save_loads_in_reference(built, port_built, name, tmp_path):
    """Format 2 both ways: a port-built index, saved, is read by the
    reference (bin words as its uint32) and searches identically there,
    and reads back into the port unchanged."""
    port, ds = port_built[name], built[name][2]
    port.save(str(tmp_path / "idx.ivf"))
    back = RefKBest.load(str(tmp_path / "idx.ivf"))
    again = KBest.load(str(tmp_path / "idx.ivf"), device="cpu")
    exp = np.asarray(port.ivf.list_codes)
    got = np.asarray(back.ivf.list_codes)
    if name == "bin-ip":
        assert got.dtype == np.uint32
        exp = exp.view(np.uint32)
    assert np.array_equal(got, exp)
    out = port.search(ds.queries, with_stats=True)
    _same(back.search(ds.queries, with_stats=True), out)
    _same(out, again.search(ds.queries, with_stats=True))


@pytest.mark.parametrize("name", ["pq-l2", "pq4-ip", "bin-ip"])
def test_port_built_index_recall(built, port_built, name):
    """The port's own build (its k-means starts and rotation are its
    seeded draws) against the reference's at equal config, by recall. The
    bar is the draws' own spread: the reference alone, over seeds 0-4 of
    the same configs, spans 0.9525-0.99 (pq-l2), 0.8025-0.85 (pq4-ip) and
    0.7775-0.8175 (bin-ip) on these 40 queries."""
    ref, _, ds = built[name]
    port = port_built[name]
    assert set(port.build_times) >= {"coarse_kmeans", "assign",
                                     "train_encode", "lists"}
    _, i0 = ref.search(ds.queries)
    _, i1 = port.search(ds.queries)
    r0 = recall_at_k(np.asarray(i0), ds.gt_ids, 10)
    r1 = recall_at_k(i1.numpy(), ds.gt_ids, 10)
    assert abs(r0 - r1) <= 0.05, (r0, r1)


@pytest.mark.parametrize("name", ["pq-ip", "pq4u8-l2", "bin-ip"])
def test_search_padded_matches_reference(built, name, monkeypatch):
    ref, port, ds = built[name]
    _hand_ref_tables(monkeypatch, ref)
    vm = np.ones(len(ds.queries), bool)
    vm[::3] = False
    out = port.search_padded(ds.queries, vm, with_stats=True)
    _same(ref.search_padded(ds.queries, vm, with_stats=True), out)
    d, i, st = out
    inv = ~torch.as_tensor(vm)
    assert torch.isinf(d[inv]).all() and (i[inv] == -1).all()
    assert int(st.n_dist[inv].sum()) == 0 and int(st.n_hops[inv].sum()) == 0
    _, i2 = port.search(ds.queries[vm])
    assert torch.equal(i[~inv], i2)


def test_u8lut_with_the_ports_own_tables(built):
    ref, port, ds = built["pq4u8-l2"]
    _, i0 = ref.search(ds.queries)
    d1, i1 = port.search(ds.queries)
    same = float(np.mean(np.asarray(i0) == i1.numpy()))
    assert same >= 0.995, same
    assert torch.isfinite(d1).all()


@pytest.mark.parametrize("name,want", [("pq-ip", 16), ("pq4-ip", 8),
                                       ("bin-ip", 12)])
def test_code_bytes_per_vector(built, name, want):
    ref, port, _ = built[name]
    assert tqz.code_bytes_per_vector(port) == want
    assert jqz.code_bytes_per_vector(ref) == want


def test_presets_match_reference():
    for ds in tpresets.SHAPES:
        for fn in ("ivf_index_config", "ivf_pq4_index_config",
                   "ivf_bin_index_config"):
            assert dataclasses.asdict(getattr(tpresets, fn)(ds)) == \
                dataclasses.asdict(getattr(jpresets, fn)(ds)), (fn, ds)
    assert dataclasses.asdict(tpresets.ivf_smoke_config()) == \
        dataclasses.asdict(jpresets.ivf_smoke_config())


@pytest.mark.parametrize("kind", ["none", "sq"])
def test_other_kinds_take_the_pq_branch(kind):
    """As in the reference, an IVF index of kind "none" or "sq" holds
    8-bit PQ lists; both packages answer the same on them."""
    x = np.random.default_rng(4).normal(size=(600, 32)).astype(np.float32)
    ref = RefKBest(RefIndexConfig(
        dim=32, metric="l2", index_type="ivf",
        ivf=RefIVFConfig(nlist=8, kmeans_iters=4, list_pad=8),
        quant=RefQuantConfig(kind=kind, pq_m=8, kmeans_iters=3),
        search=RefSearchConfig(L=16, k=5, nprobe=4))).add(x)
    port = from_reference_arrays(_arrays(ref), 0,
                                 dataclasses.asdict(ref.config), "cpu")
    assert port.ivf.pq.ksub == 256 and port.ivf.list_codes.shape[-1] == 8
    _same(ref.search(x[:10], with_stats=True),
          port.search(x[:10], with_stats=True))
    built = KBest(port.config, device="cpu").add(x)
    assert built.ivf.pq.ksub == 256 and not built.ivf.packed
