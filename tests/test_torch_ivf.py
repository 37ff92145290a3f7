"""The port's IVF list scans and core/ivf.py against the JAX package's.

Both packages get the same seeded numpy inputs. The plain versions of the
three list scans (`ivf_scan`, `pq4_ivf_scan`, `bin_ivf_scan`) are held
against the reference's jnp oracles and its Pallas kernels in interpret
mode (through `repro.kernels.ops`, which never rounds L up on the CPU),
on ragged lists with -1 holes, lists that are all padding, tables per
probe (Pl = P) and per query (Pl = 1), L in {1, 7, max_len}, and tie
storms (codes of two values, Hamming distances). Tolerance: f32 distances
rtol=3e-5 / atol=3e-4, the reference's own (tests/test_kernels.py); ids,
Hamming distances and integer-valued sums exactly.

`build_ivf` takes the reference's own random draws (the coarse and the PQ
k-means starts, `jax.random.choice`, and the bin rotation's Gaussian,
`jax.random.normal`; torch cannot reproduce jax's bits). The bar for its
lists: the port's L2 assignment (torch's matmul) and the reference's
(XLA's dot) sum in other orders, so a row whose two nearest centroids are
within an ulp may land in the other list; on these inputs no row does,
and list ids, codes and codebooks are held equal (codebooks to TOL). The
search pieces (`select_probes`, `query_luts`, `scan_lists`,
`scan_bin_lists`, `scanned_counts`, `search_ivf`) run on the reference's
built state, carried over. The `cuda` test holds the three kernels to
their plain versions on the card and skips without one.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import ivf as jivf
from repro.core import quantize as jqz
from repro.core.types import IVFConfig as RefIVFConfig
from repro.core.types import QuantConfig as RefQuantConfig
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import ivf as tivf
from repro_torch.core import quantize as tqz
from repro_torch.core.types import IVFConfig, QuantConfig
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from torch_reference_cache import jax_maps_below_limit  # noqa: F401

# parallel test workers share the cores: one torch thread each keeps the
# many small eager ops from oversubscribing them
torch.set_num_threads(1)

TOL = dict(rtol=3e-5, atol=3e-4)


def _t(a):
    return torch.as_tensor(np.array(a))


def _words(a):
    """The reference's uint32 words as the port's int32 bit-views."""
    return _t(np.asarray(a, dtype=np.uint32).view(np.int32))


def _lists(r, nlist, max_len, n=10_000):
    """Ragged valid prefixes with -1 holes; list 0 is all padding and the
    last list is full."""
    ids = np.full((nlist, max_len), -1, np.int32)
    for c in range(1, nlist):
        n_valid = max_len if c == nlist - 1 else int(r.integers(0, max_len + 1))
        ids[c, :n_valid] = r.choice(n, size=n_valid, replace=False)
    ids[r.random((nlist, max_len)) < 0.1] = -1
    return ids


def _probes(r, Q, P, nlist):
    """Distinct lists per query; query 0 probes the empty list 0."""
    pr = np.stack([r.choice(nlist, size=P, replace=False) for _ in range(Q)])
    pr[0, 0] = 0
    return pr.astype(np.int32)


def _same(out, exps, exact=False):
    for exp in exps:
        exp = [np.asarray(a) for a in exp]
        if exact:
            assert np.array_equal(out[0], exp[0])
        else:
            np.testing.assert_allclose(out[0], exp[0], **TOL)
        assert np.array_equal(out[1], exp[1])


# --------------------------------------------------------------------------
# the list scans' plain versions
# --------------------------------------------------------------------------
SCAN = {"pq": (256, 8, jops.ivf_scan, jref.ivf_scan_ref, tops.ivf_scan),
        "pq4": (16, 16, jops.pq4_ivf_scan, jref.pq4_ivf_scan_ref,
                tops.pq4_ivf_scan)}


@pytest.mark.parametrize("L", [1, 7, "max_len"])
@pytest.mark.parametrize("per_probe", [False, True])
@pytest.mark.parametrize("kind", ["pq", "pq4"])
def test_scan_matches_reference(kind, per_probe, L):
    K, m, kern, oracle, port = SCAN[kind]
    Q, P, nlist, max_len = 3, 4, 7, 24
    r = np.random.default_rng(len(kind) * 10 + per_probe)
    L = max_len if L == "max_len" else L
    luts = r.normal(size=(Q, P if per_probe else 1, m, K)).astype(np.float32)
    width = m if K == 256 else m // 2
    codes = r.integers(0, 256, size=(nlist, max_len, width)).astype(np.uint8)
    ids, pr = _lists(r, nlist, max_len), _probes(r, Q, P, nlist)
    args = (luts, codes, ids, pr)
    out = [a.numpy() for a in port(*map(_t, args), L=L)]
    assert out[0].shape == (Q, P, L) and out[1].dtype == np.int32
    _same(out, [kern(*map(jnp.asarray, args), L=L),
                oracle(*map(jnp.asarray, args), L)])
    # ascending per list, -1 exactly where +inf; the empty list is all -1
    assert np.all(out[0][..., :-1] <= out[0][..., 1:])
    assert np.array_equal(out[1] >= 0, np.isfinite(out[0]))
    assert np.all(out[1][0, 0] == -1)


@pytest.mark.parametrize("L", [1, 7, "max_len"])
def test_bin_scan_matches_reference(L):
    Q, P, nlist, max_len, nw = 3, 4, 7, 24, 3
    r = np.random.default_rng(5)
    L = max_len if L == "max_len" else L
    qc = r.integers(0, 2 ** 32, size=(Q, nw), dtype=np.uint64).astype(np.uint32)
    codes = r.integers(0, 2 ** 32, size=(nlist, max_len, nw),
                       dtype=np.uint64).astype(np.uint32)
    ids, pr = _lists(r, nlist, max_len), _probes(r, Q, P, nlist)
    out = [a.numpy() for a in tops.bin_ivf_scan(
        _words(qc), _words(codes), _t(ids), _t(pr), L=L)]
    args = tuple(map(jnp.asarray, (qc, codes, ids, pr)))
    _same(out, [jops.bin_ivf_scan(*args, L=L),
                jref.bin_ivf_scan_ref(*args, L)], exact=True)


@pytest.mark.parametrize("kind", tqz.IVF_QUANT_KINDS)
def test_scan_tie_storms(kind):
    """Codes of two values and integer tables: most sums tie exactly, so
    the order within a list is the slot order; equal to the reference."""
    Q, P, nlist, max_len = 3, 4, 7, 40
    r = np.random.default_rng(9)
    ids, pr = _lists(r, nlist, max_len), _probes(r, Q, P, nlist)
    L = 17
    if kind == "bin":
        qc = r.integers(0, 2 ** 32, size=(Q, 3), dtype=np.uint64).astype(
            np.uint32)
        codes = np.where(r.random((nlist, max_len, 3)) < 0.5, 0,
                         0xFFFFFFFF).astype(np.uint32)
        out = [a.numpy() for a in tops.bin_ivf_scan(
            _words(qc), _words(codes), _t(ids), _t(pr), L=L)]
        args = tuple(map(jnp.asarray, (qc, codes, ids, pr)))
        exp = [jops.bin_ivf_scan(*args, L=L), jref.bin_ivf_scan_ref(*args, L)]
    else:
        K, m, kern, oracle, port = SCAN[kind]
        luts = r.integers(0, 3, size=(Q, P, m, K)).astype(np.float32)
        width = m if K == 256 else m // 2
        codes = (r.integers(0, 2, size=(nlist, max_len, width))
                 * 0x11).astype(np.uint8)
        args = (luts, codes, ids, pr)
        out = [a.numpy() for a in port(*map(_t, args), L=L)]
        exp = [kern(*map(jnp.asarray, args), L=L),
               oracle(*map(jnp.asarray, args), L)]
    _same(out, exp, exact=True)
    d = out[0]
    assert np.sum(d[..., 1:] == d[..., :-1]) > Q * P, "no tie storm"


@pytest.mark.parametrize("per_probe", [False, True])
@pytest.mark.parametrize("kind", sorted(SCAN))
def test_scan_signed_zero_tables(kind, per_probe):
    """Tables of small integers and ±0.0 whose entry 0 is -0.0 in every
    subspace, every third slot's codes all 0: those sums are +0.0, as
    jnp.sum and the CUDA kernel's sum from +0.0 give them, and tie with
    the other zero sums, so slot order decides; equal to the reference."""
    K, m, kern, oracle, port = SCAN[kind]
    Q, P, nlist, max_len, L = 3, 4, 7, 40, 23
    r = np.random.default_rng(11 + per_probe)
    luts = r.choice(np.array([-0.0, 0.0, -1.0, 1.0], np.float32),
                    size=(Q, P if per_probe else 1, m, K))
    luts[..., 0] = -0.0
    width = m if K == 256 else m // 2
    codes = r.integers(0, 256, size=(nlist, max_len, width)).astype(np.uint8)
    codes[:, ::3] = 0
    ids, pr = _lists(r, nlist, max_len), _probes(r, Q, P, nlist)
    args = (luts, codes, ids, pr)
    out = [a.numpy() for a in port(*map(_t, args), L=L)]
    _same(out, [kern(*map(jnp.asarray, args), L=L),
                oracle(*map(jnp.asarray, args), L)], exact=True)
    zero = out[0] == 0
    assert zero.sum() > Q * P and not np.signbit(out[0][zero]).any()


def test_plain_scans_chunk_over_queries(monkeypatch):
    """The plain versions' query chunks change nothing."""
    r = np.random.default_rng(3)
    Q, P, nlist, max_len = 9, 3, 6, 16
    luts = _t(r.normal(size=(Q, P, 8, 256)).astype(np.float32))
    codes = _t(r.integers(0, 256, size=(nlist, max_len, 8)).astype(np.uint8))
    ids, pr = _t(_lists(r, nlist, max_len)), _t(_probes(r, Q, P, nlist))
    whole = tref.ivf_scan_ref(luts, codes, ids, pr, 5)
    monkeypatch.setattr(tref, "_SCAN_ELEMS", 2 * P * max_len * 8)
    parts = tref.ivf_scan_ref(luts, codes, ids, pr, 5)
    assert all(torch.equal(a, b) for a, b in zip(whole, parts))


def test_scan_wrapper_checks(monkeypatch):
    """On a CPU tensor the dispatcher takes the plain version; the
    wrappers' checks reject what the kernel does not take."""
    from repro_torch.kernels import ivf_scan as wiv
    r = np.random.default_rng(0)
    luts = _t(r.normal(size=(2, 1, 8, 256)).astype(np.float32))
    codes = _t(r.integers(0, 256, size=(3, 8, 8)).astype(np.uint8))
    ids, pr = _t(_lists(r, 3, 8, 50)), _t(np.zeros((2, 2), np.int32))
    with pytest.raises(ValueError, match="CUDA"):
        wiv.ivf_scan(luts, codes, ids, pr, 4)
    monkeypatch.setattr(wiv, "check", lambda *a: None)
    with pytest.raises(ValueError, match="L=9"):
        wiv.ivf_scan(luts, codes, ids, pr, 9)
    with pytest.raises(ValueError, match="luts"):
        wiv.ivf_scan(luts.expand(2, 3, 8, 256), codes, ids, pr, 4)


# --------------------------------------------------------------------------
# core/ivf.py against the reference
# --------------------------------------------------------------------------
N, D = 3000, 32


@pytest.fixture(scope="module")
def xq():
    """Clustered rows and queries, seeded."""
    r = np.random.default_rng(21)
    cents = r.normal(size=(24, D)).astype(np.float32) * 3
    x = cents[r.integers(0, 24, N)] + r.normal(size=(N, D)).astype(np.float32)
    q = cents[r.integers(0, 24, 20)] + r.normal(size=(20, D)).astype(
        np.float32)
    return x.astype(np.float32), q.astype(np.float32)


def _draws(n, k, seed):
    return np.asarray(jax.random.choice(jax.random.PRNGKey(seed), n, (k,),
                                        replace=n < k))


def _build_both(x, kind, residual, nlist=16):
    """The reference's build_ivf and the port's with the reference's
    draws handed in."""
    icfg = dict(nlist=nlist, kmeans_iters=4, list_pad=8, residual=residual,
                seed=3)
    qcfg = dict(kind=kind, pq_m=8, kmeans_iters=3, seed=5)
    ref = jivf.build_ivf(jnp.asarray(x), RefIVFConfig(**icfg),
                         RefQuantConfig(**qcfg))
    draws = {"coarse_init": _t(_draws(N, nlist, 3))}
    if kind == "bin":
        g = np.asarray(jax.random.normal(jax.random.PRNGKey(5), (D, D),
                                         jnp.float32))
        draws["rot"] = tqz.rotation_from_gaussian(_t(g))
    else:
        K = 16 if kind == "pq4" else 256
        draws["pq_init"] = _t(np.stack([_draws(N, K, 5 + j)
                                        for j in range(8)]))
    port = tivf.build_ivf(_t(x), IVFConfig(**icfg), QuantConfig(**qcfg),
                          **draws)
    return ref, port


def _carry(ref) -> tivf.IVFState:
    """The reference's built state as the port's."""
    pq = bin_state = None
    if ref.pq is not None:
        pq = tqz.PQState(_t(ref.pq.codebooks), ref.pq.m, ref.pq.ds)
    if ref.bin is not None:
        bin_state = tqz.BinState(_t(ref.bin.rot))
        codes = _words(ref.list_codes)
    else:
        codes = _t(ref.list_codes)
    return tivf.IVFState(centroids=_t(ref.centroids),
                         list_ids=_t(ref.list_ids), list_codes=codes, pq=pq,
                         residual=ref.residual, packed=ref.packed,
                         bin=bin_state)


@pytest.mark.parametrize("kind,residual", [("pq", True), ("pq", False),
                                           ("pq4", True), ("sq", True),
                                           ("bin", True)])
def test_build_ivf_matches_reference(xq, kind, residual):
    """"sq" (like "none") takes the 8-bit PQ branch, as in the reference."""
    ref, port = _build_both(xq[0], kind, residual)
    np.testing.assert_allclose(port.centroids.numpy(),
                               np.asarray(ref.centroids), **TOL)
    assert port.max_len == ref.max_len and port.max_len % 8 == 0
    assert np.array_equal(port.list_ids.numpy(), np.asarray(ref.list_ids))
    assert (port.packed, port.residual) == (ref.packed, ref.residual)
    if kind == "bin":
        assert port.pq is None and port.list_codes.dtype == torch.int32
        got = port.list_codes.numpy().view(np.uint32)
    else:
        assert port.bin is None and port.list_codes.dtype == torch.uint8
        np.testing.assert_allclose(port.pq.codebooks.numpy(),
                                   np.asarray(ref.pq.codebooks), **TOL)
        got = port.list_codes.numpy()
    exp = np.asarray(ref.list_codes)
    assert got.shape == exp.shape and np.array_equal(got, exp)
    valid = np.asarray(ref.list_ids)
    assert sorted(valid[valid >= 0].tolist()) == list(range(N))


def test_auto_nlist_matches_reference():
    for n in (1, 3, 100, 2000, 1_000_000):
        assert tivf.auto_nlist(n) == jivf.auto_nlist(n)


@pytest.fixture(scope="module")
def states(xq):
    """Reference-built states: pq l2-residual, pq raw, pq4, bin."""
    out = {}
    for name, kind, residual in (("pq", "pq", True), ("raw", "pq", False),
                                 ("pq4", "pq4", True), ("bin", "bin", True)):
        icfg = RefIVFConfig(nlist=16, kmeans_iters=4, list_pad=8,
                            residual=residual)
        out[name] = jivf.build_ivf(jnp.asarray(xq[0]), icfg, RefQuantConfig(
            kind=kind, pq_m=8, kmeans_iters=3))
    return out


@pytest.mark.parametrize("nprobe", [1, 5, 40])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_select_probes_matches_reference(states, xq, metric, nprobe):
    ref = states["pq"]
    out = tivf.select_probes(_carry(ref), _t(xq[1]), nprobe, metric)
    exp = np.asarray(jivf.select_probes(ref, jnp.asarray(xq[1]), nprobe,
                                        metric))
    assert out.dtype == torch.int32 and np.array_equal(out.numpy(), exp)


@pytest.mark.parametrize("name,metric,lut_u8", [
    ("pq", "l2", False),      # l2 residual: a table per probe
    ("pq", "ip", False),      # ip residual: one table and a bias
    ("raw", "l2", False),     # raw codes: one table, no bias
    ("pq4", "l2", True),      # pq4, u8-requantized tables
    ("pq4", "ip", True)])
def test_query_luts_match_reference(states, xq, name, metric, lut_u8):
    ref, q = states[name], xq[1]
    probes = np.asarray(jivf.select_probes(ref, jnp.asarray(q), 6, metric))
    lut, bias = tivf.query_luts(_carry(ref), _t(q), _t(probes), metric,
                                lut_u8=lut_u8)
    elut, ebias = jivf.query_luts(ref, jnp.asarray(q), jnp.asarray(probes),
                                  metric, lut_u8=lut_u8)
    assert tuple(lut.shape) == tuple(elut.shape)
    assert lut.shape[1] == (6 if metric == "l2" and ref.residual else 1)
    # a u8 table may shift a step where an entry differs in its last bit
    # (ROADMAP Faults); the bound is one step, m steps for a sum
    tol = dict(rtol=0, atol=float(np.max(np.ptp(np.asarray(elut), axis=(2, 3))))
               / 255 * 1.01) if lut_u8 else TOL
    np.testing.assert_allclose(lut.numpy(), np.asarray(elut), **tol)
    assert (bias is None) == (ebias is None)
    if bias is not None:
        np.testing.assert_allclose(bias.numpy(), np.asarray(ebias), **TOL)


def _ref_tables(ref, q, probes, metric, lut_u8=False):
    lut, bias = jivf.query_luts(ref, jnp.asarray(q), jnp.asarray(probes),
                                metric, lut_u8=lut_u8)
    return _t(lut), None if bias is None else _t(bias)


@pytest.mark.parametrize("impl", ["ref", "kernel"])
@pytest.mark.parametrize("name,metric,L", [
    ("pq", "l2", 24), ("pq", "ip", 500), ("raw", "l2", 40),
    ("pq4", "ip", 24), ("bin", "ip", 64), ("bin", "l2", 2)])
def test_scan_lists_match_reference(states, xq, name, metric, L, impl):
    """The scan and the global merge on the reference's tables; L=500
    exceeds max_len (the per-list L is clamped) and P * Lp."""
    ref, q = states[name], xq[1][:6]
    probes = np.asarray(jivf.select_probes(ref, jnp.asarray(q), 5, metric))
    state = _carry(ref)
    if name == "bin":
        qc = np.asarray(jqz.bin_query_codes(ref.bin, jnp.asarray(q)))
        assert np.array_equal(
            tqz.bin_query_codes(state.bin, _t(q)).numpy().view(np.uint32), qc)
        out = tivf.scan_bin_lists(state, _words(qc), _t(probes), L, impl)
        exp = jivf.scan_bin_lists(ref, jnp.asarray(qc), jnp.asarray(probes),
                                  L, impl)
        exact = True
    else:
        lut, bias = _ref_tables(ref, q, probes, metric)
        out = tivf.scan_lists(state, lut, _t(probes), L, impl, bias=bias)
        exp = jivf.scan_lists(ref, jnp.asarray(lut.numpy()),
                              jnp.asarray(probes), L, impl,
                              bias=None if bias is None
                              else jnp.asarray(bias.numpy()))
        exact = False
    _same([a.numpy() for a in out], [exp], exact=exact)
    counts = tivf.scanned_counts(state, _t(probes))
    assert counts.dtype == torch.int32
    assert np.array_equal(counts.numpy(), np.asarray(
        jivf.scanned_counts(ref, jnp.asarray(probes))))


@pytest.mark.parametrize("name,metric", [("pq", "l2"), ("raw", "ip"),
                                         ("pq4", "l2"), ("bin", "ip")])
def test_search_ivf_matches_reference(states, xq, name, metric):
    """Probe, tables, scan and merge end to end, each package's own
    tables (they differ in the last bit: approximate distances to TOL,
    ids equal away from near-ties)."""
    ref, q = states[name], xq[1]
    d, i, p = tivf.search_ivf(_carry(ref), _t(q), 6, 32, metric)
    ed, ei, ep = (np.asarray(a) for a in jivf.search_ivf(
        ref, jnp.asarray(q), 6, 32, metric))
    assert np.array_equal(p.numpy(), ep)
    np.testing.assert_allclose(d.numpy(), ed, **TOL)
    assert np.mean(i.numpy() == ei) >= 0.995


def test_ivf_exhaustive_probe_matches_pq_brute_force():
    """nprobe == nlist equals a flat ADC scan of all codes (the partition
    only routes; it must not change ADC distances). The port of the
    reference's test of the same name (tests/test_ivf.py)."""
    r = np.random.default_rng(11)
    n, d, L = 400, 32, 32
    x = _t(r.normal(size=(n, d)).astype(np.float32))
    q = _t(r.normal(size=(6, d)).astype(np.float32))
    state = tivf.build_ivf(
        x, IVFConfig(nlist=8, kmeans_iters=5, list_pad=8, residual=False),
        QuantConfig(kind="pq", pq_m=8, kmeans_iters=4))
    d_ivf, i_ivf, _ = tivf.search_ivf(state, q, nprobe=8, L=L, metric="l2")
    ids_h = state.list_ids.numpy()
    codes = np.zeros((n, 8), np.uint8)
    codes[ids_h[ids_h >= 0]] = state.list_codes.numpy()[ids_h >= 0]
    lut = tqz.pq_query_tables(state.pq.codebooks, q, "l2").reshape(6, 8, 256)
    all_ids = torch.arange(n, dtype=torch.int32)[None].expand(6, n)
    d_flat = tref.pq_adc_ref(lut, _t(codes), all_ids.contiguous()).numpy()
    np.testing.assert_allclose(d_ivf.numpy(), np.sort(d_flat, axis=1)[:, :L],
                               rtol=1e-4, atol=1e-4)
    for a, b in zip(i_ivf.numpy(), np.argsort(d_flat, axis=1)[:, :L]):
        assert len(set(a.tolist()) & set(b.tolist())) >= L - 2


# --------------------------------------------------------------------------
# on the card: the CUDA list scans vs their plain versions
# --------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("max_len,L", [
    (300, 300),         # L = max_len
    (2176, 128),        # a Deep1M-like list length, not a power of two
    (70000, 5000)])     # keys recomputed per pass; L above one round
def test_cuda_scans_match_plain(cuda, max_len, L):
    r = np.random.default_rng(max_len)
    nlist, Q, P = 6, 5, 3
    ids = torch.as_tensor(_lists(r, nlist, max_len, 1_000_000), device=cuda)
    pr = torch.as_tensor(_probes(r, Q, P, nlist), device=cuda)
    before = tops.launch_counts()
    for per_probe in (False, True):
        Pl = P if per_probe else 1
        for K, m, width, fn, plain in (
                (256, 16, 16, tops.ivf_scan, tref.ivf_scan_ref),
                (16, 32, 16, tops.pq4_ivf_scan, tref.pq4_ivf_scan_ref)):
            luts = torch.as_tensor(r.normal(size=(Q, Pl, m, K)).astype(
                np.float32), device=cuda)
            codes = torch.as_tensor(r.integers(0, 256, size=(
                nlist, max_len, width)).astype(np.uint8), device=cuda)
            out = fn(luts, codes, ids, pr, L=L)
            exp = plain(luts, codes, ids, pr, L)
            assert torch.equal(out[0], exp[0]) and torch.equal(out[1], exp[1])
    words = torch.as_tensor(r.integers(-2 ** 31, 2 ** 31, size=(
        nlist, max_len, 3)).astype(np.int32), device=cuda)
    qw = torch.as_tensor(r.integers(-2 ** 31, 2 ** 31, size=(Q, 3)).astype(
        np.int32), device=cuda)
    out = tops.bin_ivf_scan(qw, words, ids, pr, L=L)
    exp = tref.bin_ivf_scan_ref(qw, words, ids, pr, L)
    assert torch.equal(out[0], exp[0]) and torch.equal(out[1], exp[1])
    after = tops.launch_counts()
    assert after["ivf_scan"] == before["ivf_scan"] + 2
    assert after["pq4_ivf_scan"] == before["pq4_ivf_scan"] + 2
    assert after["bin_ivf_scan"] == before["bin_ivf_scan"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("max_len", [2176, 70_000, 120_000])
@pytest.mark.parametrize("nw", [1, 3, 8, 32])
def test_cuda_bin_scan_counting_sort(cuda, nw, max_len):
    """The counting-sort bin scan equals its plain version exactly at L in
    {1, 768, max_len}: ragged lists with holes, a list all -1, a list whose
    slots all hold one code (every distance tied, so the order is the slot
    order), 16-bit values kept in shared memory (2,176 and 70,000 slots)
    or recomputed (120,000); probes outside [0, nlist) give whole rows of
    (+inf, -1)."""
    r = np.random.default_rng(nw * 7 + max_len)
    nlist, Q, P = 6, 5, 3
    ids = _lists(r, nlist, max_len, 1_000_000)     # list 0 all -1
    ids[1] = r.choice(1_000_000, size=max_len, replace=False)
    words = r.integers(-2 ** 31, 2 ** 31, size=(nlist, max_len, nw),
                       dtype=np.int64).astype(np.int32)
    words[1] = words[1, 0]                         # the tie storm
    pr = _probes(r, Q, P, nlist)
    pr[1:, 0] = 1
    qw = r.integers(-2 ** 31, 2 ** 31, size=(Q, nw),
                    dtype=np.int64).astype(np.int32)
    qw, words, ids, pr = (torch.as_tensor(a, device=cuda)
                          for a in (qw, words, ids, pr))
    before = tops.launch_counts()["bin_ivf_scan"]
    for L in (1, 768, max_len):
        out = tops.bin_ivf_scan(qw, words, ids, pr, L=L)
        exp = tref.bin_ivf_scan_ref(qw, words, ids, pr, L)
        assert torch.equal(out[0], exp[0]) and torch.equal(out[1], exp[1]), L
    bad = pr.clone()
    bad[:, 1], bad[:, 2] = -1, nlist
    d, i = tops.bin_ivf_scan(qw, words, ids, bad, L=768)
    exp = tref.bin_ivf_scan_ref(qw, words, ids, pr[:, :1].contiguous(), 768)
    assert torch.equal(d[:, :1], exp[0]) and torch.equal(i[:, :1], exp[1])
    assert torch.isinf(d[:, 1:]).all() and bool((i[:, 1:] == -1).all())
    assert tops.launch_counts()["bin_ivf_scan"] == before + 4
