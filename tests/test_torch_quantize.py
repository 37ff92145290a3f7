"""The port's quantizers (repro_torch/core/quantize.py) and the plain
versions of its quantized kernels against the JAX package's.

Both packages get the same seeded numpy inputs. The reference's Pallas
kernels run in interpret mode through `repro.kernels.ops`, beside their
jnp oracles. k-means and PQ training take the reference's own
`jax.random.choice` draws as their injected initial indices (torch cannot
reproduce jax's bits). Tolerance: f32 values rtol=3e-5 / atol=3e-4, the
reference's own (tests/test_kernels.py); codes, ids and tie counts
exactly. The `cuda` test holds k-means on the card to the same codebooks
on a second run and skips without a card.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quantize as jqz
from repro.core.types import QuantConfig as RefQuantConfig
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.core import quantize as tqz
from repro_torch.core.types import QuantConfig
from repro_torch.kernels import ops as tops

# parallel test workers share the cores: one torch thread each keeps the
# many small eager ops from oversubscribing them
torch.set_num_threads(1)

TOL = dict(rtol=3e-5, atol=3e-4)


def _t(a):
    return torch.as_tensor(np.array(a))


def _ref_draws(n, k, seed):
    """The reference k-means's initial indices (quantize.py:58-59)."""
    return np.asarray(jax.random.choice(jax.random.PRNGKey(seed), n, (k,),
                                        replace=n < k))


def _ids(r, Q, C, n, invalid=0.1):
    ids = r.integers(0, n, size=(Q, C)).astype(np.int32)
    ids[r.random((Q, C)) < invalid] = -1
    return ids


def _inject_ties(ids, W, M):
    """Expansion w repeats ids of earlier expansions, so bests tie."""
    for w in range(1, W):
        ids[:, w * M] = ids[:, 0]
        ids[:, w * M + 1] = ids[:, (w - 1) * M + 2]


def _sq_case(seed, Q, C, n, d):
    r = np.random.default_rng(seed)
    q = r.normal(size=(Q, d)).astype(np.float32)
    codes = r.integers(0, 256, size=(n, d)).astype(np.uint8)
    scale = (r.random(d) * 0.02 + 1e-3).astype(np.float32)
    zero = (-r.random(d)).astype(np.float32)
    return q, codes, scale, zero, _ids(r, Q, C, n)


def _pq_case(seed, Q, C, n, m, K=256):
    r = np.random.default_rng(seed)
    lut = r.normal(size=(Q, m, K)).astype(np.float32)
    codes = r.integers(0, K, size=(n, m)).astype(np.uint8)
    return lut, codes, _ids(r, Q, C, n)


# --------------------------------------------------------------------------
# plain versions of the four kernels against the reference's
# --------------------------------------------------------------------------
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("Q,M,n,d", [(4, 8, 100, 96), (5, 24, 300, 32),
                                     (3, 13, 60, 100)])
def test_sq_gather_dist_matches_reference(metric, Q, M, n, d):
    q, codes, scale, zero, ids = _sq_case(Q + M + d, Q, M, n, d)
    out = tops.sq_gather_dist(_t(q), _t(codes), _t(scale), _t(zero),
                              _t(ids), metric=metric).numpy()
    j = jnp.asarray
    kern = np.asarray(jops.sq_gather_dist(j(q), j(codes), j(scale), j(zero),
                                          j(ids), metric=metric))
    oracle = np.asarray(jref.sq_gather_dist_ref(
        j(q), j(codes), j(scale)[None], j(zero)[None], j(ids), metric))
    assert np.array_equal(np.isinf(out), ids < 0)
    np.testing.assert_allclose(out, kern, **TOL)
    np.testing.assert_allclose(out, oracle, **TOL)


@pytest.mark.parametrize("Q,B,n,m", [(4, 8, 100, 16), (5, 24, 300, 8),
                                     (3, 7, 50, 12)])
def test_pq_adc_matches_reference(Q, B, n, m):
    lut, codes, ids = _pq_case(Q * B + m, Q, B, n, m)
    out = tops.pq_adc(_t(lut), _t(codes), _t(ids)).numpy()
    j = jnp.asarray
    kern = np.asarray(jops.pq_adc(j(lut), j(codes), j(ids)))
    oracle = np.asarray(jref.pq_adc_ref(j(lut), j(codes), j(ids)))
    assert np.array_equal(np.isinf(out), ids < 0)
    np.testing.assert_allclose(out, kern, **TOL)
    np.testing.assert_allclose(out, oracle, **TOL)


def _same_block(out, exps):
    for exp in exps:
        np.testing.assert_allclose(out[0], exp[0], **TOL)   # sorted dists
        assert np.array_equal(out[1], exp[1])               # sorted ids
        np.testing.assert_allclose(out[2], exp[2], **TOL)   # bests
        assert np.array_equal(out[3], exp[3])               # tie counts


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("W,M,L,d", [(1, 8, 8, 96), (4, 24, 64, 96),
                                     (4, 6, 32, 32)])
def test_fused_expand_sq_matches_reference(metric, W, M, L, d):
    Q, n, C = 4, 150, W * M
    q, codes, scale, zero, ids = _sq_case(W * M + L + d, Q, C, n, d)
    _inject_ties(ids, W, M)
    out = [t.numpy() for t in tops.fused_expand_sq(
        _t(q), _t(codes), _t(scale), _t(zero), _t(ids), metric=metric, L=L,
        n_beam=W)]
    j = jnp.asarray
    kern = [np.asarray(a) for a in jops.fused_expand_sq(
        j(q), j(codes), j(scale), j(zero), j(ids), metric=metric, L=L,
        n_beam=W)]
    oracle = [np.asarray(a) for a in jref.fused_expand_sq_ref(
        j(q), j(codes), j(scale)[None], j(zero)[None], j(ids), metric, L, W)]
    _same_block(out, (kern, oracle))
    assert out[0].shape == (Q, min(L, C)) and out[3].dtype == np.int32
    if W > 1:
        assert out[3].sum() > 0, "the injected ties were not counted"


@pytest.mark.parametrize("W,M,L,m", [(1, 8, 8, 16), (4, 24, 64, 16),
                                     (4, 6, 32, 8)])
def test_fused_expand_pq_matches_reference(W, M, L, m):
    Q, n, C = 4, 150, W * M
    lut, codes, ids = _pq_case(W * M + L + m, Q, C, n, m)
    _inject_ties(ids, W, M)
    out = [t.numpy() for t in tops.fused_expand_pq(
        _t(lut), _t(codes), _t(ids), L=L, n_beam=W)]
    j = jnp.asarray
    kern = [np.asarray(a) for a in jops.fused_expand_pq(
        j(lut), j(codes), j(ids), L=L, n_beam=W)]
    oracle = [np.asarray(a) for a in jref.fused_expand_pq_ref(
        j(lut), j(codes), j(ids), L, W)]
    _same_block(out, (kern, oracle))
    if W > 1:
        assert out[3].sum() > 0, "the injected ties were not counted"


# --------------------------------------------------------------------------
# k-means, PQ and SQ against the reference
# --------------------------------------------------------------------------
def _clustered(seed, n, d):
    r = np.random.default_rng(seed)
    cents = r.normal(size=(12, d)).astype(np.float32) * 3
    return (cents[r.integers(0, 12, n)]
            + r.normal(size=(n, d)).astype(np.float32))


@pytest.mark.parametrize("n,k,iters", [(3000, 256, 4), (40, 64, 3)])
def test_kmeans_with_reference_draws(n, k, iters):
    """n < k draws with replacement, as the reference does."""
    x = _clustered(n, n, 6)
    init = _ref_draws(n, k, seed=5)
    out = tqz.kmeans(_t(x), k, iters, init_idx=_t(init)).numpy()
    exp = np.asarray(jqz.kmeans(jnp.asarray(x), k, iters, seed=5))
    np.testing.assert_allclose(out, exp, **TOL)


def test_kmeans_default_draw_is_seeded_and_deterministic():
    x = _t(_clustered(1, 2000, 4))
    a = tqz.kmeans(x, 32, 3, seed=7)
    assert torch.equal(a, tqz.kmeans(x, 32, 3, seed=7))
    assert not torch.equal(a, tqz.kmeans(x, 32, 3, seed=8))
    init = tqz.kmeans_init(2000, 32, 7)
    assert len(set(init.tolist())) == 32
    assert torch.equal(tqz.kmeans(x, 32, 3, init_idx=init), a)


@pytest.mark.parametrize("d,m", [(32, 8), (96, 16)])
def test_pq_train_encode_tables_match_reference(d, m):
    n = 3000
    x = _clustered(d + m, n, d)
    cfg = dict(kind="pq", pq_m=m, kmeans_iters=3, seed=2)
    init = np.stack([_ref_draws(n, 256, 2 + j) for j in range(m)])
    port = tqz.pq_train(_t(x), QuantConfig(**cfg), init_idx=_t(init))
    ref = jqz.pq_train(jnp.asarray(x), RefQuantConfig(**cfg))
    assert (port.m, port.ds, port.ksub) == (ref.m, ref.ds, ref.ksub)
    np.testing.assert_allclose(port.codebooks.numpy(),
                               np.asarray(ref.codebooks), **TOL)
    # encode and tables on the reference's own codebooks: equal codes
    books = np.asarray(ref.codebooks)
    codes = tqz.pq_encode(_t(books), _t(x)).numpy()
    assert codes.dtype == np.uint8
    assert np.array_equal(codes, np.asarray(jqz.pq_encode(jnp.asarray(books),
                                                          jnp.asarray(x))))
    q = np.random.default_rng(0).normal(size=(7, d)).astype(np.float32)
    for metric in ("l2", "ip"):
        np.testing.assert_allclose(
            tqz.pq_query_tables(_t(books), _t(q), metric).numpy(),
            np.asarray(jqz.pq_query_tables(jnp.asarray(books),
                                           jnp.asarray(q), metric)), **TOL)


def test_pq_encode_chunks_do_not_change_codes(monkeypatch):
    x = _t(_clustered(3, 1500, 32))
    books = tqz.pq_train(x, QuantConfig(kind="pq", pq_m=8,
                                        kmeans_iters=2)).codebooks
    whole = tqz.pq_encode(books, x)
    monkeypatch.setattr(tqz, "_ROWS", 64)
    assert torch.equal(tqz.pq_encode(books, x), whole)


@pytest.mark.parametrize("d", [32, 96])
def test_sq_train_encode_match_reference(d):
    x = _clustered(d, 3000, d)
    port = tqz.sq_train(_t(x))
    ref = jqz.sq_train(jnp.asarray(x))
    assert np.array_equal(port.scale.numpy(), np.asarray(ref.scale))
    assert np.array_equal(port.zero.numpy(), np.asarray(ref.zero))
    codes = tqz.sq_encode(port, _t(x)).numpy()
    assert codes.dtype == np.uint8
    assert np.array_equal(codes, np.asarray(jqz.sq_encode(ref,
                                                          jnp.asarray(x))))


@pytest.mark.parametrize("impl", ["ref", "kernel"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_dist_fns_match_reference(impl, metric):
    """The first pass's DistFns on the same codes and queries."""
    d, m, n = 32, 8, 400
    x = _clustered(9, n, d)
    r = np.random.default_rng(1)
    q = r.normal(size=(5, d)).astype(np.float32)
    ids = r.integers(0, n, size=(5, 24)).astype(np.int32)
    j = jnp.asarray
    books = np.asarray(jqz.pq_train(j(x), RefQuantConfig(
        kind="pq", pq_m=m, kmeans_iters=2)).codebooks)
    pcodes = np.asarray(jqz.pq_encode(j(books), j(x)))
    tables = np.asarray(jqz.pq_query_tables(j(books), j(q), metric))
    out = tqz.pq_make_dist_fn(_t(pcodes), m, impl)(_t(tables), _t(ids))
    exp = jqz.pq_make_dist_fn(j(pcodes), m, impl)(j(tables), j(ids))
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), **TOL)
    sq = jqz.sq_train(j(x))
    scodes = np.asarray(jqz.sq_encode(sq, j(x)))
    tsq = tqz.SQState(_t(sq.scale), _t(sq.zero))
    out = tqz.sq_make_dist_fn(_t(scodes), tsq, metric, impl)(_t(q), _t(ids))
    exp = jqz.sq_make_dist_fn(j(scodes), sq, metric, impl)(j(q), j(ids))
    np.testing.assert_allclose(out.numpy(), np.asarray(exp), **TOL)


def test_registry_is_the_reference_one():
    for pq_m in (8, 16):
        assert tqz.quant_variants(pq_m) == jqz.quant_variants(pq_m)
    assert tqz.IVF_QUANT_KINDS == jqz.IVF_QUANT_KINDS


def test_code_bytes_per_vector():
    class Idx:
        db = torch.zeros((3, 96))
    idx = Idx()
    assert tqz.code_bytes_per_vector(idx) == 384
    idx.sq_codes = torch.zeros((3, 96), dtype=torch.uint8)
    assert tqz.code_bytes_per_vector(idx) == 96
    idx.pq_codes = torch.zeros((3, 16), dtype=torch.uint8)
    assert tqz.code_bytes_per_vector(idx) == 16


# --------------------------------------------------------------------------
# the data module's default device, and k-means on the card
# --------------------------------------------------------------------------
def test_make_dataset_default_device_is_the_card():
    from repro.data.vectors import make_dataset as ref_make
    from repro_torch.data.vectors import make_dataset
    if torch.cuda.is_available():
        ds = make_dataset("deep_like", n=300, n_queries=5, k=10)
        assert np.array_equal(ds.gt_ids, ref_make("deep_like", n=300,
                                                  n_queries=5, k=10).gt_ids)
    else:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make_dataset("deep_like", n=300, n_queries=5, k=10)
    ds = make_dataset("deep_like", n=300, n_queries=5, k=10, device="cpu")
    ref = ref_make("deep_like", n=300, n_queries=5, k=10)
    assert np.array_equal(ds.base, ref.base)
    assert np.array_equal(ds.gt_ids, ref.gt_ids)


@pytest.mark.cuda
def test_pq_train_on_the_card_is_deterministic():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.as_tensor(_clustered(4, 20000, 96), device="cuda")
    cfg = QuantConfig(kind="pq", pq_m=16, kmeans_iters=4)
    a = tqz.pq_train(x, cfg).codebooks
    b = tqz.pq_train(x, cfg).codebooks
    assert torch.equal(a, b)
