"""The port's pq4 and bin codecs and the plain versions of their kernels
against the JAX package's.

Both packages get the same seeded numpy inputs (the conftest's `deep_ds`,
n=2,000, d=96, where a codec needs real vectors). The reference's Pallas
kernels run in interpret mode through `repro.kernels.ops`, beside their
jnp oracles. PQ4 training takes the reference's own `jax.random.choice`
draws and the bin rotation the reference's own `jax.random.normal` draw
(torch cannot reproduce jax's bits). Bin words are compared as bits: the
port keeps the reference's uint32 words as int32. Tolerance: f32 values
rtol=3e-5 / atol=3e-4, the reference's own (tests/test_kernels.py);
codes, Hamming distances, ids and tie counts exactly. The `cuda` test
holds the four CUDA kernels to their plain versions and skips without a
card.
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


def _ids(r, Q, C, n, invalid=0.1):
    ids = r.integers(0, n, size=(Q, C)).astype(np.int32)
    ids[r.random((Q, C)) < invalid] = -1
    return ids


def _inject_ties(ids, W, M):
    """Expansion w repeats ids of earlier expansions, so bests tie."""
    for w in range(1, W):
        ids[:, w * M] = ids[:, 0]
        ids[:, w * M + 1] = ids[:, (w - 1) * M + 2]


def _blank(ids, W, M, w=1):
    """Expansion w's ids all -1: its best is +inf and every +inf entry of
    the earlier expansions ties with it (float ==)."""
    ids[:, w * M:(w + 1) * M] = -1


def _blank_counted(out, ids, W, M, w=1):
    """The blanked expansion's best and tie count as the semantics give
    them, and at least one such tie (each query has an invalid id)."""
    assert np.isinf(out[2][:, w]).all()
    exp = (ids[:, :w * M] < 0).sum(axis=1)
    assert np.array_equal(out[3][:, w], exp) and exp.sum() > 0


def _same_block(out, exps, exact=False):
    """A fused block against each expected block: dists and bests to TOL
    (or exactly), ids and tie counts exactly."""
    for exp in exps:
        for k in (0, 2):
            if exact:
                assert np.array_equal(out[k], exp[k])
            else:
                np.testing.assert_allclose(out[k], exp[k], **TOL)
        assert np.array_equal(out[1], exp[1])
        assert np.array_equal(out[3], exp[3])


# --------------------------------------------------------------------------
# the pq4 codec
# --------------------------------------------------------------------------
@pytest.mark.parametrize("m", [2, 16, 32])
def test_pq4_pack_unpack_and_nibble_order(m):
    codes = np.random.default_rng(m).integers(0, 16, size=(50, m))
    packed = tqz.pq4_pack(_t(codes)).numpy()
    assert packed.dtype == np.uint8 and packed.shape == (50, m // 2)
    # byte j: subspace 2j in the low nibble, 2j+1 in the high one
    assert np.array_equal(packed, codes[:, 0::2] | (codes[:, 1::2] << 4))
    assert np.array_equal(packed, np.asarray(jqz.pq4_pack(jnp.asarray(codes))))
    assert np.array_equal(tqz.pq4_unpack(_t(packed)).numpy(), codes)
    assert np.array_equal(tref._unpack_nibbles_ref(_t(packed)).numpy(),
                          np.asarray(jref._unpack_nibbles_ref(
                              jnp.asarray(packed))))


def test_pq4_train_encode_tables_match_reference(deep_ds):
    x = deep_ds.base
    n, m = x.shape[0], 16
    cfg = dict(kind="pq4", pq_m=m, kmeans_iters=3, seed=4)
    init = np.stack([np.asarray(jax.random.choice(
        jax.random.PRNGKey(4 + j), n, (16,), replace=False))
        for j in range(m)])
    port = tqz.pq_train(_t(x), QuantConfig(**cfg), init_idx=_t(init))
    ref = jqz.pq_train(jnp.asarray(x), RefQuantConfig(**cfg))
    assert port.ksub == ref.ksub == 16
    np.testing.assert_allclose(port.codebooks.numpy(),
                               np.asarray(ref.codebooks), **TOL)
    # encode and tables on the reference's own codebooks: equal codes
    books = np.asarray(ref.codebooks)
    packed = tqz.pq4_encode(_t(books), _t(x)).numpy()
    assert packed.shape == (n, m // 2) and packed.dtype == np.uint8
    assert np.array_equal(packed, np.asarray(jqz.pq4_encode(
        jnp.asarray(books), jnp.asarray(x))))
    q = deep_ds.queries
    for metric in ("l2", "ip"):
        for lut_u8 in (False, True):
            out = tqz.pq4_query_tables(_t(books), _t(q), metric,
                                       lut_u8=lut_u8).numpy()
            exp = np.asarray(jqz.pq4_query_tables(
                jnp.asarray(books), jnp.asarray(q), metric, lut_u8=lut_u8))
            assert out.shape == (len(q), m * 16)
            np.testing.assert_allclose(out, exp, **TOL)


def test_pq4_requant_lut_equals_reference():
    """Bit-equal on the same tables: both round half to even; the
    reference's fold-back may contract into one FMA, so values may differ
    by an ulp of the result, never more."""
    r = np.random.default_rng(3)
    lut = (r.normal(size=(40, 256)) * r.random((40, 1)) * 5).astype(
        np.float32)
    lut[0] = 1.5                                   # a flat table: step 1e-12
    out = tqz.pq4_requant_lut(_t(lut)).numpy()
    exp = np.asarray(jqz.pq4_requant_lut(jnp.asarray(lut)))
    ulp = np.spacing(np.abs(exp).astype(np.float32))
    assert np.all(np.abs(out - exp) <= ulp), np.max(np.abs(out - exp) / ulp)
    levels = (out - out.min(1, keepdims=True))
    assert np.all(np.array([len(np.unique(row)) for row in levels]) <= 256)


# --------------------------------------------------------------------------
# the bin codec
# --------------------------------------------------------------------------
@pytest.mark.parametrize("d", [32, 70, 96])
def test_pack_signs_matches_reference(d):
    bits = np.random.default_rng(d).integers(0, 2, size=(30, d))
    words = tqz.pack_signs(_t(bits))
    assert words.dtype == torch.int32 and words.shape == (30, -(-d // 32))
    exp = np.asarray(jqz.pack_signs(jnp.asarray(bits)))
    assert np.array_equal(words.numpy().view(np.uint32), exp)
    assert np.array_equal(tqz.unpack_signs(words, d).numpy(), bits)
    # tail bits of the last word are zero
    tail = d % 32
    if tail:
        assert not (words[:, -1].numpy().view(np.uint32) >> tail).any()


def test_rotation_from_the_reference_draw():
    d, seed = 96, 11
    g = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), (d, d),
                                     jnp.float32))
    rot = tqz.rotation_from_gaussian(_t(g)).numpy()
    np.testing.assert_allclose(rot, np.asarray(jqz._random_rotation(d, seed)),
                               **TOL)
    np.testing.assert_allclose(rot.T @ rot, np.eye(d), atol=1e-5)


def test_random_rotation_is_seeded_and_orthonormal():
    a = tqz.random_rotation(40, 3)
    assert torch.equal(a, tqz.random_rotation(40, 3))
    assert not torch.equal(a, tqz.random_rotation(40, 4))
    np.testing.assert_allclose((a.T @ a).numpy(), np.eye(40), atol=1e-5)
    st = tqz.bin_train(torch.zeros((5, 40)), QuantConfig(kind="bin", seed=3))
    assert torch.equal(st.rot, a) and (st.dim, st.n_words) == (40, 2)
    rot = torch.eye(40)
    assert torch.equal(tqz.bin_train(torch.zeros((5, 40)),
                                     QuantConfig(kind="bin"), rot=rot).rot,
                       rot)


def test_bin_codes_match_reference(deep_ds):
    """On the reference's rotation the codes agree bit for bit wherever
    the projection is clear of zero (|x . rot| > 1e-5: a sign within
    rounding of 0 may fall either way). Query codes must agree entirely:
    the search-parity tests rely on it."""
    rot = np.asarray(jqz._random_rotation(96, 0))
    st = tqz.BinState(rot=_t(rot))
    ref = jqz.BinState(rot=jnp.asarray(rot))
    for x, name in ((deep_ds.base, "base"), (deep_ds.queries, "queries")):
        out = tqz.unpack_signs(tqz.bin_encode(st, _t(x)), 96).numpy()
        exp = np.asarray(jqz.unpack_signs(jqz.bin_encode(ref,
                                                         jnp.asarray(x)), 96))
        clear = np.abs(x.astype(np.float64) @ rot.astype(np.float64)) > 1e-5
        assert np.array_equal(out[clear], exp[clear]), name
        n_diff = int((out != exp).sum())
        if name == "queries":
            assert n_diff == 0, f"{n_diff} query sign bits differ"
    q = tqz.bin_query_codes(st, _t(deep_ds.queries)).numpy()
    assert np.array_equal(q.view(np.uint32), np.asarray(
        jqz.bin_query_codes(ref, jnp.asarray(deep_ds.queries))))


def test_bin_encode_chunks_do_not_change_codes(monkeypatch, deep_ds):
    st = tqz.BinState(rot=tqz.random_rotation(96, 1))
    x = _t(deep_ds.base)
    whole = tqz.bin_encode(st, x)
    monkeypatch.setattr(tqz, "_ROWS", 64)
    assert torch.equal(tqz.bin_encode(st, x), whole)


# --------------------------------------------------------------------------
# plain kernels against the reference's Pallas kernels (interpret mode)
# --------------------------------------------------------------------------
def _pq4_case(seed, Q, C, n, m):
    r = np.random.default_rng(seed)
    lut = r.normal(size=(Q, m, 16)).astype(np.float32)
    packed = r.integers(0, 256, size=(n, m // 2)).astype(np.uint8)
    return lut, packed, _ids(r, Q, C, n)


def _bin_case(seed, Q, C, n, d):
    r = np.random.default_rng(seed)
    q = np.array(jqz.pack_signs(jnp.asarray(r.integers(0, 2, (Q, d)))))
    codes = np.array(jqz.pack_signs(jnp.asarray(r.integers(0, 2, (n, d)))))
    return q, codes, _ids(r, Q, C, n)


@pytest.mark.parametrize("Q,B,n,m", [(3, 8, 50, 16), (4, 24, 300, 8),
                                     (2, 5, 20, 32)])
def test_pq4_adc_matches_reference(Q, B, n, m):
    lut, packed, ids = _pq4_case(Q + B + m, Q, B, n, m)
    ids[:, 1] = ids[:, 0]                      # a repeated id
    out = tops.pq4_adc(_t(lut), _t(packed), _t(ids)).numpy()
    j = jnp.asarray
    for exp in (jops.pq4_adc(j(lut), j(packed), j(ids)),
                jref.pq4_adc_ref(j(lut), j(packed), j(ids))):
        np.testing.assert_allclose(out, np.asarray(exp), **TOL)
    assert np.isinf(out[ids < 0]).all()


def test_pq4_adc_negative_zero_rows():
    """A code whose terms are all -0.0 sums to +0.0, as jnp.sum and the
    CUDA kernel's sum from +0.0 give it: the sign is held exactly."""
    lut, packed, ids = _pq4_case(7, 3, 8, 40, 16)
    lut[..., 0] = -0.0
    packed[::2] = 0
    out = tops.pq4_adc(_t(lut), _t(packed), _t(ids)).numpy()
    j = jnp.asarray
    for exp in (jops.pq4_adc(j(lut), j(packed), j(ids)),
                jref.pq4_adc_ref(j(lut), j(packed), j(ids))):
        assert np.array_equal(np.signbit(out), np.signbit(np.asarray(exp)))
        np.testing.assert_allclose(out, np.asarray(exp), **TOL)
    zero = (ids >= 0) & (ids % 2 == 0)
    assert zero.any() and (out[zero] == 0).all()


@pytest.mark.parametrize("W,M,L,blank", [
    pytest.param(1, 8, 4, False, id="1-8-4"),
    pytest.param(4, 6, 24, False, id="4-6-24"),
    pytest.param(4, 8, 10, False, id="4-8-10"),
    pytest.param(4, 6, 24, True, id="4-6-24-blank_expansion")])
def test_fused_expand_pq4_matches_reference(W, M, L, blank):
    """With `blank`, expansion 1's ids are all -1 (_blank)."""
    Q, C, n, m = 3, W * M, 60, 16
    lut, packed, ids = _pq4_case(W * M + L, Q, C, n, m)
    _inject_ties(ids, W, M)
    if blank:
        ids[:, 0] = -1
        _blank(ids, W, M)
    out = [t.numpy() for t in tops.fused_expand_pq4(
        _t(lut), _t(packed), _t(ids), L=L, n_beam=W)]
    j = jnp.asarray
    _same_block(out, [[np.asarray(a) for a in f] for f in (
        jops.fused_expand_pq4(j(lut), j(packed), j(ids), L=L, n_beam=W),
        jref.fused_expand_pq4_ref(j(lut), j(packed), j(ids), L, W))])
    if W > 1:
        assert out[3].sum() > 0, "the injected ties were not counted"
    if blank:
        _blank_counted(out, ids, W, M)


@pytest.mark.parametrize("Q,B,n,d", [(3, 8, 50, 96), (4, 24, 300, 70),
                                     (2, 5, 20, 200)])
def test_bin_dist_matches_reference(Q, B, n, d):
    qc, codes, ids = _bin_case(Q + B + d, Q, B, n, d)
    ids[:, 1] = ids[:, 0]
    out = tops.bin_dist(_words(qc), _words(codes), _t(ids)).numpy()
    j = jnp.asarray
    for exp in (jops.bin_dist(j(qc), j(codes), j(ids)),
                jref.bin_dist_ref(j(qc), j(codes), j(ids))):
        assert np.array_equal(out, np.asarray(exp))
    assert np.isinf(out[ids < 0]).all()
    assert out[ids >= 0].max() <= d


@pytest.mark.parametrize("case", ["random", "few_values", "all_ties",
                                  "blank_expansion"])
@pytest.mark.parametrize("W,M,L", [(1, 8, 4), (4, 6, 24), (4, 8, 10)])
def test_fused_expand_bin_matches_reference(case, W, M, L):
    """Hamming blocks are mostly exact ties: the order, minima and tie
    counts must equal the reference's exactly, also on a block of codes
    that take two values, on one where every candidate ties, and where
    the last expansion's ids are all -1 (_blank; at W=1 the whole
    block)."""
    Q, C, n, d = 3, W * M, 60, 96
    qc, codes, ids = _bin_case(W * M + L, Q, C, n, d)
    if case == "few_values":
        codes[1::2] = codes[0]
        codes[0::2] = codes[1]
    elif case == "all_ties":
        codes[:] = codes[0]
        ids[ids < 0] = 0
    _inject_ties(ids, W, M)
    if case == "blank_expansion":
        ids[:, 0] = -1
        _blank(ids, W, M, W - 1)
    out = [t.numpy() for t in tops.fused_expand_bin(
        _words(qc), _words(codes), _t(ids), L=L, n_beam=W)]
    j = jnp.asarray
    _same_block(out, [[np.asarray(a) for a in f] for f in (
        jops.fused_expand_bin(j(qc), j(codes), j(ids), L=L, n_beam=W),
        jref.fused_expand_bin_ref(j(qc), j(codes), j(ids), L, W))],
        exact=True)
    if W > 1:
        assert out[3].sum() > 0, "the injected ties were not counted"
        if case == "blank_expansion":
            _blank_counted(out, ids, W, M, W - 1)
    elif case == "blank_expansion":
        assert np.isinf(out[0]).all() and (out[1] == -1).all()


# --------------------------------------------------------------------------
# on the card: the four CUDA kernels vs their plain versions
# --------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _on(dev, *arrays):
    return [torch.as_tensor(np.array(a), device=dev) for a in arrays]


@pytest.mark.cuda
@pytest.mark.parametrize("m", [8, 16, 32])
def test_cuda_pq4_kernels_match_plain(cuda, m):
    """m=8 takes the byte-at-a-time path, 16 and 32 the 8-byte loads."""
    lut, packed, ids = _on(cuda, *_pq4_case(m, 64, 96, 5000, m))
    before = tops.launch_counts()
    np.testing.assert_allclose(
        tops.pq4_adc(lut, packed, ids).cpu().numpy(),
        tref.pq4_adc_ref(lut, packed, ids).cpu().numpy(), **TOL)
    out = [t.cpu().numpy() for t in tops.fused_expand_pq4(
        lut, packed, ids, L=64, n_beam=4)]
    exp = [t.cpu().numpy() for t in tref.fused_expand_pq4_ref(
        lut, packed, ids, 64, 4)]
    _same_block(out, [exp])
    after = tops.launch_counts()
    assert after["pq4_adc"] == before["pq4_adc"] + 1
    assert after["fused_expand_pq4"] == before["fused_expand_pq4"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("case", ["random", "all_ties"])
@pytest.mark.parametrize("d", [70, 96, 200])
def test_cuda_bin_kernels_equal_plain(cuda, d, case):
    qc, codes, ids = _bin_case(d, 64, 96, 5000, d)
    if case == "all_ties":
        codes[:] = codes[0]
    _inject_ties(ids, 4, 24)
    qc, codes = _words(qc).to(cuda), _words(codes).to(cuda)
    ids = torch.as_tensor(ids, device=cuda)
    before = tops.launch_counts()
    assert torch.equal(tops.bin_dist(qc, codes, ids),
                       tref.bin_dist_ref(qc, codes, ids))
    for L in (64, 320):
        out = tops.fused_expand_bin(qc, codes, ids, L=L, n_beam=4)
        exp = tref.fused_expand_bin_ref(qc, codes, ids, L, 4)
        assert all(torch.equal(a, b) for a, b in zip(out, exp)), L
    after = tops.launch_counts()
    assert after["bin_dist"] == before["bin_dist"] + 1
    assert after["fused_expand_bin"] == before["fused_expand_bin"] + 2


@pytest.mark.cuda
@pytest.mark.parametrize("C,W,blank", [
    (1, 1, False), (4, 1, False), (96, 1, False), (96, 8, False),
    (128, 1, False), (128, 8, False), (129, 1, False), (96, 4, True)])
def test_cuda_fused_pq4_bin_shapes_equal_plain(cuda, C, W, blank):
    """Both fused steps at the edges of the sort in one warp's registers
    (C = 1, 4, 96, 128; 129 takes the block path), at W = 1 and 8, and
    with expansion 1's ids all -1: every output equal to the plain
    version's, at T = C and at a cut T. PQ4 also over tables of
    1 + k * 2^-20 (k < 8), whose sums differ in their last bits only: the
    kernel's 32-bit sort keys then tie and its exact order is restored."""
    M = C // W
    lut, packed, ids = _pq4_case(C + W, 40, C, 3000, 16)
    near = (1 + np.random.default_rng(C).integers(0, 8, lut.shape)
            * 2.0 ** -20).astype(np.float32)
    qc, codes, _ = _bin_case(C + W, 40, C, 3000, 96)
    if W > 1:
        _inject_ties(ids, W, M)
    if blank:
        _blank(ids, W, M)
    lut, near, packed, ids = _on(cuda, lut, near, packed, ids)
    qc, codes = _words(qc).to(cuda), _words(codes).to(cuda)
    for L in (C, max(1, C // 2 + 1)):
        for out, exp in (
                (tops.fused_expand_pq4(lut, packed, ids, L=L, n_beam=W),
                 tref.fused_expand_pq4_ref(lut, packed, ids, L, W)),
                (tops.fused_expand_pq4(near, packed, ids, L=L, n_beam=W),
                 tref.fused_expand_pq4_ref(near, packed, ids, L, W)),
                (tops.fused_expand_bin(qc, codes, ids, L=L, n_beam=W),
                 tref.fused_expand_bin_ref(qc, codes, ids, L, W))):
            assert all(torch.equal(a, b) for a, b in zip(out, exp)), (L, W)
