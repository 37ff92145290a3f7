"""The port's kernels (src/repro_torch/kernels) against the JAX package's.

On the CPU `repro_torch.kernels.ops` runs each kernel's plain torch
version; it is held against the JAX package's Pallas kernel (interpret
mode) and its jnp oracle in `repro/kernels/ref.py`, on the same numpy
inputs. Tolerance: f32 distances rtol=3e-5 / atol=3e-4, the reference's
own (tests/test_kernels.py); ids and tie counts exactly. The `cuda` tests
hold the CUDA kernels against the plain versions on the card and skip
without one. The isolation tests pin that the port imports neither jax
nor the JAX package.
"""
import ast
import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from torch_reference_cache import jax_maps_below_limit  # noqa: F401

# parallel test workers share the cores: one torch thread each keeps the
# many small eager ops from oversubscribing them
torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
TOL = dict(rtol=3e-5, atol=3e-4)


def _case(seed, Q, C, n, d, invalid=0.1):
    r = np.random.default_rng(seed)
    q = r.normal(size=(Q, d)).astype(np.float32)
    db = r.normal(size=(n, d)).astype(np.float32)
    ids = r.integers(0, n, size=(Q, C)).astype(np.int32)
    ids[r.random((Q, C)) < invalid] = -1
    return q, db, ids


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("Q,B,d", [(1, 7, 96), (16, 130, 100), (9, 64, 128)])
def test_batch_dist_matches_reference(metric, Q, B, d):
    r = np.random.default_rng(Q * B + d)
    q = r.normal(size=(Q, d)).astype(np.float32)
    x = r.normal(size=(B, d)).astype(np.float32)
    out = tops.batch_dist(_t(q), _t(x), metric=metric).numpy()
    kern = np.asarray(jops.batch_dist(jnp.asarray(q), jnp.asarray(x),
                                      metric=metric, tq=16, tb=32))
    oracle = np.asarray(jref.batch_dist_ref(jnp.asarray(q), jnp.asarray(x),
                                            metric))
    np.testing.assert_allclose(out, kern, **TOL)
    np.testing.assert_allclose(out, oracle, **TOL)
    np.testing.assert_allclose(tref.batch_dist_ref(_t(q), _t(x), metric),
                               out, **TOL)


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("Q,M,n,d", [(4, 8, 100, 96), (9, 33, 257, 100),
                                     (3, 24, 60, 128)])
def test_gather_dist_matches_reference(metric, Q, M, n, d):
    q, db, ids = _case(Q + M + d, Q, M, n, d)
    out = tops.gather_dist(_t(q), _t(db), _t(ids), metric=metric).numpy()
    kern = np.asarray(jops.gather_dist(jnp.asarray(q), jnp.asarray(db),
                                       jnp.asarray(ids), metric=metric))
    oracle = np.asarray(jref.gather_dist_ref(
        jnp.asarray(q), jnp.asarray(db), jnp.asarray(ids), metric))
    assert np.array_equal(np.isinf(out), ids < 0)
    np.testing.assert_allclose(out, kern, **TOL)
    np.testing.assert_allclose(out, oracle, **TOL)


@pytest.mark.parametrize("metric", ["l2", "ip", "cosine"])
def test_distance_functions_match_reference(metric):
    """core/distance.py: each formula as the JAX package's."""
    from repro.core import distance as jdist
    from repro_torch.core import distance as tdist
    r = np.random.default_rng(7)
    q = r.normal(size=(5, 96)).astype(np.float32)
    x = r.normal(size=(40, 96)).astype(np.float32)
    xs = r.normal(size=(5, 12, 96)).astype(np.float32)
    j, t = jnp.asarray, _t
    np.testing.assert_allclose(tdist.normalize(t(x)),
                               np.asarray(jdist.normalize(j(x))), **TOL)
    np.testing.assert_allclose(tdist.pairwise(t(q), t(x), metric),
                               np.asarray(jdist.pairwise(j(q), j(x), metric)),
                               **TOL)
    np.testing.assert_allclose(
        tdist.one_to_many(t(q[0]), t(x), metric),
        np.asarray(jdist.one_to_many(j(q[0]), j(x), metric)), **TOL)
    np.testing.assert_allclose(
        tdist.batched_one_to_many(t(q), t(xs), metric),
        np.asarray(jdist.batched_one_to_many(j(q), j(xs), metric)), **TOL)


def test_gather_dist_all_invalid():
    q, db, _ = _case(0, 2, 5, 50, 96)
    ids = np.full((2, 5), -1, np.int32)
    out = tops.gather_dist(_t(q), _t(db), _t(ids)).numpy()
    assert np.all(np.isinf(out))


@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("W,M,L,d", [
    (1, 8, 8, 96),      # W=1, L = C
    (2, 12, 16, 100),   # L < C
    (4, 24, 64, 96),    # the deep_like preset's step, L < C
    (4, 6, 32, 128),    # L > C: block shorter than the queue
    (3, 7, 16, 200),    # C=21 (a ragged warp) at the t2i_like d
    (4, 64, 100, 96),   # C=256: the kernel's shared-memory sort, L < C
    (4, 32, 192, 100),  # C=128 (the widest register sort), L > C
])
def test_fused_expand_matches_reference(metric, W, M, L, d):
    Q, n = 5, 150
    C = W * M
    q, db, ids = _case(W * M + L + d, Q, C, n, d)
    # exact ties across expansions: repeat ids of earlier expansions
    for w in range(1, W):
        ids[:, w * M] = ids[:, 0]
        ids[:, w * M + 1] = ids[:, (w - 1) * M + 2]
        # rows 0-1: expansion w repeats expansion 0 reversed, so its best
        # ties an earlier expansion's entry
        ids[:2, w * M:(w + 1) * M] = ids[:2, M - 1::-1]
    out = [t.numpy() for t in tops.fused_expand(
        _t(q), _t(db), _t(ids), metric=metric, L=L, n_beam=W)]
    kern = [np.asarray(a) for a in jops.fused_expand(
        jnp.asarray(q), jnp.asarray(db), jnp.asarray(ids), metric=metric,
        L=L, n_beam=W)]
    oracle = [np.asarray(a) for a in jref.fused_expand_ref(
        jnp.asarray(q), jnp.asarray(db), jnp.asarray(ids), metric, L, W)]
    for exp in (kern, oracle):
        np.testing.assert_allclose(out[0], exp[0], **TOL)   # sorted dists
        assert np.array_equal(out[1], exp[1])               # sorted ids
        np.testing.assert_allclose(out[2], exp[2], **TOL)   # bests
        assert np.array_equal(out[3], exp[3])               # tie counts
    assert out[0].shape == (Q, min(L, C)) and out[3].dtype == np.int32
    if W > 1:
        assert out[3].sum() > 0, "the injected ties were not counted"


@pytest.mark.parametrize("Q,W,M,L,signed_zeros", [
    (6, 4, 8, 20, False),
    (4, 4, 64, 100, False),   # C=256, L < C
    (6, 4, 8, 20, True),      # -0.0 and +0.0 tie, by position
])
def test_sorted_block_epilogue_matches_reference(Q, W, M, L, signed_zeros):
    """The shared epilogue on exact, tie-heavy distances (small integers),
    so any tie-order or tie-count difference shows."""
    r = np.random.default_rng(11)
    d = r.integers(0, 5, size=(Q, W * M)).astype(np.float32)
    if signed_zeros:             # 0 -> -0.0, 1 -> +0.0
        d = np.where(d == 0, np.float32(-0.0),
                     np.where(d == 1, np.float32(0.0), d))
    ids = r.integers(-1, 40, size=(Q, W * M)).astype(np.int32)
    out = [t.numpy() for t in tref.sorted_block_ref(_t(d), _t(ids), L, W)]
    exp = [np.asarray(a) for a in jref.sorted_block_ref(
        jnp.asarray(d), jnp.asarray(ids), L, W)]
    for a, b in zip(out, exp):
        assert np.array_equal(a, b)


KERNELS = ("gather_dist", "fused_expand", "batch_dist", "sq_gather_dist",
           "fused_expand_sq", "pq_adc", "fused_expand_pq", "pq4_adc",
           "fused_expand_pq4", "bin_dist", "fused_expand_bin", "ivf_scan",
           "pq4_ivf_scan", "bin_ivf_scan", "beam_filter")


def _lists(r, Q, P, nlist, max_len, n):
    """IVF list ids (-1 padded) and (Q, P) probes for the list scans."""
    ids = r.integers(-1, n, size=(nlist, max_len)).astype(np.int32)
    probes = r.integers(0, nlist, size=(Q, P)).astype(np.int32)
    return ids, probes


def _quant_case(seed, Q, n, d, m):
    """SQ codes, scale, zero and PQ tables, codes for _case's shapes."""
    r = np.random.default_rng(seed)
    sq = (r.integers(0, 256, size=(n, d)).astype(np.uint8),
          (r.random(d) * 0.02 + 1e-3).astype(np.float32),
          (-r.random(d)).astype(np.float32))
    pq = (r.normal(size=(Q, m, 256)).astype(np.float32),
          r.integers(0, 256, size=(n, m)).astype(np.uint8))
    pq4 = (r.normal(size=(Q, m, 16)).astype(np.float32),
           r.integers(0, 256, size=(n, m // 2)).astype(np.uint8))
    signs = (r.integers(-2 ** 31, 2 ** 31, size=(Q, 3)).astype(np.int32),
             r.integers(-2 ** 31, 2 ** 31, size=(n, 3)).astype(np.int32))
    return sq, pq, pq4, signs


def test_cpu_wrappers_launch_nothing():
    tops.reset_launch_counts()
    q, db, ids = _case(1, 3, 8, 40, 96)
    (codes, scale, zero), (lut, pcodes), (lut4, packed), (qw, words) = (
        tuple(_t(a) for a in part) for part in _quant_case(1, 3, 40, 96, 16))
    q, db, ids = _t(q), _t(db), _t(ids)
    tops.gather_dist(q, db, ids)
    tops.fused_expand(q, db, ids, L=4, n_beam=2)
    tops.batch_dist(q, db)
    tops.sq_gather_dist(q, codes, scale, zero, ids)
    tops.fused_expand_sq(q, codes, scale, zero, ids, L=4, n_beam=2)
    tops.pq_adc(lut, pcodes, ids)
    tops.fused_expand_pq(lut, pcodes, ids, L=4, n_beam=2)
    tops.pq4_adc(lut4, packed, ids)
    tops.fused_expand_pq4(lut4, packed, ids, L=4, n_beam=2)
    tops.bin_dist(qw, words, ids)
    tops.fused_expand_bin(qw, words, ids, L=4, n_beam=2)
    lids, probes = (_t(a) for a in _lists(np.random.default_rng(1), 3, 2, 5,
                                          8, 40))
    tops.ivf_scan(lut[:, None], pcodes[:40].reshape(5, 8, 16), lids, probes,
                  L=4)
    tops.pq4_ivf_scan(lut4[:, None], packed[:40].reshape(5, 8, 8), lids,
                      probes, L=4)
    tops.bin_ivf_scan(qw, words[:40].reshape(5, 8, 3), lids, probes, L=4)
    graph = (torch.arange(80, dtype=torch.int32) % 40).reshape(40, 2)
    tops.beam_filter(ids[:, :2].contiguous(), graph, ids)
    tops.beam_filter(ids[:, :2].contiguous(), graph, ids,
                     torch.zeros((3, 2), dtype=torch.int64))
    assert tops.launch_counts() == dict.fromkeys(KERNELS, 0)


# --------------------------------------------------------------------------
# on the card: CUDA kernels vs plain versions
# --------------------------------------------------------------------------
@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _close(a, b):
    np.testing.assert_allclose(a.cpu().numpy(), b.cpu().numpy(), **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "ip"])
def test_cuda_kernels_match_plain(cuda, metric):
    q, db, ids = _case(3, 64, 96, 5000, 96)
    q, db, ids = (torch.as_tensor(a, device=cuda) for a in (q, db, ids))
    before = tops.launch_counts()
    _close(tops.gather_dist(q, db, ids, metric=metric),
           tref.gather_dist_ref(q, db, ids, metric))
    out = tops.fused_expand(q, db, ids, metric=metric, L=64, n_beam=4)
    exp = tref.fused_expand_ref(q, db, ids, metric, 64, 4)
    _close(out[0], exp[0])
    _close(out[2], exp[2])
    assert torch.equal(out[1], exp[1]) and torch.equal(out[3], exp[3])
    _close(tops.batch_dist(q, db, metric=metric),
           tref.batch_dist_ref(q, db, metric))
    (codes, scale, zero), (lut, pcodes), (lut4, packed), (qw, words) = (
        tuple(torch.as_tensor(a, device=cuda) for a in part)
        for part in _quant_case(4, 64, 5000, 96, 16))
    _close(tops.sq_gather_dist(q, codes, scale, zero, ids, metric=metric),
           tref.sq_gather_dist_ref(q, codes, scale, zero, ids, metric))
    assert torch.equal(tops.pq_adc(lut, pcodes, ids),
                       tref.pq_adc_ref(lut, pcodes, ids))
    assert torch.equal(tops.pq4_adc(lut4, packed, ids),
                       tref.pq4_adc_ref(lut4, packed, ids))
    assert torch.equal(tops.bin_dist(qw, words, ids),
                       tref.bin_dist_ref(qw, words, ids))
    for out, exp in (
            (tops.fused_expand_sq(q, codes, scale, zero, ids, metric=metric,
                                  L=64, n_beam=4),
             tref.fused_expand_sq_ref(q, codes, scale, zero, ids, metric, 64,
                                      4)),
            (tops.fused_expand_pq(lut, pcodes, ids, L=64, n_beam=4),
             tref.fused_expand_pq_ref(lut, pcodes, ids, 64, 4)),
            (tops.fused_expand_pq4(lut4, packed, ids, L=64, n_beam=4),
             tref.fused_expand_pq4_ref(lut4, packed, ids, 64, 4)),
            (tops.fused_expand_bin(qw, words, ids, L=64, n_beam=4),
             tref.fused_expand_bin_ref(qw, words, ids, 64, 4))):
        _close(out[0], exp[0])
        _close(out[2], exp[2])
        assert torch.equal(out[1], exp[1]) and torch.equal(out[3], exp[3])
    lids, probes = (torch.as_tensor(a, device=cuda) for a in _lists(
        np.random.default_rng(5), 64, 4, 100, 50, 5000))
    for out, exp in (
            (tops.ivf_scan(lut[:, None], pcodes.reshape(100, 50, 16), lids,
                           probes, L=20),
             tref.ivf_scan_ref(lut[:, None], pcodes.reshape(100, 50, 16),
                               lids, probes, 20)),
            (tops.pq4_ivf_scan(lut4[:, None], packed.reshape(100, 50, 8),
                               lids, probes, L=20),
             tref.pq4_ivf_scan_ref(lut4[:, None], packed.reshape(100, 50, 8),
                                   lids, probes, 20)),
            (tops.bin_ivf_scan(qw, words.reshape(100, 50, 3), lids, probes,
                               L=20),
             tref.bin_ivf_scan_ref(qw, words.reshape(100, 50, 3), lids,
                                   probes, 20))):
        assert torch.equal(out[0], exp[0]) and torch.equal(out[1], exp[1])
    graph = ids[:, :24].contiguous() % 64
    v = torch.where(ids[:, :4] >= 0, ids[:, :4] % 64, -1)
    for out, exp in zip(tops.beam_filter(v, graph, ids),
                        tref.beam_filter_ref(v, graph, ids)):
        assert torch.equal(out, exp)
    after = tops.launch_counts()
    assert set(after) == set(KERNELS)
    assert all(after[k] == before[k] + 1 for k in after)


def _bits_equal(a, b):
    """Bit for bit, the sign of a zero included."""
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


def _unaligned(codes, k=1):
    """`codes` copied k elements into a flat buffer (one byte for u8
    codes, one float for f32 rows): rows not aligned to more than that,
    so the kernels read them in narrower units."""
    flat = torch.zeros(codes.numel() + k, dtype=codes.dtype,
                       device=codes.device)
    flat[k:] = codes.reshape(-1)
    return flat[k:].view(codes.shape)


@pytest.mark.cuda
@pytest.mark.parametrize("kernel,m,K", [
    ("pq_adc", m, K) for m in (8, 12, 16, 32) for K in (16, 256)] + [
    ("pq4_adc", m, 16) for m in (8, 16, 32)])
@pytest.mark.parametrize("B", [1, 8, 24, 33, 64])
def test_cuda_pq_gathers_equal_plain(cuda, kernel, m, K, B):
    """pq_adc and pq4_adc equal their plain versions bit for bit (both sum
    from +0.0 over j in order): query 0's ids all -1, query 1's one
    repeated id, every table's entry 0 of each subspace -0.0 and every
    seventh code row all zeros (a sum of -0.0 terms, +0.0), code rows
    aligned and at a 1-byte offset."""
    r = np.random.default_rng(m * K + B)
    Q, n = 40, 3000
    lut = r.normal(size=(Q, m, K)).astype(np.float32)
    lut[:, :, 0] = -0.0
    width = m if kernel == "pq_adc" else m // 2
    codes = r.integers(0, K if kernel == "pq_adc" else 256,
                       size=(n, width)).astype(np.uint8)
    codes[::7] = 0
    ids = r.integers(0, n, size=(Q, B)).astype(np.int32)
    ids[r.random((Q, B)) < 0.1] = -1
    ids[0] = -1
    ids[1] = 7 * 5
    lut, codes, ids = (torch.as_tensor(a, device=cuda)
                       for a in (lut, codes, ids))
    fn, plain = ((tops.pq_adc, tref.pq_adc_ref) if kernel == "pq_adc"
                 else (tops.pq4_adc, tref.pq4_adc_ref))
    for c in (codes, _unaligned(codes)):
        out, exp = fn(lut, c, ids), plain(lut, c, ids)
        assert _bits_equal(out, exp)
        assert torch.isinf(out[0]).all() and (out[1] == 0).all()
        assert not torch.signbit(out[1]).any()


def _gather_case(seed, Q, M, n, d):
    """q, db, ids as _case (10% of ids -1), query 0's ids all -1 and
    query 1's one repeated id; _quant_case's SQ codes, scale and zero."""
    q, db, ids = _case(seed, Q, M, n, d)
    ids[0] = -1
    ids[1] = 5
    return (q, db, ids) + _quant_case(seed, Q, n, d, 16)[0]


def _check_gathers(q, db, codes, scale, zero, ids, metric):
    """Both gathers against their plain versions: distances to TOL, +inf
    exactly where an id is -1, one launch each."""
    before = tops.launch_counts()
    out = tops.gather_dist(q, db, ids, metric=metric)
    _close(out, tref.gather_dist_ref(q, db, ids, metric))
    assert torch.equal(torch.isinf(out), ids < 0)
    out = tops.sq_gather_dist(q, codes, scale, zero, ids, metric=metric)
    _close(out, tref.sq_gather_dist_ref(q, codes, scale, zero, ids, metric))
    assert torch.equal(torch.isinf(out), ids < 0)
    after = tops.launch_counts()
    assert after["gather_dist"] == before["gather_dist"] + 1
    assert after["sq_gather_dist"] == before["sq_gather_dist"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("M", [1, 8, 24, 640])
@pytest.mark.parametrize("d", [33, 96, 100, 128, 200])
def test_cuda_gathers_match_plain(cuda, d, M, metric):
    """gather_dist and sq_gather_dist on each of their unit paths (d = 33:
    single floats and code bytes; 96: float4 and code words in one pass;
    100, 128; 200: two passes) at the seed, step and re-rank depths;
    Q = 37 queries, so Q*M is no multiple of a block's candidates at
    M < 640."""
    Q, n = 37, 3000
    q, db, ids, codes, scale, zero = (
        torch.as_tensor(a, device=cuda)
        for a in _gather_case(d * 1000 + M, Q, M, n, d))
    _check_gathers(q, db, codes, scale, zero, ids, metric)


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("d", [96, 100, 128, 200])
def test_cuda_gathers_offset_rows(cuda, d, metric):
    """Rows one float into a flat buffer (float units), codes 1, 2, 4 and
    8 bytes in (bytes at 1 and 2, code words at 4 and 8), and queries,
    scale and zero one float in (read a float at a time)."""
    Q, M, n = 37, 24, 3000
    q, db, ids, codes, scale, zero = (
        torch.as_tensor(a, device=cuda)
        for a in _gather_case(d, Q, M, n, d))
    _check_gathers(q, _unaligned(db), codes, scale, zero, ids, metric)
    for k in (1, 2, 4, 8):
        _check_gathers(q, db, _unaligned(codes, k), scale, zero, ids, metric)
    _check_gathers(_unaligned(q), db, codes, _unaligned(scale),
                   _unaligned(zero), ids, metric)


@pytest.mark.cuda
def test_cuda_gathers_all_invalid_read_no_row(cuda):
    """ids all -1 give +inf and read no row: the database and the codes are
    empty tensors (no storage), so any row load would fault."""
    Q, M, d = 9, 24, 96
    q = torch.randn((Q, d), device=cuda)
    ids = torch.full((Q, M), -1, dtype=torch.int32, device=cuda)
    db = torch.empty((0, d), device=cuda)
    codes = torch.empty((0, d), dtype=torch.uint8, device=cuda)
    scale, zero = torch.ones(d, device=cuda), torch.zeros(d, device=cuda)
    for metric in ("l2", "ip"):
        for out in (tops.gather_dist(q, db, ids, metric=metric),
                    tops.sq_gather_dist(q, codes, scale, zero, ids,
                                        metric=metric)):
            assert torch.isinf(out).all() and (out > 0).all()
    torch.cuda.synchronize()


@pytest.mark.cuda
def test_cuda_gathers_refuse_more_pairs_than_int32(cuda):
    """Q*M = 2^31 pairs (past the int32 index of the flat layout): both
    launchers refuse, nothing is launched."""
    Q, M, d = 2 ** 16, 2 ** 15, 4
    q = torch.zeros((Q, d), device=cuda)
    ids = torch.empty((Q, M), dtype=torch.int32, device=cuda)
    db = torch.zeros((8, d), device=cuda)
    codes = torch.zeros((8, d), dtype=torch.uint8, device=cuda)
    scale, zero = torch.ones(d, device=cuda), torch.zeros(d, device=cuda)
    before = tops.launch_counts()
    with pytest.raises(RuntimeError, match="^gather_dist launch failed"):
        tops.gather_dist(q, db, ids)
    with pytest.raises(RuntimeError, match="^sq_gather_dist launch failed"):
        tops.sq_gather_dist(q, codes, scale, zero, ids)
    assert tops.launch_counts() == before
    del ids
    torch.cuda.empty_cache()


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("d", [1, 3, 96, 97, 128, 960])
def test_cuda_batch_dist_ragged(cuda, metric, d):
    """The tiled product at ragged Q, B (tile edges of 128) and d (d % 4
    != 0 takes 4-byte loads; d above 96 runs in chunks) against its plain
    version."""
    r = np.random.default_rng(d)
    q, x = (torch.as_tensor(r.normal(size=(1000, d)).astype(np.float32),
                            device=cuda) for _ in range(2))
    before = tops.launch_counts()["batch_dist"]
    for Q in (1, 127, 129, 1000):
        for B in (1, 127, 129, 1000):
            _close(tops.batch_dist(q[:Q], x[:B], metric=metric),
                   tref.batch_dist_ref(q[:Q], x[:B], metric))
    assert tops.launch_counts()["batch_dist"] == before + 16


@pytest.mark.cuda
@pytest.mark.parametrize("Q,B,d,offset", [
    (1000, 100_000, 96, 0),     # more tiles than the grid: query tiles change
    (129, 50_000, 96, 0),       # two query tiles, each kept while B tiles pass
    (300, 20_000, 960, 0),      # d in chunks over many tiles
    (1000, 30_000, 96, 1)])     # rows not 16-byte aligned: the 4-byte path
def test_cuda_batch_dist_many_tiles(cuda, Q, B, d, offset):
    r = np.random.default_rng(Q + B + d)
    q = torch.as_tensor(r.normal(size=(Q, d)).astype(np.float32), device=cuda)
    flat = torch.as_tensor(r.normal(size=B * d + offset).astype(np.float32),
                           device=cuda)
    x = flat[offset:].view(B, d)
    for metric in ("l2", "ip"):
        _close(tops.batch_dist(q, x, metric=metric),
               tref.batch_dist_ref(q, x, metric))


# the fused steps' branches: C -> (W, L); C <= 128 sorts in one warp's
# registers (21: a ragged warp; 128: the widest), larger C in shared memory
_FUSED_C = {21: (3, 32), 96: (4, 96), 128: (4, 192), 256: (4, 100),
            4096: (4, 320)}


def _fused_ids(r, Q, C, W, n):
    """Random ids, 10% -1; the first 8 slots on rows 0-39 (zero rows in
    _fused_rows) and slot 8 of query i on row 40 + i (its copy);
    expansions repeating earlier expansions' ids (exact ties), on queries
    0 and 2 expansion 0 reversed (so each best ties); query 1 all -1."""
    ids = r.integers(0, n, size=(Q, C)).astype(np.int32)
    ids[r.random((Q, C)) < 0.1] = -1
    ids[:, :8] = r.integers(0, 40, size=(Q, 8))
    ids[:, 8] = 40 + np.arange(Q)
    M = C // W
    for w in range(1, W):
        ids[:, w * M] = ids[:, 0]
        ids[:, w * M + 1] = ids[:, (w - 1) * M + 2]
        ids[[0, 2], w * M:(w + 1) * M] = ids[[0, 2], M - 1::-1]
    ids[1] = -1
    return ids


def _fused_rows(r, Q, n, d, data):
    """(q, db, sq codes, scale, zero) for the fused steps. "int": small
    integers (SQ: scale 1, zero -128), so every distance is exact in any
    summation order and ties are everywhere; rows 0-39 are zero (ip
    distance -0.0) and row 40 + i equals query i (l2 distance +0.0).
    "normal": Gaussian rows and the SQ ranges of the other tests."""
    if data == "int":
        q = r.integers(-3, 4, size=(Q, d)).astype(np.float32)
        db = r.integers(-3, 4, size=(n, d)).astype(np.float32)
        codes = r.integers(0, 256, size=(n, d)).astype(np.uint8)
        scale = np.ones(d, np.float32)
        zero = np.full(d, -128.0, np.float32)
        db[:40], codes[:40] = 0.0, 128
        db[40:40 + Q], codes[40:40 + Q] = q, q + 128
    else:
        q = r.normal(size=(Q, d)).astype(np.float32)
        db = r.normal(size=(n, d)).astype(np.float32)
        codes = r.integers(0, 256, size=(n, d)).astype(np.uint8)
        scale = (r.random(d) * 0.02 + 1e-3).astype(np.float32)
        zero = (-r.random(d)).astype(np.float32)
    return q, db, codes, scale, zero


def _check_fused(out, exp, exact):
    """A fused block against its plain version: with `exact` every output
    equal; else dists and bests to TOL, tie counts equal, and ids equal
    wherever the sorted distance is apart from both neighbours by more
    than TOL's atol (near-ties may swap, as the sums' order differs)."""
    if exact:
        assert all(torch.equal(a, b) for a, b in zip(out, exp))
        return
    _close(out[0], exp[0])
    _close(out[2], exp[2])
    assert torch.equal(out[3], exp[3])
    sd = exp[0]
    gap = (sd[:, 1:] - sd[:, :-1]).abs().nan_to_num(0.0) > TOL["atol"]
    sep = torch.ones_like(sd, dtype=torch.bool)
    sep[:, 1:] &= gap
    sep[:, :-1] &= gap
    assert torch.equal(out[1][sep], exp[1][sep])
    inf = ~torch.isfinite(sd)
    assert torch.equal(out[1][inf], exp[1][inf])


@pytest.mark.cuda
@pytest.mark.parametrize("data", ["int", "normal"])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("d", [7, 96, 100, 128, 200])
@pytest.mark.parametrize("C", sorted(_FUSED_C))
def test_cuda_fused_expand_branches(cuda, C, d, metric, data):
    """fused_expand and fused_expand_sq at every scorer branch (d = 96:
    three float4 a lane; 100, 128, 200: four, 200 in two passes; 7: the
    scalar path; SQ 16-, 8-, 4- and 1-byte units) and every sort branch,
    on tie storms (repeated ids, integer distances, -0.0 and +0.0) and on
    a query whose ids are all -1."""
    W, L = _FUSED_C[C]
    r = np.random.default_rng(C * 1000 + d)
    Q, n = 16, 3000
    q, db, codes, scale, zero = (torch.as_tensor(a, device=cuda) for a in
                                 _fused_rows(r, Q, n, d, data))
    ids = torch.as_tensor(_fused_ids(r, Q, C, W, n), device=cuda)
    before = tops.launch_counts()
    out = tops.fused_expand(q, db, ids, metric=metric, L=L, n_beam=W)
    exp = tref.fused_expand_ref(q, db, ids, metric, L, W)
    _check_fused(out, exp, data == "int")
    out = tops.fused_expand_sq(q, codes, scale, zero, ids, metric=metric,
                               L=L, n_beam=W)
    exp = tref.fused_expand_sq_ref(q, codes, scale, zero, ids, metric, L, W)
    _check_fused(out, exp, data == "int")
    assert int(exp[3].sum()) > 0, "no injected tie was counted"
    assert not torch.isfinite(out[0][1]).any() and (out[1][1] == -1).all()
    after = tops.launch_counts()
    assert after["fused_expand"] == before["fused_expand"] + 1
    assert after["fused_expand_sq"] == before["fused_expand_sq"] + 1


@pytest.mark.cuda
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("d", [96, 100, 128, 200])
def test_cuda_fused_expand_unaligned_rows(cuda, d, metric):
    """Row-misaligned views of the database and the SQ codes take the
    scalar units (4-byte floats, single code bytes)."""
    r = np.random.default_rng(d)
    Q, n, W, C, L = 16, 3000, 4, 96, 96
    q, db, codes, scale, zero = _fused_rows(r, Q, n, d, "int")
    ids = torch.as_tensor(_fused_ids(r, Q, C, W, n), device=cuda)
    flat = torch.zeros(n * d + 1, device=cuda)
    flat[1:] = torch.as_tensor(db.ravel(), device=cuda)
    bytes_ = torch.zeros(n * d + 1, dtype=torch.uint8, device=cuda)
    bytes_[1:] = torch.as_tensor(codes.ravel(), device=cuda)
    q, scale, zero = (torch.as_tensor(a, device=cuda) for a in (q, scale,
                                                                  zero))
    db, codes = flat[1:].view(n, d), bytes_[1:].view(n, d)
    _check_fused(tops.fused_expand(q, db, ids, metric=metric, L=L, n_beam=W),
                 tref.fused_expand_ref(q, db, ids, metric, L, W), True)
    _check_fused(tops.fused_expand_sq(q, codes, scale, zero, ids,
                                      metric=metric, L=L, n_beam=W),
                 tref.fused_expand_sq_ref(q, codes, scale, zero, ids, metric,
                                          L, W), True)


@pytest.mark.cuda
@pytest.mark.parametrize("offset", [0, 1])
@pytest.mark.parametrize("metric", ["l2", "ip"])
@pytest.mark.parametrize("d", [7, 96, 100, 128, 200])
def test_cuda_gather_dist_bit_equal_fused_expand(cuda, d, metric, offset):
    """gather_dist sums a row over fused_expand's lanes and units, in the
    same order (distances.cuh), so every distance the fused step sorts
    equals gather_dist's for the same id bit for bit, rows aligned and
    one float into a flat buffer (float units)."""
    r = np.random.default_rng(d + offset)
    Q, n, W, C = 16, 3000, 4, 96
    q, db, _, _, _ = (torch.as_tensor(a, device=cuda) for a in
                      _fused_rows(r, Q, n, d, "normal"))
    ids = torch.as_tensor(_fused_ids(r, Q, C, W, n), device=cuda)
    if offset:
        db = _unaligned(db)
    sd, si, _, _ = tops.fused_expand(q, db, ids, metric=metric, L=C,
                                     n_beam=W)
    assert _bits_equal(tops.gather_dist(q, db, si, metric=metric), sd)
    assert torch.isfinite(sd[0]).any()


@pytest.mark.cuda
@pytest.mark.parametrize("C", sorted(_FUSED_C))
def test_cuda_fused_epilogue_other_kinds(cuda, C):
    """fused_expand_pq, fused_expand_pq4 and fused_expand_bin through the
    shared epilogue at each sort branch: integer tables (exact sums, so
    tie storms) and sign words, every output equal to the plain
    version's."""
    W, L = _FUSED_C[C]
    r = np.random.default_rng(C)
    Q, n, m = 16, 3000, 16
    ids = torch.as_tensor(_fused_ids(r, Q, C, W, n), device=cuda)
    lut = torch.as_tensor(r.integers(-4, 5, size=(Q, m, 256)).astype(
        np.float32), device=cuda)
    lut4 = torch.as_tensor(r.integers(-4, 5, size=(Q, m, 16)).astype(
        np.float32), device=cuda)
    pcodes, packed = (torch.as_tensor(r.integers(0, 256, size=(n, k)).astype(
        np.uint8), device=cuda) for k in (m, m // 2))
    qw, words = (torch.as_tensor(r.integers(-2 ** 31, 2 ** 31, size=(k, 3))
                                 .astype(np.int32), device=cuda)
                 for k in (Q, n))
    for out, exp in (
            (tops.fused_expand_pq(lut, pcodes, ids, L=L, n_beam=W),
             tref.fused_expand_pq_ref(lut, pcodes, ids, L, W)),
            (tops.fused_expand_pq4(lut4, packed, ids, L=L, n_beam=W),
             tref.fused_expand_pq4_ref(lut4, packed, ids, L, W)),
            (tops.fused_expand_bin(qw, words, ids, L=L, n_beam=W),
             tref.fused_expand_bin_ref(qw, words, ids, L, W))):
        _check_fused(out, exp, True)
        assert int(exp[3].sum()) > 0, "no injected tie was counted"


# fused_expand_pq's scorer paths: case -> (m, K, W, M, L, share of ids
# -1, codes at a 1-byte offset, tables at a 4-byte offset). m % 16 == 0
# with aligned code rows loads 16 bytes a row; other m or offset codes a
# byte at a time, m = 5 in one ragged chunk of table loads. Nothing bounds
# m*K: m=256 over K=256 (256 KB tables, more than a block's shared memory)
_PQ_STEP_CASES = {"main": (16, 256, 4, 24, 96, 0.1, False, False),
                  "codes_offset": (16, 256, 4, 24, 96, 0.1, True, False),
                  "m12_K64": (12, 64, 4, 24, 96, 0.1, False, False),
                  "m32": (32, 256, 4, 24, 96, 0.1, False, False),
                  "C128": (16, 256, 4, 32, 192, 0.1, False, False),
                  "C192": (16, 256, 8, 24, 96, 0.1, False, False),
                  "valid66": (16, 256, 4, 24, 96, 0.34, False, False),
                  "tables_offset": (16, 256, 4, 24, 96, 0.1, False, True),
                  "m5_K3": (5, 3, 4, 24, 96, 0.1, False, False),
                  "m256": (256, 256, 4, 24, 96, 0.1, False, False)}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(_PQ_STEP_CASES))
def test_cuda_fused_expand_pq_scorer_paths(cuda, case):
    """fused_expand_pq on each way its codes and table entries are read,
    at both sort branches, every output equal to the plain version's:
    tables with entry 0 of each subspace -0.0 and every seventh
    code row all zeros (a sum of -0.0 terms is +0.0), repeated ids across
    expansions (exact ties) and query 1's ids all -1."""
    m, K, W, M, L, invalid, codes_off, table_off = _PQ_STEP_CASES[case]
    r = np.random.default_rng(m * K + W * M)
    Q, n, C = 16, 3000, W * M
    ids = _fused_ids(r, Q, C, W, n)
    ids[r.random((Q, C)) < invalid - 0.1] = -1
    lut = r.normal(size=(Q, m, K)).astype(np.float32)
    lut[:, :, 0] = -0.0
    codes = r.integers(0, K, size=(n, m)).astype(np.uint8)
    codes[::7] = 0
    lut, codes, ids = (torch.as_tensor(a, device=cuda)
                       for a in (lut, codes, ids))
    if codes_off:
        codes = _unaligned(codes)
    if table_off:
        lut = _unaligned(lut)
    before = tops.launch_counts()["fused_expand_pq"]
    out = tops.fused_expand_pq(lut, codes, ids, L=L, n_beam=W)
    exp = tref.fused_expand_pq_ref(lut, codes, ids, L, W)
    _check_fused(out, exp, True)
    assert not torch.isfinite(out[0][1]).any() and (out[1][1] == -1).all()
    assert int(exp[3].sum()) > 0, "no injected tie was counted"
    assert tops.launch_counts()["fused_expand_pq"] == before + 1


@pytest.mark.cuda
@pytest.mark.parametrize("nw", [1, 3, 4, 7, 9])
@pytest.mark.parametrize("B", [1, 8, 24, 33])
def test_cuda_bin_dist_paths(cuda, nw, B):
    """bin_dist at the word counts it unrolls (3, 4, 7: d = 96, 128, 200)
    and on its general path (1, 9, in chunks of 8 words), at the seed, step
    and ragged widths, equal to the plain version: query 0's ids all -1
    (+inf), query 1's one id repeated."""
    r = np.random.default_rng(nw * 100 + B)
    Q, n = 37, 3000
    qw, words = (torch.as_tensor(r.integers(-2 ** 31, 2 ** 31, size=(k, nw))
                                 .astype(np.int32), device=cuda)
                 for k in (Q, n))
    ids = r.integers(0, n, size=(Q, B)).astype(np.int32)
    ids[r.random((Q, B)) < 0.1] = -1
    ids[0] = -1
    ids[1] = ids[1, 0] if ids[1, 0] >= 0 else 5
    ids = torch.as_tensor(ids, device=cuda)
    before = tops.launch_counts()["bin_dist"]
    out = tops.bin_dist(qw, words, ids)
    assert torch.equal(out, tref.bin_dist_ref(qw, words, ids))
    assert torch.isinf(out[0]).all() and (out[1] == out[1, 0]).all()
    assert tops.launch_counts()["bin_dist"] == before + 1


# the PQ list scans' branches: case -> (max_len, L for PQ8, L for PQ4,
# tables). L <= 256 with the list's keys in shared memory takes the
# histogram select and the sort in one warp's registers; "nan" tables
# (+inf and NaN entries, L = max_len: +inf and NaN keys in the tail) and
# L = 300 (above that sort) take the general select on cached keys;
# 70,000 slots do not fit shared memory (keys recomputed on each pass,
# L above one round of 4,096)
_SCAN_CASES = {"main": (2176, 128, 192, "normal"),
               "short": (300, 250, 250, "normal"),      # a -1 tail
               "storm": (700, 128, 192, "storm"),
               "zeros": (500, 100, 200, "zeros"),
               "max_len": (200, 200, 200, "normal"),
               "max_len_general": (300, 300, 300, "normal"),
               "long": (20_000, 128, 192, "normal"),
               "nan": (256, 256, 256, "nan"),
               "rounds": (70_000, 5000, 5000, "normal")}
_SCAN_KERNELS = {"pq": (256, "ivf_scan", "ivf_scan_ref"),
                 "pq4": (16, "pq4_ivf_scan", "pq4_ivf_scan_ref")}


def _scan_operands(r, kind, m, Pl, Q, P, nlist, max_len, table):
    """Tables, codes, list ids and probes for the list-scan branch tests:
    ragged lists with 10% holes, list 0 all -1 and list 1 full; "storm":
    every code of list 1 equal (all its distances tie, so slot order
    decides); "zeros": small integers and ±0.0 with entry 0 -0.0 in every
    subspace and every third slot's codes 0 (exact sums, zero ties);
    "nan": about 2% of the entries +inf or NaN."""
    K = _SCAN_KERNELS[kind][0]
    width = m if K == 256 else m // 2
    if table == "zeros":
        luts = r.choice(np.array([-0.0, 0.0, -1.0, 1.0], np.float32),
                        size=(Q, Pl, m, K))
        luts[..., 0] = -0.0
    else:
        luts = r.normal(size=(Q, Pl, m, K)).astype(np.float32)
    if table == "nan":
        hit = r.random(luts.shape) < 0.02
        luts[hit] = r.choice(np.array([np.inf, np.nan], np.float32),
                             size=int(hit.sum()))
    codes = r.integers(0, 256, size=(nlist, max_len, width)).astype(np.uint8)
    if table == "zeros":
        codes[:, ::3] = 0
    ids = r.integers(0, 1_000_000, size=(nlist, max_len)).astype(np.int32)
    ids[np.arange(max_len)[None] >= r.integers(0, max_len + 1,
                                                size=(nlist, 1))] = -1
    ids[r.random((nlist, max_len)) < 0.1] = -1
    ids[0] = -1
    ids[1] = r.choice(1_000_000, size=max_len, replace=False)
    if table == "storm":
        codes[1] = codes[1, 0]
    probes = r.integers(0, nlist, size=(Q, P)).astype(np.int32)
    probes[:, 0] = 1
    probes[1, 1] = 0
    return luts, codes, ids, probes


@pytest.mark.cuda
@pytest.mark.parametrize("m", [8, 16, 32])
@pytest.mark.parametrize("case", sorted(_SCAN_CASES))
def test_cuda_list_scans_equal_plain(cuda, case, m):
    """ivf_scan and pq4_ivf_scan against their plain versions, distances
    (bit patterns) and ids exactly, at every branch of the kernel: tables
    per query (Pl = 1) and per probe (Pl = P), P = 11 probes (not a
    multiple of a block's probe group), a probe of the all -1 list, probes
    outside [0, nlist) (whole rows of (+inf, -1)), lists shorter than L,
    tie storms, ±0.0 tables, L = max_len, m = 8, 16, 32 (the scalar and
    the vector code loads)."""
    max_len, L8, L4, table = _SCAN_CASES[case]
    Q, P, nlist = 6, 11, 5
    before = tops.launch_counts()
    for kind, (K, name, plain) in _SCAN_KERNELS.items():
        L = L8 if K == 256 else L4
        for Pl in (1, P):
            r = np.random.default_rng([max_len, L, m, Pl, K])
            luts, codes, ids, probes = (
                torch.as_tensor(a, device=cuda) for a in _scan_operands(
                    r, kind, m, Pl, Q, P, nlist, max_len, table))
            bad = probes.clone()
            bad[2, 3], bad[3, 4] = -1, nlist
            out = getattr(tops, name)(luts, codes, ids, bad, L=L)
            exp = getattr(tref, plain)(luts, codes, ids, probes, L)
            edge = (bad != probes)[..., None].expand_as(exp[0])
            exp = (torch.where(edge, float("inf"), exp[0]),
                   torch.where(edge, -1, exp[1]))
            assert torch.equal(out[0].view(torch.int32),
                               exp[0].view(torch.int32)), (kind, Pl)
            assert torch.equal(out[1], exp[1]), (kind, Pl)
            if table == "storm":
                assert bool((exp[0][:, 0, 1:] == exp[0][:, 0, :-1]).all())
            if case == "short":      # a list with ids, then a -1 tail
                assert bool(((exp[1][..., 0] >= 0)
                             & (exp[1][..., -1] == -1)).any())
    after = tops.launch_counts()
    assert after["ivf_scan"] == before["ivf_scan"] + 2
    assert after["pq4_ivf_scan"] == before["pq4_ivf_scan"] + 2


# --------------------------------------------------------------------------
# import isolation
# --------------------------------------------------------------------------
def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_port_imports_neither_jax_nor_reference():
    mods = [".".join(p.relative_to(ROOT / "src").with_suffix("").parts)
            for p in _port_files() if "src" in p.parts]
    mods = [m[:-len(".__init__")] if m.endswith(".__init__") else m
            for m in mods]
    code = ("import importlib, sys\n"
            f"for m in {mods!r}: importlib.import_module(m)\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr


def _port_file_id(path):
    """The file's name; a file whose name an earlier port file already
    has (layers/common.py after analysis/common.py) adds its folder, so
    the earlier file keeps its id. `__init__.py` keeps pytest's numbering."""
    earlier = [p.name for p in _port_files() if p < path]
    if path.name in earlier and path.name != "__init__.py":
        return f"{path.parent.name}/{path.name}"
    return path.name


@pytest.mark.parametrize("path", _port_files(), ids=_port_file_id)
def test_port_source_has_no_jax_or_reference_import(path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names = [node.module or ""]
        else:
            continue
        for name in names:
            top = name.split(".")[0]
            assert top not in ("jax", "jaxlib", "repro"), \
                f"{path.name}:{node.lineno} imports {name}"
