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


def test_sorted_block_epilogue_matches_reference():
    """The shared epilogue on exact, tie-heavy distances (small integers),
    so any tie-order or tie-count difference shows."""
    r = np.random.default_rng(11)
    Q, W, M, L = 6, 4, 8, 20
    d = r.integers(0, 5, size=(Q, W * M)).astype(np.float32)
    ids = r.integers(-1, 40, size=(Q, W * M)).astype(np.int32)
    out = [t.numpy() for t in tref.sorted_block_ref(_t(d), _t(ids), L, W)]
    exp = [np.asarray(a) for a in jref.sorted_block_ref(
        jnp.asarray(d), jnp.asarray(ids), L, W)]
    for a, b in zip(out, exp):
        assert np.array_equal(a, b)


KERNELS = ("gather_dist", "fused_expand", "batch_dist", "sq_gather_dist",
           "fused_expand_sq", "pq_adc", "fused_expand_pq")


def _quant_case(seed, Q, n, d, m):
    """SQ codes, scale, zero and PQ tables, codes for _case's shapes."""
    r = np.random.default_rng(seed)
    sq = (r.integers(0, 256, size=(n, d)).astype(np.uint8),
          (r.random(d) * 0.02 + 1e-3).astype(np.float32),
          (-r.random(d)).astype(np.float32))
    pq = (r.normal(size=(Q, m, 256)).astype(np.float32),
          r.integers(0, 256, size=(n, m)).astype(np.uint8))
    return sq, pq


def test_cpu_wrappers_launch_nothing():
    tops.reset_launch_counts()
    q, db, ids = _case(1, 3, 8, 40, 96)
    (codes, scale, zero), (lut, pcodes) = _quant_case(1, 3, 40, 96, 16)
    q, db, ids, codes, scale, zero, lut, pcodes = (
        _t(a) for a in (q, db, ids, codes, scale, zero, lut, pcodes))
    tops.gather_dist(q, db, ids)
    tops.fused_expand(q, db, ids, L=4, n_beam=2)
    tops.batch_dist(q, db)
    tops.sq_gather_dist(q, codes, scale, zero, ids)
    tops.fused_expand_sq(q, codes, scale, zero, ids, L=4, n_beam=2)
    tops.pq_adc(lut, pcodes, ids)
    tops.fused_expand_pq(lut, pcodes, ids, L=4, n_beam=2)
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
    (codes, scale, zero), (lut, pcodes) = (
        tuple(torch.as_tensor(a, device=cuda) for a in part)
        for part in _quant_case(4, 64, 5000, 96, 16))
    _close(tops.sq_gather_dist(q, codes, scale, zero, ids, metric=metric),
           tref.sq_gather_dist_ref(q, codes, scale, zero, ids, metric))
    _close(tops.pq_adc(lut, pcodes, ids), tref.pq_adc_ref(lut, pcodes, ids))
    for out, exp in (
            (tops.fused_expand_sq(q, codes, scale, zero, ids, metric=metric,
                                  L=64, n_beam=4),
             tref.fused_expand_sq_ref(q, codes, scale, zero, ids, metric, 64,
                                      4)),
            (tops.fused_expand_pq(lut, pcodes, ids, L=64, n_beam=4),
             tref.fused_expand_pq_ref(lut, pcodes, ids, 64, 4))):
        _close(out[0], exp[0])
        _close(out[2], exp[2])
        assert torch.equal(out[1], exp[1]) and torch.equal(out[3], exp[3])
    after = tops.launch_counts()
    assert set(after) == set(KERNELS)
    assert all(after[k] == before[k] + 1 for k in after)


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


@pytest.mark.parametrize("path", _port_files(), ids=lambda p: p.name)
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
