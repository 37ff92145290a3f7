"""The port's queue (src/repro_torch/core/queue.py) against the JAX
package's, bit for bit.

The reference writes each function for one query and lifts it with
jax.vmap; the port takes the batch axis directly. Every case builds a
batch of random sorted queues and candidate blocks with numpy (the
generators of tests/test_beam.py and tests/test_property.py), runs both,
and requires equal arrays. The seeded sweeps always run; the hypothesis
drivers run where hypothesis is installed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import queue as rq
from repro_torch.core import queue as tq

# parallel test workers share the cores: one torch thread each keeps the
# many small eager ops from oversubscribing them
torch.set_num_threads(1)


def _random_queues(r, Q, L, id_range=10_000):
    """Q sorted queues as numpy arrays (dists, ids, visited)."""
    D = np.full((Q, L), np.inf, np.float32)
    I = np.full((Q, L), -1, np.int32)
    V = np.ones((Q, L), bool)
    for i in range(Q):
        n_filled = int(r.integers(0, L + 1))
        d = np.full(L, np.inf, np.float32)
        ids = np.full(L, -1, np.int64)
        d[:n_filled] = r.normal(size=n_filled).astype(np.float32)
        # a few exact ties inside the queue
        if n_filled > 2:
            d[1] = d[0]
        ids[:n_filled] = r.choice(id_range, size=n_filled, replace=False)
        vis = np.ones(L, bool)
        vis[:n_filled] = r.random(n_filled) < 0.5
        order = np.argsort(d, kind="stable")
        D[i], I[i], V[i] = d[order], ids[order], vis[order]
    return D, I, V


def _block(r, Q, C, id_hi=40, D=None):
    """Candidate block; some dists copied from the queue for exact ties."""
    nd = r.normal(size=(Q, C)).astype(np.float32)
    ni = r.integers(-1, id_hi, size=(Q, C)).astype(np.int32)
    if D is not None and C > 1:
        nd[:, 0] = np.where(np.isfinite(D[:, 0]), D[:, 0], nd[:, 0])
    return nd, ni


def _j(*a):
    return [jnp.asarray(x) for x in a]


def _t(*a):
    return [torch.as_tensor(np.array(x)) for x in a]


def _eq(port, ref):
    if isinstance(port, (tuple, list)):
        assert len(port) == len(ref)
        for a, b in zip(port, ref):
            _eq(a, b)
        return
    a = port.numpy()
    b = np.asarray(ref)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.array_equal(a.astype(b.dtype) if a.dtype != b.dtype
                          and b.dtype == bool else a, b), (a, b)


# (L, W, M) shapes; fixed so jax compiles each op once per shape
SHAPES = [(8, 1, 5), (16, 2, 4), (20, 4, 3)]


def _check_all(seed, L, W, M, Q=4):
    r = np.random.default_rng(seed)
    C = W * M
    D, I, V = _random_queues(r, Q, L, id_range=40)
    nd, ni = _block(r, Q, C, D=D)
    rQ = rq.Queue(*_j(D, I, V))
    tQ = tq.Queue(*_t(D, I, V))

    _eq(tq.dup_prior_mask(_t(ni)[0]), jax.vmap(rq.dup_prior_mask)(_j(ni)[0]))
    _eq(tq.dedupe_ids(_t(ni)[0]), jax.vmap(rq.dedupe_ids)(_j(ni)[0]))
    _eq(tq.in_queue_mask(tQ, _t(ni)[0]),
        jax.vmap(rq.in_queue_mask)(rQ, _j(ni)[0]))
    _eq(tq._dedupe_new(tQ, *_t(nd, ni)),
        jax.vmap(rq._dedupe_new)(rQ, *_j(nd, ni)))
    _eq(tq.sort_block(*_t(nd, ni)), jax.vmap(rq.sort_block)(*_j(nd, ni)))

    # the merge family on a pre-deduped block, as the search loop feeds it
    dd, di = [np.asarray(a) for a in jax.vmap(rq._dedupe_new)(
        rQ, *_j(nd, ni))]
    sd, si = [np.asarray(a) for a in jax.vmap(rq.sort_block)(*_j(dd, di))]
    _eq(tq.merge_sorted_runs(tQ, *_t(sd, si)),
        jax.vmap(rq.merge_sorted_runs)(rQ, *_j(sd, si)))
    block = dd.reshape(Q, W, M)
    bests = block.min(axis=2)
    ties = np.asarray(jax.vmap(rq.beam_tie_counts)(*_j(block, bests)))
    _eq(tq.beam_tie_counts(*_t(block, bests)),
        jax.vmap(rq.beam_tie_counts)(*_j(block, bests)))
    _eq(tq.block_ranks(tQ, *_t(dd, bests, ties)),
        jax.vmap(rq.block_ranks)(rQ, *_j(dd, bests, ties)))
    _eq(tq.block_ranks(tQ, *_t(dd, bests)),
        jax.vmap(lambda q, a, b: rq.block_ranks(q, a, b))(rQ, *_j(dd, bests)))
    _eq(tq.merge_insert(tQ, *_t(nd, ni)),
        jax.vmap(rq.merge_insert)(rQ, *_j(nd, ni)))
    _eq(tq.merge_expand(tQ, *_t(dd, di), W),
        jax.vmap(lambda q, a, b: rq.merge_expand(q, a, b, W))(
            rQ, *_j(dd, di)))
    _eq(tq.merge_insert_beam(tQ, *_t(nd, ni), W),
        jax.vmap(lambda q, a, b: rq.merge_insert_beam(q, a, b, W))(
            rQ, *_j(nd, ni)))

    w = W + 1
    idxs, has = tq.pick_top_w(tQ, w)
    ridx, rhas = jax.vmap(lambda q: rq.pick_top_w(q, w))(rQ)
    _eq((idxs.to(torch.int32), has), (ridx, rhas))
    _eq(tq.pick_unvisited(tQ)[1], jax.vmap(rq.pick_unvisited)(rQ)[1])
    i1, h1 = tq.pick_unvisited(tQ)
    _eq(i1.to(torch.int32), jax.vmap(rq.pick_unvisited)(rQ)[0])
    do = r.random((Q, w)) < 0.6
    _eq(tq.mark_visited_many(tQ, idxs, torch.as_tensor(do)),
        jax.vmap(rq.mark_visited_many)(rQ, ridx, jnp.asarray(do)))
    _eq(tq.mark_visited(tQ, i1, torch.as_tensor(do[:, 0])),
        jax.vmap(rq.mark_visited)(rQ, jnp.asarray(np.asarray(i1)),
                                  jnp.asarray(do[:, 0])))
    k = L // 2
    _eq(tq.topk(tQ, k), jax.vmap(lambda q: rq.topk(q, k))(rQ))


def _check_property_merge(L, M, seed):
    """tests/test_property.py's merge_insert generator: wide id range."""
    r = np.random.default_rng(seed)
    D, I, V = _random_queues(r, 1, L)
    nd = r.normal(size=(1, M)).astype(np.float32)
    ni = r.integers(-1, 10_000, size=(1, M)).astype(np.int32)
    _eq(tq.merge_insert(tq.Queue(*_t(D, I, V)), *_t(nd, ni)),
        jax.vmap(rq.merge_insert)(rq.Queue(*_j(D, I, V)), *_j(nd, ni)))


def _check_idempotent(L, seed):
    """Re-inserting the queue's own content changes nothing (rank L)."""
    r = np.random.default_rng(seed)
    d = np.sort(r.normal(size=(1, L)).astype(np.float32), axis=1)
    ids = r.choice(100_000, size=(1, L), replace=False).astype(np.int32)
    vis = np.zeros((1, L), bool)
    out, rank, _ = tq.merge_insert(tq.Queue(*_t(d, ids, vis)), *_t(d, ids))
    assert np.array_equal(out.ids.numpy(), ids)
    assert int(rank[0]) == L


def test_init_queue_matches_reference():
    Q, L = 3, 7
    _eq(tq.init_queue(Q, L),
        jax.tree.map(lambda x: jnp.broadcast_to(x[None], (Q,) + x.shape),
                     rq.init_queue(L)))


@pytest.mark.parametrize("shape", SHAPES, ids=str)
@pytest.mark.parametrize("seed", range(3))
def test_queue_ops_bit_exact_seeded(seed, shape):
    _check_all(seed, *shape)


def test_merge_insert_property_cases_seeded():
    r = np.random.default_rng(5)
    for _ in range(10):
        _check_property_merge(12, 9, int(r.integers(0, 2 ** 30)))
        _check_idempotent(16, int(r.integers(0, 2 ** 30)))


# hypothesis drivers, where hypothesis is installed (the seeded sweeps
# above run either way, as in tests/test_beam.py)
try:
    from hypothesis import given, settings, strategies as st
except ImportError:
    given = None

if given is not None:
    @settings(max_examples=15, deadline=None)
    @given(st.integers(0, 2 ** 30), st.sampled_from(SHAPES))
    def test_queue_ops_bit_exact_property(seed, shape):
        _check_all(seed, *shape)

    @settings(max_examples=15, deadline=None)
    @given(st.integers(0, 2 ** 30))
    def test_merge_insert_property(seed):
        _check_property_merge(12, 9, seed)
