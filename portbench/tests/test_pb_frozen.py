"""The yardstick's frozen copies: the data generator against the port's,
the reference against a NumPy brute force, the roofline arithmetic
against sectors counted by hand."""
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]

from pb import bounds, data, reference, spec  # noqa: E402
from pb.traffic import Traffic  # noqa: E402

deep_like = spec.module("datagen", "deep_like").generate


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 11])
def test_deep_like_is_the_ports_generator(seed):
    from repro_torch.data.vectors import make_dataset
    ds = make_dataset("deep_like", n=600, n_queries=40, k=10, seed=seed,
                      device="cpu")
    base, queries, metric = deep_like(600, 40, seed)
    assert metric == ds.metric == "ip"
    assert base.dtype == np.float32 and queries.dtype == np.float32
    assert np.array_equal(base, ds.base)
    assert np.array_equal(queries, ds.queries)


def test_unknown_generator_raises():
    with pytest.raises(ValueError, match="unknown data generator"):
        data.make({"generator": "sift_like", "n": 10, "seed": 0}, 2, 0)


def test_a_runs_seed_orders_the_same_vectors():
    entry = {"generator": "deep_like", "n": 300, "seed": 5}
    b0, q0, _ = deep_like(300, 20, 5)
    b1, q1, _ = data.make(entry, 20, 2 ** 31 + 3)
    b2, q2, _ = data.make(entry, 20, 2 ** 31 + 3)
    b3, q3, _ = data.make(entry, 20, 4)
    assert np.array_equal(b1, b2) and not np.array_equal(b1, b3)
    assert np.array_equal(q1, q0) and np.array_equal(q3, q0)
    for got in (b1, b3):
        assert np.array_equal(np.unique(got, axis=0), np.unique(b0, axis=0))


def test_a_runs_seed_orders_the_same_batches():
    mix = {"loop": "closed", "queries_per_call": 5, "query_pool": 20,
           "k": 10}
    pool = np.arange(20, dtype=np.float32)[:, None]
    a, b = Traffic(mix, pool, 1), Traffic(mix, pool, 2)
    assert not np.array_equal(a.pool, b.pool)
    for t in (a, b):
        batches = {frozenset(t.batch(i)[:, 0].tolist()) for i in range(4)}
        assert batches == {frozenset(range(s, s + 5)) for s in (0, 5, 10, 15)}
        assert [due for _, _, due in _first(t, 5)] == [None] * 5
        assert t.warm_batches() == [0]


def _first(traffic, n):
    return [r for _, r in zip(range(n), traffic.requests())]


OPEN = {"loop": "open", "query_pool": 3000, "k": 10,
        "request_sizes": [1, 64], "rate_per_s": 100.0,
        "burst": {"factor": 2.0, "every_s": 10.0, "for_s": 1.0}}


def test_an_open_mix_sends_the_same_requests_at_the_same_times():
    pool = np.arange(3000, dtype=np.float32)[:, None]
    a, b = Traffic(OPEN, pool, 1), Traffic(OPEN, pool, 2 ** 31 + 5)
    assert a.sizes.sum() == 3000 and a.sizes.min() >= 1
    assert a.sizes.max() <= 64
    assert sorted(a.sizes) == sorted(b.sizes)
    assert not np.array_equal(a.pool, b.pool)
    for t in (a, b):
        requests = {frozenset(t.batch(i)[:, 0].tolist())
                    for i in range(t.n_batches)}
        assert len(requests) == t.n_batches
        assert set().union(*requests) == set(range(3000))
    ta = [due for _, _, due in _first(a, 3000)]
    assert ta == [due for _, _, due in _first(b, 3000)]
    assert np.all(np.diff(ta) > 0)
    assert {len(a.batch(i)) for i in a.warm_batches()} == set(a.sizes)


def test_an_open_mix_keeps_its_rate_and_its_bursts():
    t = Traffic(dict(OPEN, query_pool=100000), np.zeros((100000, 1)), 3)
    due = np.array([d for _, _, d in _first(t, 20000)])
    due = due[due < 100.0]
    in_burst = (due % 10.0) < 1.0
    # 100 a second for 90 s and 200 a second for 10 s
    assert 11000 * 0.95 < len(due) < 11000 * 1.05
    assert 2000 * 0.9 < in_burst.sum() < 2000 * 1.1


def _numpy_topk(base, queries, k, metric):
    b, q = base.astype(np.float64), queries.astype(np.float64)
    if metric == "l2":
        d = ((q[:, None, :] - b[None]) ** 2).sum(-1)
    else:
        d = -(q @ b.T)
    ids = np.lexsort((np.broadcast_to(np.arange(len(b)), d.shape), d),
                     axis=1)[:, :k]
    return np.take_along_axis(d, ids, 1), ids


@pytest.mark.parametrize("metric", ["ip", "l2"])
def test_exact_topk_is_a_brute_force(metric):
    rng = np.random.default_rng(3)
    base = rng.normal(size=(700, 24)).astype(np.float32)
    queries = rng.normal(size=(45, 24)).astype(np.float32)
    want_d, want_i = _numpy_topk(base, queries, 10, metric)
    got_d, got_i = reference.exact_topk(base, queries, 10, metric, rows=16)
    assert np.array_equal(got_i, want_i)
    np.testing.assert_allclose(got_d, want_d, rtol=1e-5, atol=1e-4)
    ref = reference.exact_dists(base, queries, got_i, metric)
    np.testing.assert_allclose(ref, want_d, rtol=1e-12, atol=1e-12)


def test_exact_dists_marks_ids_outside_the_corpus():
    base = np.eye(4, dtype=np.float32)
    d = reference.exact_dists(base, base[:1], np.array([[0, -1, 4]]), "ip")
    assert d[0, 0] == -1.0 and np.isnan(d[0, 1]) and np.isnan(d[0, 2])


def test_round_tf32_keeps_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11 + 2 ** -13,
                      1.0 + 2 ** -12, -3.0 - 2 ** -9])
    got = reference.round_tf32(x)
    assert got.tolist() == [1.0 + 2 ** -10, 1.0 + 2 ** -10, 1.0,
                            -3.0 - 2 ** -9]


def test_row_sectors_by_hand():
    # 12-byte rows: row 2 spans bytes 24..35, two sectors; rows 0, 1 one
    assert bounds.row_sectors(4, 12, "cpu").tolist() == [32, 32, 64, 32]
    # 384-byte rows (d = 96 f32): 12 sectors each, aligned
    assert bounds.row_sectors(3, 384, "cpu").tolist() == [384] * 3
    ids = torch.tensor([[2, -1, 0], [2, 2, 1]])
    assert int(bounds.row_bytes(ids, 12)) == 64 + 32 + 64 + 64 + 32
    spans = bounds.row_sectors(4, 12, "cpu")
    # distinct rows 0, 1, 2 once each
    assert int(bounds.distinct_row_bytes(ids, spans)) == 32 + 32 + 64
    assert int(bounds.valid_count(ids)) == 5


def test_table_and_scan_bytes_by_hand():
    # 2 lists of 3 slots, m = 2 subspaces of K = 16 entries (2 sectors a
    # subspace row: codes 0-7 in the first, 8-15 in the second)
    list_ids = torch.tensor([[5, 6, -1], [7, -1, -1]], dtype=torch.int32)
    codes = torch.tensor([[[0, 9], [1, 2], [15, 15]],
                          [[8, 8], [0, 0], [0, 0]]], dtype=torch.uint8)
    mask = bounds.table_mask(list_ids, codes, 32)   # K=32: 4 sectors
    assert mask.shape == (2, 2, 4)
    assert mask[0].nonzero().tolist() == [[0, 0], [1, 0], [1, 1]]
    assert mask[1].nonzero().tolist() == [[0, 1], [1, 1]]
    probes = torch.tensor([[0, 1], [1, 1]], dtype=torch.int32)
    # per query over the union: query 0 hits 4 sectors, query 1 hits 2
    assert int(bounds.table_bytes(mask, probes, False)) == 6 * 32
    # per (query, probe): 3 + 2 + 2 + 2
    assert int(bounds.table_bytes(mask, probes, True)) == 9 * 32
    n_valid = (list_ids >= 0).sum(1)
    # both lists used: 2 * 3 slots of ids, 3 valid code rows of 2 bytes,
    # 4 probes, 8 lead bytes, (2, 2, L=3) outputs of 8 bytes
    got = bounds.scan_bytes(list_ids, n_valid, 2, probes, 3, 8)
    assert int(got) == 2 * 3 * 4 + 3 * 2 + 4 * 4 + 8 + 2 * 2 * 3 * 8
    assert int(bounds.scanned_codes(n_valid, probes)) == 2 + 1 + 1 + 1


def test_bound_takes_the_larger_time():
    t, by = bounds.bound(3.35e9, 1.0)
    assert by == "bytes" and t == pytest.approx(1.0)
    t, by = bounds.bound(1.0, 67e9)
    assert by == "operations" and t == pytest.approx(1.0)
