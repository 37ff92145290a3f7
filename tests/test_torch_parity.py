"""Tie-aware id parity between the port and the JAX package.

Where both packages rank candidates by float distances that they sum in
different orders (XLA's dot against torch's matmul or einsum), two
candidates whose distances lie within that rounding of each other may come
out in either order, and which order a host gives depends on its vector
unit. Example: deep_like (n=2,000) query 5 at k=80, where the reference
returns ids 1141 and 775 at positions 17 and 18 with distances
-0.43088335 and -0.4308833, one ulp apart, and a host whose torch sums
give -0.43088335 to both returns them the other way round.

`assert_same_ranking` holds the port's (dists, ids) to the reference's:
- distances to TOL (rtol=3e-5, atol=3e-4), +inf at the same places;
- in a row whose distances equal the reference's bit for bit, every id;
- in any other row, the id at every position whose reference distance is
  apart from both neighbours' by more than twice the row's largest
  difference between the two packages' distances (no rounding of either
  package can swap such a position), and inside each run of positions
  tied that closely, the multiset of ids;
- at most 1% of the finite positions inside such runs, so that a real
  ordering fault cannot hide behind the rule.
The tie width is the measured difference and not TOL itself: neighbours
in a top-80 of 2,000 deep_like rows lie a few 1e-3 apart, so a width of
TOL (about 3e-4) would tie many times the 1% the guard allows. The tests
below hold the rule to what it must accept and to the faults it must
catch.
"""
import numpy as np
import pytest

TOL = dict(rtol=3e-5, atol=3e-4)
MAX_TIED = 0.01


def tied_pairs(d_exp, d_out) -> np.ndarray:
    """(Q, k-1) bool: positions j and j+1 of a row lie within twice the
    row's largest finite |d_out - d_exp| of each other (never where that
    difference is 0)."""
    d0 = np.asarray(d_exp, np.float64)
    d1 = np.asarray(d_out, np.float64)
    fin = np.isfinite(d0) & np.isfinite(d1)
    err = np.where(fin, np.abs(d1 - np.where(fin, d0, 0.0)), 0.0)
    width = 2.0 * err.max(axis=1, keepdims=True)
    with np.errstate(invalid="ignore"):
        gap = np.abs(np.diff(d0, axis=1))       # nan between two +inf
        return (gap <= width) & (width > 0)


def assert_same_ranking(d_out, i_out, d_exp, i_exp, tol=TOL,
                        max_tied=MAX_TIED) -> float:
    """The port's sorted (dists, ids) against the reference's, with the
    module's rule; returns the share of finite positions inside tied
    runs."""
    d_out, i_out = np.asarray(d_out), np.asarray(i_out)
    d_exp, i_exp = np.asarray(d_exp), np.asarray(i_exp)
    assert d_out.shape == d_exp.shape and i_out.shape == i_exp.shape
    np.testing.assert_allclose(d_out, d_exp, **tol)
    d_exp, d_out = d_exp.reshape(-1, d_exp.shape[-1]), \
        d_out.reshape(-1, d_out.shape[-1])
    i_exp, i_out = i_exp.reshape(d_exp.shape), i_out.reshape(d_exp.shape)
    tied = tied_pairs(d_exp, d_out)
    runs = np.concatenate([np.zeros((len(tied), 1), np.int64),
                           np.cumsum(~tied, axis=1)], axis=1)
    # ids ordered by (run, id): equal rows <=> equal id multisets per run,
    # and equal ids at every position alone in its run
    a = np.take_along_axis(i_exp, np.lexsort((i_exp, runs), axis=-1), 1)
    b = np.take_along_axis(i_out, np.lexsort((i_out, runs), axis=-1), 1)
    bad = np.nonzero((a != b).any(axis=1))[0]
    assert len(bad) == 0, (
        f"ids differ beyond ties in rows {bad[:8].tolist()}: reference "
        f"{i_exp[bad[0]].tolist()}, port {i_out[bad[0]].tolist()}")
    in_run = np.zeros_like(i_exp, dtype=bool)
    in_run[:, 1:] |= tied
    in_run[:, :-1] |= tied
    fin = np.isfinite(d_exp)
    share = float(in_run[fin].mean()) if fin.any() else 0.0
    assert share <= max_tied, f"{share:.2%} of positions lie in ties"
    return share


# --------------------------------------------------------------------------
# the rule itself
# --------------------------------------------------------------------------
def _row(k=40, seed=0):
    """One sorted row of k well separated distances and distinct ids."""
    r = np.random.default_rng(seed)
    d = np.sort(r.uniform(-0.6, -0.2, size=(1, k))).astype(np.float32)
    return d, r.permutation(1000)[:k][None].astype(np.int32)


def _ulp_tie(d, j):
    """Make positions j, j+1 one ulp apart in the reference and equal in
    the port (the deep_like row 5 case); returns (reference, port)."""
    d0 = d.copy()
    d0[0, j + 1] = np.nextafter(d0[0, j], np.float32(1))
    d1 = d0.copy()
    d1[0, j + 1] = d0[0, j]
    return d0, d1


def test_accepts_a_swap_inside_an_ulp_tie():
    d, i = _row(400)
    d0, d1 = _ulp_tie(d, 17)
    i1 = i.copy()
    i1[0, [17, 18]] = i[0, [18, 17]]
    assert assert_same_ranking(d1, i1, d0, i) == 2 / 400


def test_accepts_equal_rows_and_infinite_tails():
    d, i = _row()
    d[0, -5:], i[0, -5:] = np.inf, -1
    assert assert_same_ranking(d, i, d, i) == 0.0


@pytest.mark.parametrize("fault", ["separated_swap", "swap_in_bit_equal_tie",
                                   "foreign_id_in_tie", "distance",
                                   "too_many_ties", "inf_moved"])
def test_catches(fault):
    d, i = _row(400)
    d0, d1, i1 = d.copy(), d.copy(), i.copy()
    if fault == "separated_swap":
        d0, d1 = _ulp_tie(d, 17)
        i1[0, [30, 31]] = i[0, [31, 30]]
    elif fault == "swap_in_bit_equal_tie":
        d0[0, 18] = d0[0, 17]
        d1 = d0.copy()
        i1[0, [17, 18]] = i[0, [18, 17]]
    elif fault == "foreign_id_in_tie":
        d0, d1 = _ulp_tie(d, 17)
        i1[0, 18] = 5000
    elif fault == "distance":
        d1[0, 3] += 1e-3
    elif fault == "too_many_ties":
        d0, d1 = _ulp_tie(d, 17)
        for j in range(40, 60, 2):
            d0[0, j + 1] = np.nextafter(d0[0, j], np.float32(1))
            d1[0, j + 1] = d0[0, j + 1]
    elif fault == "inf_moved":
        d0[0, -1], i[0, -1] = np.inf, -1
        d1 = d0.copy()
        d1[0, -2:] = d0[0, [-1, -2]]
        i1 = i.copy()
        i1[0, -2:] = i[0, [-1, -2]]
    with pytest.raises(AssertionError):
        assert_same_ranking(d1, i1, d0, i)
