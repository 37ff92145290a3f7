"""How `correct` is decided: every answer served in the window against
the plain reference (pb.reference).

Each request's answers are (B, k) ids in the caller's id space and
their distances. Three numbers are compared, each with its limit from the
cell's limits file:

* `invalid_answers`: answers (query rows) with an id outside the corpus,
  an id twice, a distance that is not finite, or distances out of
  ascending order. An exact comparison: limit 0.
* `dist_gap`: the widest gap between a returned distance and the
  reference's float64 distance of the same (query, id), over
  max(1, |reference|). It catches an id that does not belong to its
  distance (a wrong id translation, an altered answer, a query answered
  with another's neighbours) and arithmetic below float32.
* `recall_deficit`: 1 - recall@10 against the reference's exact top-k,
  over every answer served. It catches a search that stops short.

Requests that bring the same answers to the same queries are judged
once and counted as often as they were served.
"""
from __future__ import annotations

from typing import Dict, List, Tuple

import numpy as np

from pb.reference import exact_dists

NUMBERS = ("invalid_answers", "dist_gap", "recall_deficit")


def row_invalid(ids: np.ndarray, dists: np.ndarray, n: int) -> np.ndarray:
    """(B,) bool: the rows that break the answer's form."""
    bad = ((ids < 0) | (ids >= n)).any(1) | ~np.isfinite(dists).all(1)
    s = np.sort(ids, axis=1)
    bad |= (s[:, 1:] == s[:, :-1]).any(1)
    with np.errstate(invalid="ignore"):
        bad |= (np.diff(dists, axis=1) < 0).any(1)
    return bad


def distinct_answers(calls: List[Tuple[int, np.ndarray, np.ndarray]]
                     ) -> List[Tuple[int, np.ndarray, np.ndarray, int]]:
    """(batch, dists, ids, times served) for each distinct answer set."""
    seen: Dict[int, list] = {}
    for b, d, i in calls:
        for entry in seen.setdefault(b, []):
            if np.array_equal(entry[1], d) and np.array_equal(entry[2], i):
                entry[3] += 1
                break
        else:
            seen[b].append([b, d, i, 1])
    return [tuple(e) for lst in seen.values() for e in lst]


def judge(calls, traffic, base: np.ndarray, gt_ids: np.ndarray,
          metric: str, limits: dict) -> dict:
    """The compared numbers, the count of failed answers and `correct`.

    calls: [(request, dists (B, k), ids (B, k))] as served; the traffic
    (pb.traffic.Traffic) gives request b's queries and their rows of the
    pool, and gt_ids is the reference's exact top-k of the whole pool, in
    the order it is sent."""
    n, k = len(base), traffic.k
    answers = failed = hits = 0
    gap = 0.0
    invalid = 0
    for b, d, i, times in distinct_answers(calls):
        q = traffic.batch(b)
        B = len(q)
        if i.shape != (B, k) or d.shape != (B, k):
            answers += B * times            # the wrong shape: all invalid
            invalid += B * times
            failed += B * times
            continue
        bad = row_invalid(i, d, n)
        ref = exact_dists(base, q, i, metric)
        with np.errstate(invalid="ignore"):
            g = np.abs(d.astype(np.float64) - ref) / np.maximum(1.0,
                                                                np.abs(ref))
        g = np.where(np.isfinite(g), g, 0.0)
        row_gap = g.max(1)
        gt = gt_ids[traffic.rows(b), :k]
        h = (i[:, :, None] == gt[:, None, :]).any(-1).sum()
        answers += B * times
        invalid += int(bad.sum()) * times
        failed += int((bad | (row_gap > limits["dist_gap"])).sum()) * times
        hits += int(h) * times
        gap = max(gap, float(row_gap.max()))
    recall = hits / (answers * k) if answers else 0.0
    numbers = {"invalid_answers": float(invalid), "dist_gap": gap,
               "recall_deficit": 1.0 - recall}
    correct = answers > 0 and all(numbers[name] <= limits[name]
                                  for name in NUMBERS)
    return dict(numbers=numbers, correct=correct, attempted=answers,
                failed=failed, recall=recall)
