"""Index parameter tuning against held-out queries with exact ground truth.

The counterpart of the JAX package's `repro/core/tune.py`, with its
procedures, grids, floors and tie rules; every `KBest` it builds lives on
`device` (None means the card, as for `KBest`) and its searches run
whatever `dist_impl` the configs name ("kernel": the CUDA kernels on the
card, their plain versions on the CPU).

Early termination (paper §3.2, A3): the paper determines (t, tau_max) with
a two-stage dry-run — initialize t at ~60% of L, binary-search tau_max
under the recall constraint, then sweep t down from 60% toward 30% of L
keeping the fastest setting that still meets the recall target.
`tune_early_term` reproduces that procedure.

Quantization (A4, DESIGN.md §13/§14): `tune_quant_kind` sweeps every
registered quantization family (quantize.quant_variants, asserted in
tests to cover types.QUANT_KINDS) over one shared graph build and picks
the smallest-code-bytes family that still meets the recall target.

Full-knob tuning (DESIGN.md §16): `tune_config` generalizes both to the
whole search-knob grid (quant kind x L x nprobe/beam x rescore_factor),
using the static cost model (repro_torch.analysis.cost, the reference's
numbers) to order candidates by predicted cost and measuring
cheapest-first until the recall SLO is met — everything costlier is
pruned without ever being measured.

All measurement goes through `_eval`, memoized per index on the frozen
SearchConfig key (`_memo_eval`): the ET binary search, the grid stage
and the ET stage share one cache, so no config is ever measured twice.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np

from repro_torch.core.types import SearchConfig
from repro_torch.data.vectors import recall_at_k


def _eval(index, queries, gt_ids, scfg: SearchConfig) -> Tuple[float, float]:
    _, ids, stats = index.search(queries, search_cfg=scfg, with_stats=True)
    rec = recall_at_k(ids.cpu().numpy(), gt_ids, scfg.k)
    # numpy's mean, as the reference takes it, so equal hops give equal
    # floats
    hops = float(stats.n_hops.cpu().numpy().mean())
    return rec, hops


def _memo_eval(index, queries, gt_ids
               ) -> Callable[[SearchConfig], Tuple[float, float]]:
    """Memoize `_eval` on the (hashable, frozen) SearchConfig: duplicate
    configs across binary-search probes / grid stages hit the cache
    instead of re-searching. The cache dict is exposed as `.cache` so
    tests can pin the call-count reduction."""
    cache: Dict[SearchConfig, Tuple[float, float]] = {}

    def ev(scfg: SearchConfig) -> Tuple[float, float]:
        if scfg not in cache:
            cache[scfg] = _eval(index, queries, gt_ids, scfg)
        return cache[scfg]

    ev.cache = cache
    return ev


def tune_early_term(index, queries: np.ndarray, gt_ids: np.ndarray,
                    base_cfg: SearchConfig, recall_target: float = 0.95,
                    patience_hi: int = 64, _ev=None) -> SearchConfig:
    """Two-stage (t, tau_max) search as in the paper. Returns a tuned cfg.

    `_ev` lets tune_config share its memoized evaluator so the ET stage
    never re-measures a config the grid stage already priced."""
    ev = _ev if _ev is not None else _memo_eval(index, queries, gt_ids)
    best = dataclasses.replace(base_cfg, early_term=False)
    rec0, hops0 = ev(best)
    # An ET config is admissible if recall does not drop below
    # min(recall_target, no-ET recall) - small slack.
    floor = min(recall_target, rec0) - 0.005
    best_hops = hops0

    for t_frac in (0.6, 0.5, 0.4, 0.3):
        # binary search the smallest admissible patience for this t
        lo, hi = 1, patience_hi
        admissible = None
        while lo <= hi:
            mid = (lo + hi) // 2
            cand = dataclasses.replace(base_cfg, early_term=True,
                                       et_t_frac=t_frac, et_patience=mid)
            rec, hops = ev(cand)
            if rec >= floor:
                admissible = (cand, hops)
                hi = mid - 1      # try more aggressive (smaller patience)
            else:
                lo = mid + 1
        if admissible and admissible[1] < best_hops:
            best, best_hops = admissible
    return best


def _clone(index, cfg):
    """A KBest of `cfg` on `index`'s device that shares its built graph:
    db, graph, entry and order are the same tensors, not copies (the
    reference's quant_ablation clone); the caller trains a quantizer."""
    from repro_torch.core.index import KBest
    idx = KBest(cfg, device=index.device)
    idx._set_state(index.db, index.graph, index.entry, index.order)
    return idx


def tune_quant_kind(index, queries: np.ndarray, gt_ids: np.ndarray,
                    recall_target: float = 0.90, pq_m: int = 16):
    """Sweep every registered quantization family over `index`'s existing
    graph (one build, quantizer retrained per variant — the quant_ablation
    clone trick) and return (best_name, rows).

    rows: [{"quant", "recall", "code_bytes"}] for every variant in
    quantize.quant_variants(pq_m). best_name is the variant with the
    SMALLEST code bytes/vector whose recall meets recall_target (ties keep
    the higher recall); falls back to the highest-recall variant when none
    meets the target."""
    from repro_torch.core import quantize as qz
    from repro_torch.core.types import QuantConfig

    assert index.graph is not None, "tune_quant_kind needs a graph index"
    rows = []
    for name, qkw in qz.quant_variants(pq_m=pq_m).items():
        cfg = dataclasses.replace(index.config,
                                  quant=QuantConfig(kmeans_iters=6, **qkw))
        idx = _clone(index, cfg)
        idx._train_quant(idx.db)
        _, ids = idx.search(queries)
        rows.append({"quant": name,
                     "recall": recall_at_k(ids.cpu().numpy(), gt_ids,
                                           cfg.search.k),
                     "code_bytes": qz.code_bytes_per_vector(idx)})
    ok = [r for r in rows if r["recall"] >= recall_target]
    if ok:
        best = min(ok, key=lambda r: (r["code_bytes"], -r["recall"]))
    else:
        best = max(rows, key=lambda r: r["recall"])
    return best["quant"], rows


# ------------------------------------------------- full-knob model-guided tuner

@dataclasses.dataclass
class TuneResult:
    """tune_config's emitted preset + the pruning/measurement audit trail
    (DESIGN.md §16)."""

    config: object                # IndexConfig with the tuned SearchConfig
    rows: List[dict]              # measured candidates, cheapest-first
    grid_size: int                # enumerated (kind x knob) combinations
    n_deduped: int                # collapsed as analytically equivalent
    n_measured: int
    n_pruned: int                 # grid_size - n_measured (never searched)
    recall_tune: float            # winner recall on the tuning split
    recall_holdout: float         # winner recall on the held-out split
    recall_slo: float
    notes: List[str]


def _default_pq_m(d: int) -> int:
    for m in (32, 16, 8, 4, 2):
        if d % m == 0:
            return m
    return 1


def tune_config(x: np.ndarray, queries: np.ndarray, gt_ids: np.ndarray, *,
                metric: str = "l2", index_type: str = "ivf", k: int = 10,
                recall_slo: float = 0.90, slo_margin: float = 0.02,
                pq_m: int = 0, grid: Optional[dict] = None, build=None,
                et_stage: bool = True, max_measure: int = 0,
                dist_impl: str = "ref", kmeans_iters: int = 6,
                device=None) -> TuneResult:
    """Offline full-knob tuner (DESIGN.md §16): recall SLO + sample
    workload in, ready IndexConfig out.

    Pipeline: enumerate quant-kind registry x configs/kbest.tune_grid
    knobs, collapse analytically-equivalent candidates (identical
    widened queue + rescore depth => identical search), price the rest
    with the static cost model (repro_torch.analysis.cost), then measure
    cheapest-first until a config clears recall_slo + slo_margin on the
    tuning split (the margin buys headroom for the tune->holdout
    generalization gap) — every costlier candidate is pruned WITHOUT
    being measured, and the max_measure budget (default grid/8, always
    <= grid/2) bounds the frontier, so at least half the grid is pruned
    analytically. Builds are shared per quant kind (one IVF build per
    kind; one graph build total, quantizers retrained per kind). Graph
    winners then run the paper's §3.2 ET stage through the same memoized
    evaluator. Recall is validated on a held-out query split the tuner
    never measured against. Every index is built on `device` (None: the
    card).
    """
    from repro_torch.analysis import cost as cost_mod
    from repro_torch.configs import kbest as kcfg
    from repro_torch.core import quantize as qz
    from repro_torch.core.index import KBest, resolve_device
    from repro_torch.core.types import (QUANT_KINDS, BuildConfig, IVFConfig,
                                        IndexConfig, QuantConfig)

    device = resolve_device(device)
    x = np.asarray(x)
    n, d = x.shape
    notes: List[str] = []
    pq_m = pq_m or _default_pq_m(d)

    # tune/holdout split of the sample workload
    n_tune = max(1, len(queries) // 2)
    tune_q, hold_q = queries[:n_tune], queries[n_tune:]
    tune_gt, hold_gt = gt_ids[:n_tune], gt_ids[n_tune:]
    if len(hold_q) == 0:
        hold_q, hold_gt = tune_q, tune_gt
        notes.append("single-query sample: holdout == tune split")

    kinds = qz.IVF_QUANT_KINDS if index_type == "ivf" else QUANT_KINDS
    knobs = grid if grid is not None else kcfg.tune_grid(index_type)
    build = build or BuildConfig(M=16, knn_k=24, refine_iters=1,
                                 refine_cands=48)

    def quant_for(kind: str) -> QuantConfig:
        if kind in ("pq", "pq4"):
            return QuantConfig(kind=kind, pq_m=pq_m,
                               kmeans_iters=kmeans_iters)
        return QuantConfig(kind=kind)

    # ---- enumerate the full grid ------------------------------------
    cands: List[dict] = []
    grid_size = 0
    second = knobs.get("nprobe" if index_type == "ivf" else "beam_width",
                       (1,))
    for kind in kinds:
        if kind == "pq4" and pq_m % 2:
            notes.append(f"pq4 skipped: pq_m={pq_m} is odd for d={d}")
            continue
        rfs = knobs.get("rescore_factor", (8,)) if kind == "bin" else (8,)
        for L in knobs.get("L", (64,)):
            if L < k:
                continue
            for snd in second:
                for rf in rfs:
                    grid_size += 1
                    skw = dict(L=L, k=k, dist_impl=dist_impl,
                               rescore_factor=rf)
                    if index_type == "ivf":
                        skw["nprobe"] = snd
                    else:
                        skw["beam_width"] = min(snd, L)
                    scfg = SearchConfig(**skw)
                    cfg = IndexConfig(
                        dim=d, metric=metric, index_type=index_type,
                        build=build, quant=quant_for(kind), search=scfg,
                        ivf=IVFConfig(nlist=0, kmeans_iters=kmeans_iters))
                    cands.append({"kind": kind, "cfg": cfg, "scfg": scfg})

    # ---- analytic stage: dedupe equivalents, price the rest ---------
    seen = set()
    priced: List[dict] = []
    for c in cands:
        w = cost_mod.workload_from(c["cfg"], n=n, Q=len(tune_q))
        if index_type == "ivf":
            key = (c["kind"], w.nprobe, cost_mod.wide_L(w),
                   cost_mod.ivf_rerank_depth(w))
        else:
            key = (c["kind"], w.W, cost_mod.wide_L(w),
                   cost_mod.graph_rerank_depth(w))
        if key in seen:
            continue
        seen.add(key)
        c["pred_s"] = cost_mod.search_cost(w).seconds
        priced.append(c)
    n_deduped = grid_size - len(priced)
    priced.sort(key=lambda c: c["pred_s"])

    if max_measure <= 0:
        max_measure = max(4, grid_size // 8)
    max_measure = min(max_measure, max(1, grid_size // 2))

    # ---- measurement stage: cheapest-first until the SLO is met -----
    builds: Dict[str, object] = {}
    evs: Dict[str, object] = {}
    base_graph = None

    def index_for(c) -> object:
        nonlocal base_graph
        kind = c["kind"]
        if kind not in builds:
            if index_type == "ivf":
                builds[kind] = KBest(c["cfg"], device=device).add(x)
            else:
                if base_graph is None:
                    base_cfg = dataclasses.replace(c["cfg"],
                                                   quant=QuantConfig())
                    base_graph = KBest(base_cfg, device=device).add(x)
                if kind == "none":
                    builds[kind] = base_graph
                else:
                    idx = _clone(base_graph, c["cfg"])
                    idx._train_quant(idx.db)
                    builds[kind] = idx
            evs[kind] = _memo_eval(builds[kind], tune_q, tune_gt)
        return builds[kind]

    rows: List[dict] = []
    winner = None
    for c in priced[:max_measure]:
        index_for(c)
        rec, hops = evs[c["kind"]](c["scfg"])
        rows.append({"kind": c["kind"], "L": c["scfg"].L,
                     "nprobe": c["scfg"].nprobe,
                     "beam_width": c["scfg"].beam_width,
                     "rescore_factor": c["scfg"].rescore_factor,
                     "pred_us": c["pred_s"] * 1e6 / max(len(tune_q), 1),
                     "recall": rec, "hops": hops})
        if rec >= recall_slo + slo_margin:
            winner = c
            break
    if winner is None:
        if not rows:
            raise ValueError("empty candidate grid")
        best_i = max(range(len(rows)), key=lambda i: rows[i]["recall"])
        winner = priced[best_i]
        if rows[best_i]["recall"] >= recall_slo:
            notes.append(f"no measured candidate cleared the SLO with "
                         f"slo_margin={slo_margin}; emitting the best "
                         f"measured (recall={rows[best_i]['recall']:.3f} "
                         f">= {recall_slo} without margin)")
        else:
            notes.append(f"no measured candidate met the {recall_slo} SLO "
                         f"within the max_measure={max_measure} budget; "
                         f"emitting the best measured (recall="
                         f"{rows[best_i]['recall']:.3f})")

    # ---- ET stage (graph only) + holdout validation -----------------
    idx = index_for(winner)
    tuned_scfg = winner["scfg"]
    if et_stage and index_type == "graph":
        tuned_scfg = tune_early_term(idx, tune_q, tune_gt, tuned_scfg,
                                     recall_target=recall_slo,
                                     _ev=evs[winner["kind"]])
    recall_tune = evs[winner["kind"]](tuned_scfg)[0]
    recall_holdout = _eval(idx, hold_q, hold_gt, tuned_scfg)[0]

    return TuneResult(
        config=dataclasses.replace(winner["cfg"], search=tuned_scfg),
        rows=rows, grid_size=grid_size, n_deduped=n_deduped,
        n_measured=len(rows), n_pruned=grid_size - len(rows),
        recall_tune=recall_tune, recall_holdout=recall_holdout,
        recall_slo=recall_slo, notes=notes)
