"""The port's tuner (repro_torch.core.tune, configs.kbest.tune_grid)
against the JAX package's, on the CPU.

- The reference's own tuner tests (tests/test_tune.py), run against the
  port: the memoized evaluator collapses equal configs, the ET search
  keeps its floor and measures no config twice, the quant-kind sweep
  covers the registry, and tune_config at 5k vectors prunes at least half
  its grid and meets a 0.80 SLO on held-out queries.
- Decision parity: `_eval` is replaced in both packages by one
  deterministic function of (quant kind, SearchConfig), so the tuners'
  decisions can be compared exactly even though their builds draw other
  random numbers (jax.random cannot be reproduced in torch). Then
  tune_early_term probes the same configs in the same order and returns
  the same config, and tune_config returns the same grid size, dedupe
  count, rows (pred_us exactly), winner and notes: IVF over real builds of
  1,000 vectors in each package; graph over a stand-in index (the fake
  evaluator reads only its config), which also pins the order and configs
  of the builds the tuner asks for.
- Evaluation parity: a reference-built graph (the conftest's) and IVF
  index, saved and loaded into the port, where the port's `_eval` gives
  the reference's hops exactly and its recall up to the ulp ties of
  tests/test_torch_parity.py.
- The port's counterpart of tests/test_degrade.py::
  test_ladder_rungs_searchable_via_memo_eval.
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

from repro.configs import kbest as jpresets
from repro.core import index as jindex
from repro.core import tune as jtune
from repro.core.types import IndexConfig as RefIndexConfig
from repro.core.types import IVFConfig as RefIVFConfig
from repro.core.types import QuantConfig as RefQuantConfig
from repro.core.types import SearchConfig as RefSearchConfig
from repro_torch.configs import kbest as tpresets
from repro_torch.core import index as tindex
from repro_torch.core import quantize as tqz
from repro_torch.core import tune as ttune
from repro_torch.core.index import KBest
from repro_torch.core.types import QUANT_KINDS, SearchConfig
from repro_torch.data.vectors import exact_topk, make_dataset
from test_torch_parity import assert_same_ranking
from torch_reference_cache import jax_maps_below_limit  # noqa: F401

# parallel test workers share the cores: one torch thread each keeps the
# many small eager ops from oversubscribing them
torch.set_num_threads(1)


# ----------------------------------------------------------- memoization

def test_memo_eval_collapses_duplicate_configs(monkeypatch):
    calls = []

    def fake_eval(index, queries, gt_ids, scfg):
        calls.append(scfg)
        return 0.9, 10.0

    monkeypatch.setattr(ttune, "_eval", fake_eval)
    ev = ttune._memo_eval(None, None, None)
    a = SearchConfig(L=64, k=10)
    b = SearchConfig(L=64, k=10)          # equal frozen config, new object
    c = SearchConfig(L=128, k=10)
    assert ev(a) == ev(b) == (0.9, 10.0)
    ev(c)
    ev(a)
    assert len(calls) == 2                # one per DISTINCT config
    assert set(ev.cache) == {a, c}


# ------------------------------------------------------- early-term stage

def test_tune_early_term_floor_and_no_duplicate_measures(monkeypatch):
    """The tuned config is admissible (recall within slack of the no-ET
    baseline) and cheaper; the memoized evaluator never measures the same
    config twice across the t_frac binary searches."""
    calls = []

    def fake_eval(index, queries, gt_ids, scfg):
        calls.append(scfg)
        if not scfg.early_term:
            return 0.96, 100.0
        # admissible once patience >= 8; cheaper at lower patience
        rec = 0.96 if scfg.et_patience >= 8 else 0.50
        return rec, 40.0 + scfg.et_patience
    monkeypatch.setattr(ttune, "_eval", fake_eval)

    base = SearchConfig(L=64, k=10)
    tuned = ttune.tune_early_term(None, None, None, base,
                                  recall_target=0.95)
    assert tuned.early_term and tuned.et_patience == 8
    rec, hops = fake_eval(None, None, None, tuned)
    assert rec >= min(0.95, 0.96) - 0.005
    assert hops < 100.0
    assert len(calls) == len(set(calls)) + 1   # +1: the re-check above


# ------------------------------------------------------- quant-kind sweep

def test_tune_quant_kind_covers_registry():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((400, 32)).astype(np.float32)
    q = rng.standard_normal((16, 32)).astype(np.float32)
    gt = exact_topk(x, q, k=5, metric="l2")
    idx = KBest(tpresets.smoke_config(), device="cpu").add(x)

    best, rows = ttune.tune_quant_kind(idx, q, gt, recall_target=0.6,
                                       pq_m=16)
    variants = tqz.quant_variants(pq_m=16)
    assert {r["quant"] for r in rows} == set(variants)
    assert best in variants
    assert {v["kind"] for v in variants.values()} == set(QUANT_KINDS)
    # the clones share the built graph's tensors, not copies
    clone = ttune._clone(idx, idx.config)
    assert clone.db.data_ptr() == idx.db.data_ptr()
    assert clone.graph.data_ptr() == idx.graph.data_ptr()


# ------------------------------------------------- model-guided full tuner

@pytest.fixture(scope="module")
def tuned_ivf():
    ds = make_dataset("deep_like", n=5_000, n_queries=200, k=10,
                      device="cpu")
    return ttune.tune_config(ds.base, ds.queries, ds.gt_ids,
                             metric=ds.metric, index_type="ivf", k=10,
                             recall_slo=0.80, device="cpu")


def test_tune_config_prunes_at_least_half_the_grid(tuned_ivf):
    res = tuned_ivf
    assert res.grid_size >= 12, "grid too small to exercise pruning"
    assert res.n_measured <= res.grid_size // 2
    assert res.n_pruned >= res.grid_size - res.grid_size // 2
    assert res.n_measured == len(res.rows) > 0
    preds = [r["pred_us"] for r in res.rows]
    assert preds == sorted(preds)


def test_tune_config_meets_slo_on_holdout(tuned_ivf):
    res = tuned_ivf
    assert res.recall_tune >= res.recall_slo, res.notes
    assert res.recall_holdout >= res.recall_slo, \
        (res.recall_holdout, res.notes)
    cfg = res.config
    assert cfg.index_type == "ivf" and cfg.search.k == 10
    assert cfg.quant.kind in tqz.IVF_QUANT_KINDS


def test_tune_config_defaults_to_the_card():
    """Without device= the tuner builds on the card, as KBest does: with
    no CUDA device it raises before building anything."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    x = np.zeros((8, 4), np.float32)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ttune.tune_config(x, x[:2], np.zeros((2, 1), np.int64), k=1)


@pytest.mark.parametrize("index_type", ["ivf", "graph"])
def test_tune_grid_matches_reference(index_type):
    assert tpresets.tune_grid(index_type) == \
        jpresets.tune_grid(index_type)


# ------------------------------------------------------- decision parity

def _fake_numbers(kind, s):
    """(recall, hops) as a deterministic function of the quant kind and
    the SearchConfig: recall grows with L, nprobe, the beam and the
    rescore depth; early termination saves hops and costs recall at
    small patience and early t."""
    rec = 0.35 + 0.07 * math.log2(s.L / 16) + 0.06 * math.log2(s.nprobe) \
        + 0.02 * (s.beam_width > 1) + 0.004 * math.log2(s.rescore_factor) \
        - 0.013 * QUANT_KINDS.index(kind)
    hops = s.L * (1.75 - 0.1 * (s.beam_width > 1))
    if s.early_term:
        rec -= 0.12 / s.et_patience + 0.05 * (0.6 - s.et_t_frac)
        hops *= 0.45 + s.et_patience / 64 + 0.3 * s.et_t_frac
    return min(rec, 0.999), hops


def _install_fake(monkeypatch, mod):
    """Replace mod._eval by the shared fake; returns the list of (kind,
    SearchConfig fields) it is called with, in order."""
    calls = []

    def fake(index, queries, gt_ids, scfg):
        kind = "none" if index is None else index.config.quant.kind
        calls.append((kind, dataclasses.asdict(scfg)))
        return _fake_numbers(kind, scfg)
    monkeypatch.setattr(mod, "_eval", fake)
    return calls


def _same_result(t, r):
    assert (t.grid_size, t.n_deduped, t.n_measured, t.n_pruned) == \
        (r.grid_size, r.n_deduped, r.n_measured, r.n_pruned)
    assert t.rows == r.rows                       # pred_us exactly
    assert dataclasses.asdict(t.config) == dataclasses.asdict(r.config)
    assert t.notes == r.notes
    assert (t.recall_tune, t.recall_holdout, t.recall_slo) == \
        (r.recall_tune, r.recall_holdout, r.recall_slo)


@pytest.mark.parametrize("target", [0.50, 0.62, 0.99])
@pytest.mark.parametrize("L,W", [(64, 1), (128, 4)])
def test_tune_early_term_decisions_match_reference(monkeypatch, target, L,
                                                   W):
    tcalls = _install_fake(monkeypatch, ttune)
    jcalls = _install_fake(monkeypatch, jtune)
    kw = dict(L=L, k=10, beam_width=W)
    t = ttune.tune_early_term(None, None, None, SearchConfig(**kw),
                              recall_target=target)
    r = jtune.tune_early_term(None, None, None, RefSearchConfig(**kw),
                              recall_target=target)
    assert tcalls == jcalls and len(tcalls) > 10
    assert dataclasses.asdict(t) == dataclasses.asdict(r)


def _sample(n, d, q, seed):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((n, d)).astype(np.float32),
            rng.standard_normal((q, d)).astype(np.float32),
            np.zeros((q, 10), np.int64))


@pytest.mark.parametrize("slo", [0.70, 0.95])
def test_tune_config_ivf_decisions_match_reference(monkeypatch, slo):
    """Real IVF builds of 1,000 vectors in each package, one per kind."""
    x, q, gt = _sample(1000, 32, 20, seed=int(slo * 100))
    tcalls = _install_fake(monkeypatch, ttune)
    jcalls = _install_fake(monkeypatch, jtune)
    kw = dict(index_type="ivf", recall_slo=slo, k=10, kmeans_iters=2)
    t = ttune.tune_config(x, q, gt, device="cpu", **kw)
    r = jtune.tune_config(x, q, gt, **kw)
    assert tcalls == jcalls
    _same_result(t, r)


class _StubIndex:
    """Stands in for KBest in the graph decision-parity test: the fake
    evaluator reads only the config, so no graph is built. Records every
    config the tuner constructs an index of."""

    made = None

    def __init__(self, config, device=None):
        self.config, self.device = config, device
        self.db = self.graph = self.order = None
        self.entry = 0
        type(self).made.append(dataclasses.asdict(config))

    def add(self, x):
        self.db, self.graph = x, "graph"
        return self

    def _set_state(self, db, graph, entry, order):
        self.db, self.graph, self.entry, self.order = db, graph, entry, order

    def _train_quant(self, x):
        pass


@pytest.mark.parametrize("slo", [0.55, 0.70, 0.99])
@pytest.mark.parametrize("et_stage", [True, False])
def test_tune_config_graph_decisions_match_reference(monkeypatch, slo,
                                                     et_stage):
    x, q, gt = _sample(2000, 48, 20, seed=1)
    tcalls = _install_fake(monkeypatch, ttune)
    jcalls = _install_fake(monkeypatch, jtune)
    made = {}
    for name, mod in (("port", tindex), ("ref", jindex)):
        stub = type(f"Stub_{name}", (_StubIndex,), {"made": []})
        made[name] = stub.made
        monkeypatch.setattr(mod, "KBest", stub)
    kw = dict(index_type="graph", recall_slo=slo, k=10, et_stage=et_stage)
    t = ttune.tune_config(x, q, gt, device="cpu", **kw)
    r = jtune.tune_config(x, q, gt, **kw)
    assert tcalls == jcalls
    assert made["port"] == made["ref"] and len(made["port"]) >= 2
    _same_result(t, r)


# ----------------------------------------------------- evaluation parity

EVAL_CASES = {
    "graph-noet": ("graph", dict(L=64, k=10, early_term=False)),
    "graph-et-beam": ("graph", dict(L=48, k=10, early_term=True,
                                    et_patience=6, et_t_frac=0.5,
                                    beam_width=4)),
    "ivf-6": ("ivf", dict(L=64, k=10, nprobe=6)),
    "ivf-2": ("ivf", dict(L=32, k=10, nprobe=2)),
}


@pytest.fixture(scope="module")
def loaded(deep_ds, deep_index, tmp_path_factory):
    """family -> (reference index, the port's KBest.load of its save)."""
    ivf_cfg = RefIndexConfig(
        dim=deep_ds.base.shape[1], metric=deep_ds.metric, index_type="ivf",
        ivf=RefIVFConfig(nlist=16, kmeans_iters=4, list_pad=8),
        quant=RefQuantConfig(kind="pq", pq_m=16, kmeans_iters=4),
        search=RefSearchConfig(L=64, k=10, nprobe=6))
    refs = {"graph": deep_index,
            "ivf": jindex.KBest(ivf_cfg).add(deep_ds.base)}
    tmp = tmp_path_factory.mktemp("tune_eval")
    out = {}
    for family, ref in refs.items():
        ref.save(str(tmp / family))
        out[family] = (ref, KBest.load(str(tmp / family), device="cpu"))
    return out


@pytest.mark.parametrize("case", sorted(EVAL_CASES))
def test_eval_matches_reference_on_reference_built_index(loaded, deep_ds,
                                                         case):
    family, kw = EVAL_CASES[case]
    ref, port = loaded[family]
    q, gt = deep_ds.queries, deep_ds.gt_ids
    rec_r, hops_r = jtune._eval(ref, q, gt, RefSearchConfig(**kw))
    rec_t, hops_t = ttune._eval(port, q, gt, SearchConfig(**kw))
    assert hops_t == hops_r
    d_r, i_r = ref.search(q, search_cfg=RefSearchConfig(**kw))
    d_t, i_t = port.search(q, search_cfg=SearchConfig(**kw))
    share = assert_same_ranking(d_t.numpy(), i_t.numpy(), d_r, i_r)
    # a swap inside a tie run moves recall only where the run crosses k
    assert abs(rec_t - rec_r) <= share, (rec_t, rec_r, share)


# ------------------------------------------------------ degrade ladder

def test_ladder_rungs_searchable_via_memo_eval():
    """Every rung of the IVF deep_like ladder runs on a 5k split through
    the tuner's memoized evaluator; quality must not INCREASE down the
    ladder (cheaper rungs trade recall)."""
    ds = make_dataset("deep_like", n=5000, n_queries=50, k=10, device="cpu")
    cfg = tpresets.ivf_index_config("deep_like")
    index = KBest(dataclasses.replace(cfg, dim=ds.base.shape[1]),
                  device="cpu").add(ds.base)
    ev = ttune._memo_eval(index, ds.queries, ds.gt_ids)
    ladder = tpresets.degrade_ladder(index.config)
    recalls = []
    for rung in ladder:
        rec, _ = ev(rung)
        assert 0.0 <= rec <= 1.0
        recalls.append(rec)
    assert recalls[0] >= recalls[-1], recalls
    assert recalls[0] >= 0.8, f"full-quality rung too weak: {recalls}"
    n_cached = len(ev.cache)
    ev(ladder[0])
    assert len(ev.cache) == n_cached
