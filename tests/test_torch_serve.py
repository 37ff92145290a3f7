"""The port's serving tier (repro_torch.serve) against the JAX package's,
on the CPU.

Both packages serve the same index: the reference builds the smoke graph
(240 random rows, d=32, l2) and the smoke IVF index, saves them, and the
port loads the saves (device="cpu"). What must hold:
- `bucket_for`, `bucket_ladder` and `percentiles` equal the reference's;
- the engine's cache counts the same traces, hits and misses as the
  reference's on the same call sequence (one trace per bucket and
  SearchConfig), and `warmup` returns the same count;
- an engine's padded lanes are free: its results equal an unpadded
  `index.search` bit for bit, oversized batches split;
- `serve_loop` on the reference's overload scenarios (tests/
  test_overload.py: admission, `admission=False`, clock skew, a bounded
  queue, a poisoned request) and on a degrade ramp gives the reference's
  status partition, degrade level, queue delay and sojourn per request
  and the same report counts. Both packages' `scheduler.time` is replaced
  by the same fake clock, so every service time and so every decision is
  deterministic;
- `predict_service_s` (to 1e-12 relative) and `degrade_ladder` equal the
  reference's for every preset, bucket and n tested, and `DegradePolicy`
  and `LatencyModel` move as the reference's on the same observations.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

from repro.analysis import cost as jcost
from repro.configs import kbest as jpresets
from repro.core.index import KBest as RefKBest
from repro.core.types import SearchConfig as RefSearchConfig
from repro.serve import degrade as jdegrade
from repro.serve import engine as jengine
from repro.serve import scheduler as jsched
from repro.serve.faults import FaultInjector as RefFaultInjector
from repro_torch.analysis import cost as tcost
from repro_torch.configs import kbest as tpresets
from repro_torch.core.index import KBest, _config_from_dict
from repro_torch.core.sharded import ShardedKBest
from repro_torch.core.types import SearchConfig
from repro_torch.serve import (DegradePolicy, FaultInjector, LatencyModel,
                               Request, SearchEngine, bucket_for,
                               bucket_ladder, percentiles, serve_loop)
from repro_torch.serve import scheduler as tsched
from test_torch_parity import assert_same_ranking
from torch_reference_cache import jax_maps_below_limit  # noqa: F401

torch.set_num_threads(1)

D = 32


@pytest.fixture(scope="module")
def indexes(tmp_path_factory):
    """name -> (reference index, the port's load of its save)."""
    root = tmp_path_factory.mktemp("serve")
    rng = np.random.default_rng(5)
    x = rng.standard_normal((240, D)).astype(np.float32)
    out = {}
    for name, cfg in (("graph", jpresets.smoke_config()),
                      ("ivf", jpresets.ivf_smoke_config())):
        ref = RefKBest(cfg).add(x)
        ref.save(str(root / name))
        out[name] = (ref, KBest.load(str(root / name), device="cpu"))
    return out


@pytest.fixture(scope="module")
def engines(indexes):
    """name -> (reference engine, port engine), buckets 8..32, shared by
    the scenarios (each resets the telemetry; the caches stay warm)."""
    return {name: (jengine.SearchEngine(ref, min_bucket=8, max_bucket=32,
                                        name=name),
                   SearchEngine(port, min_bucket=8, max_bucket=32,
                                name=name))
            for name, (ref, port) in indexes.items()}


def _queries(n, seed=11):
    return np.random.default_rng(seed).standard_normal((n, D)).astype(
        np.float32)


# ------------------------------------------------------------- helpers
@pytest.mark.parametrize("q", [1, 2, 7, 8, 9, 16, 17, 100, 256, 257, 4000])
@pytest.mark.parametrize("bounds", [(8, 256), (1, 32), (16, 16)])
def test_bucket_for_matches_reference(q, bounds):
    assert bucket_for(q, *bounds) == jengine.bucket_for(q, *bounds)


@pytest.mark.parametrize("bounds", [(8, 256), (1, 1), (1, 32), (16, 64)])
def test_bucket_ladder_matches_reference(bounds):
    assert bucket_ladder(*bounds) == jengine.bucket_ladder(*bounds)
    assert bucket_ladder() == (8, 16, 32, 64, 128, 256)


@pytest.mark.parametrize("n", [0, 1, 5, 101])
def test_percentiles_match_reference(n):
    vals = np.random.default_rng(n).exponential(3.0, size=n).tolist()
    assert percentiles(vals) == jengine.percentiles(vals)


# ------------------------------------------------------------- engine
def test_trace_counts_match_reference(indexes):
    """The same call sequence counts the same traces, hits and misses as
    the reference's jit cache: one trace per (bucket, SearchConfig)."""
    ref, port = indexes["graph"]
    r_eng = jengine.SearchEngine(ref, min_bucket=8, max_bucket=32)
    t_eng = SearchEngine(port, min_bucket=8, max_bucket=32)
    q = _queries(40)
    calls = [dict(n=5), dict(n=6), dict(n=7), dict(n=12), dict(n=13),
             dict(n=5, k=3), dict(n=40), dict(n=30, k=3),
             dict(n=9, search_cfg=dataclasses.replace(
                 port.config.search, L=24))]
    for c in calls:
        kw = {k: v for k, v in c.items() if k != "n"}
        r_kw = dict(kw)
        if "search_cfg" in kw:
            r_kw["search_cfg"] = dataclasses.replace(ref.config.search, L=24)
        r_eng.search(q[:c["n"]], **r_kw)
        t_eng.search(q[:c["n"]], **kw)
        assert (t_eng.n_traces, t_eng.cache_hits, t_eng.cache_misses) == \
            (r_eng.n_traces, r_eng.cache_hits, r_eng.cache_misses), c
    assert t_eng.n_traces == 6       # (bucket, k, L): 8, 16, 8 k=3, 32,
    assert t_eng.stats().n_traces == 6   # 32 k=3, 16 L=24


def test_warmup_counts_match_reference(indexes):
    ref, port = indexes["graph"]
    r_eng = jengine.SearchEngine(ref, min_bucket=8, max_bucket=32)
    t_eng = SearchEngine(port, min_bucket=8, max_bucket=32)
    assert t_eng.warmup() == r_eng.warmup() == 3
    assert t_eng.warmup([3, 20], k=3) == r_eng.warmup([3, 20], k=3) == 2
    assert t_eng.warmup() == r_eng.warmup() == 0
    before = t_eng.n_traces
    for n in (2, 9, 17, 30):
        t_eng.search(_queries(30)[:n])
    assert t_eng.n_traces == before, "warmed buckets must not re-trace"


@pytest.mark.parametrize("name", ["graph", "ivf"])
def test_padded_lanes_bit_identical(indexes, name):
    _, port = indexes[name]
    eng = SearchEngine(port, min_bucket=16, max_bucket=32)
    q = _queries(32)
    for n in (3, 11, 16, 29):
        d_pad, i_pad = eng.search(q[:n])
        d0, i0 = port.search(q[:n])
        assert isinstance(i_pad, np.ndarray) and i_pad.shape == (n, 5)
        np.testing.assert_array_equal(i_pad, i0.numpy())
        np.testing.assert_array_equal(d_pad, d0.numpy())


def test_oversized_batch_splits(indexes):
    _, port = indexes["graph"]
    eng = SearchEngine(port, min_bucket=8, max_bucket=16)
    q = _queries(40)
    d, i = eng.search(q)                       # 16 + 16 + 8
    assert d.shape == (40, 5) and eng.stats().n_requests == 3
    _, i0 = port.search(q)
    np.testing.assert_array_equal(i, i0.numpy())


def test_engine_reports_the_served_count_and_recall(indexes):
    ref, port = indexes["graph"]
    r_eng = jengine.SearchEngine(ref, min_bucket=8, max_bucket=32)
    t_eng = SearchEngine(port, min_bucket=8, max_bucket=32)
    q = _queries(22)
    gt = np.asarray(ref.search(q)[1])
    for eng in (r_eng, t_eng):
        eng.search(q[:13], gt_ids=gt[:13])
        eng.search(q[13:], gt_ids=gt[13:])
    rs, ts = r_eng.stats(), t_eng.stats()
    assert (ts.n_requests, ts.n_queries) == (rs.n_requests, rs.n_queries)
    assert (ts.n_queries, ts.recall_at_k) == (22, 1.0)
    assert ts.dists_per_query == rs.dists_per_query
    assert ts.et_fire_rate == rs.et_fire_rate


def test_engine_serves_sharded():
    """A SearchEngine over a 2-shard ShardedKBest: the cache key carries
    n_shards, one bucket serves many batch sizes on one trace, results
    equal the direct sharded search."""
    x = np.random.default_rng(3).standard_normal((240, D)).astype(np.float32)
    sharded = ShardedKBest(tpresets.sharded_smoke_config(2),
                           device="cpu").add(x)
    eng = SearchEngine(sharded, min_bucket=8, max_bucket=16, name="mesh")
    scfg = sharded._resolve_cfg(None, None)
    assert eng._cache_key(8, scfg)[-1] == 2
    assert eng.warmup([8]) == 1
    q = _queries(12)
    d, i = eng.search(q[:5])
    eng.search(q[5:12])                        # another size, same bucket
    assert eng.n_traces == 1
    d0, i0 = sharded.search(q[:5])
    np.testing.assert_array_equal(i, i0.numpy())
    np.testing.assert_array_equal(d, d0.numpy())


# ------------------------------------------------- serve_loop parity
class FakeClock:
    """A perf_counter whose calls come in (start, stop) pairs around each
    dispatch; pair j is SERVICE_MS[j % len] apart."""

    SERVICE_MS = (2.0, 3.5, 1.25, 5.0, 0.75, 4.25)

    def __init__(self):
        self.n = 0
        self.t = 100.0

    def __call__(self) -> float:
        if self.n % 2:
            self.t += self.SERVICE_MS[(self.n // 2) % len(self.SERVICE_MS)] \
                / 1e3
        self.n += 1
        return self.t


def _requests(n, *, arrival_ms=None, deadline_ms=0.0, rows=4, engine=None):
    q = _queries(n * rows)
    arrival = arrival_ms if arrival_ms is not None else [0.0] * n
    engine = engine if engine is not None else ["graph"] * n
    return [dict(queries=q[i * rows:(i + 1) * rows], request_id=i,
                 arrival_ms=float(arrival[i]), deadline_ms=deadline_ms,
                 engine=engine[i])
            for i in range(n)]


def _ladders(name, ref_eng, t_eng):
    r = jpresets.degrade_ladder(ref_eng.index.config)
    t = tpresets.degrade_ladder(t_eng.index.config)
    assert [dataclasses.asdict(s) for s in t] == \
        [dataclasses.asdict(s) for s in r]
    return r, t


def _scenario(name):
    """(request dicts, serve_loop keyword arguments, fault plan keyword
    arguments, DegradePolicy keyword arguments or None)."""
    if name == "admission":
        return (_requests(5, deadline_ms=50.0), dict(coalesce=False),
                dict(latency_spikes={0: 1000.0}), None)
    if name == "admission_false":
        return (_requests(4, deadline_ms=50.0),
                dict(coalesce=False, admission=False),
                dict(latency_spikes={0: 1000.0}), None)
    if name.startswith("skew"):
        return (_requests(6, arrival_ms=[5.0 * i for i in range(6)],
                          deadline_ms=40.0),
                dict(coalesce=False, max_queue=2),
                dict(latency_spikes={0: 300.0},
                     skew_ms=1e7 if name == "skew_1e7" else 0.0), None)
    if name == "bounded_queue":
        return (_requests(6), dict(coalesce=False, max_queue=2),
                dict(latency_spikes={0: 1000.0}), None)
    if name == "poisoned":
        return _requests(3), dict(), dict(poisoned={1}), None
    if name == "partition":
        return (_requests(8, deadline_ms=60.0),
                dict(coalesce=False, max_queue=3),
                dict(latency_spikes={0: 500.0}, poisoned={1}), None)
    if name == "degrade_ramp":
        arrival = [0.0] * 6 + [20_000.0 + 10_000.0 * i for i in range(6)]
        return (_requests(12, arrival_ms=arrival), dict(coalesce=False),
                dict(latency_spikes={0: 1000.0}),
                dict(high_ms=100.0, low_ms=10.0, patience=2))
    if name == "mixed_overload":
        # Poisson arrivals at about twice the fake clock's capacity,
        # coalescing, both families, deadlines, a bounded queue and the
        # degrade ladder, a spike and a poisoned request
        rng = np.random.default_rng(0)
        n = 60
        arrival = np.cumsum(rng.exponential(1.4, size=n)).tolist()
        eng = rng.choice(["graph", "ivf"], size=n).tolist()
        reqs = _requests(n, arrival_ms=arrival, deadline_ms=14.0,
                         rows=3, engine=eng)
        return (reqs, dict(max_queue=6), dict(latency_spikes={3: 20.0},
                                              poisoned={17}),
                dict(high_ms=3.0, low_ms=0.5, patience=2))
    raise ValueError(name)


SCENARIOS = ["admission", "admission_false", "skew_0", "skew_1e7",
             "bounded_queue", "poisoned", "partition", "degrade_ramp",
             "mixed_overload"]


def _run(pkg, engines, name, monkeypatch):
    """One drain of scenario `name` through package `pkg` ("ref" or
    "port") on a fresh fake clock."""
    reqs, kw, fault_kw, policy_kw = _scenario(name)
    side = 0 if pkg == "ref" else 1
    sched = jsched if pkg == "ref" else tsched
    monkeypatch.setattr(sched, "time",
                        types.SimpleNamespace(perf_counter=FakeClock()))
    used = {n: e[side] for n, e in engines.items()
            if any(r["engine"] == n for r in reqs)}
    for e in used.values():
        e.reset_stats()
    if pkg == "ref":
        Req, Faults, Policy = jsched.Request, RefFaultInjector, \
            jdegrade.DegradePolicy
    else:
        Req, Faults, Policy = Request, FaultInjector, DegradePolicy
    policy = None
    if policy_kw is not None:
        g = engines["graph"]
        ladder = _ladders("graph", g[0], g[1])[side]
        policy = Policy(ladder=ladder, **policy_kw)
    rep = sched.serve_loop(used, [Req(**r) for r in reqs],
                           faults=Faults(**fault_kw), degrade=policy, **kw)
    return rep, policy, {n: e.stats() for n, e in used.items()}


@pytest.mark.parametrize("name", SCENARIOS)
def test_serve_loop_matches_reference(engines, name, monkeypatch):
    ref, ref_pol, ref_st = _run("ref", engines, name, monkeypatch)
    got, got_pol, got_st = _run("port", engines, name, monkeypatch)
    for field in ("n_requests", "n_served", "n_dispatches", "n_rejected",
                  "n_shed", "n_failed", "n_deadline_missed", "t_end_ms",
                  "lat_p50_ms", "lat_p99_ms", "sojourn_p50_ms",
                  "sojourn_p95_ms", "sojourn_p99_ms", "recall_at_k"):
        assert getattr(got, field) == getattr(ref, field), field
    assert len(got.results) == len(ref.results)
    for a, b in zip(ref.results, got.results):
        assert (b.request_id, b.engine, b.status, b.degrade_level,
                b.n_served, b.deadline_missed) == \
            (a.request_id, a.engine, a.status, a.degrade_level,
             a.n_served, a.deadline_missed), a.request_id
        assert (b.queue_delay_ms, b.sojourn_ms, b.latency_ms) == \
            (a.queue_delay_ms, a.sojourn_ms, a.latency_ms), a.request_id
        assert (b.error is None) == (a.error is None)
        assert_same_ranking(b.dists, b.ids, np.asarray(a.dists),
                            np.asarray(a.ids))
    for eng_name, rs in ref_st.items():
        ts = got_st[eng_name]
        for field in ("n_requests", "n_queries", "n_rejected", "n_shed",
                      "n_failed", "deadline_miss_rate", "degrade_occupancy",
                      "dists_per_query", "et_fire_rate"):
            assert getattr(ts, field) == getattr(rs, field), \
                (eng_name, field)
    if ref_pol is not None:
        assert got_pol.transitions == ref_pol.transitions
        assert got_pol.occupancy == ref_pol.occupancy
    # each scenario exercises what it names
    statuses = {r.status for r in got.results}
    n_ok = sum(r.status == "ok" for r in got.results)
    assert n_ok + got.n_rejected + got.n_shed + got.n_failed == \
        got.n_requests
    want = {"admission": "rejected", "bounded_queue": "shed",
            "poisoned": "failed", "partition": "rejected",
            "skew_0": "rejected", "mixed_overload": "rejected"}
    if name in want:
        assert want[name] in statuses, statuses
    if name in ("degrade_ramp", "mixed_overload"):
        assert max(r.degrade_level for r in got.results) >= 1


def test_clock_skew_does_not_change_the_port(engines, monkeypatch):
    a = _run("port", engines, "skew_0", monkeypatch)[0]
    b = _run("port", engines, "skew_1e7", monkeypatch)[0]
    assert [(r.request_id, r.status) for r in a.results] == \
        [(r.request_id, r.status) for r in b.results]


# ------------------------------------------- the cost prior and ladders
PRESETS = ["index_config", "beam_index_config", "sq_index_config",
           "bin_index_config", "ivf_index_config", "ivf_pq4_index_config",
           "ivf_bin_index_config", "sharded_index_config",
           "sharded_ivf_index_config", "sharded_ivf_pq4_index_config",
           "sharded_bin_index_config", "full_config"]


def _preset_pairs():
    for fn in PRESETS:
        for shape in jpresets.SHAPES:
            yield (f"{fn}:{shape}", getattr(jpresets, fn)(shape),
                   getattr(tpresets, fn)(shape))
    for fn in ("smoke_config", "ivf_smoke_config", "sharded_smoke_config"):
        yield fn, getattr(jpresets, fn)(), getattr(tpresets, fn)()


def test_presets_match_reference():
    for name, r, t in _preset_pairs():
        assert dataclasses.asdict(t) == dataclasses.asdict(r), name


@pytest.mark.parametrize("n", [0, 240, 50_000, 1_000_000])
def test_predict_service_s_matches_reference(n):
    for name, r, t in _preset_pairs():
        for Q in bucket_ladder(1, 256):
            for scfg in jpresets.degrade_ladder(r):
                ts = SearchConfig(**dataclasses.asdict(scfg))
                exp = jcost.predict_service_s(r, scfg, Q=Q, n=n)
                got = tcost.predict_service_s(t, ts, Q=Q, n=n)
                assert got == pytest.approx(exp, rel=1e-12, abs=0), \
                    (name, Q, scfg)


def test_query_costs_match_reference():
    """The per-stage breakdown and the distance counts too, not only the
    seconds."""
    for name, r, t in _preset_pairs():
        wr = jcost.workload_from(r, n=10_000, Q=8)
        wt = tcost.workload_from(t, n=10_000, Q=8)
        assert dataclasses.asdict(wr) == dataclasses.asdict(wt), name
        cr, ct = jcost.search_cost(wr), tcost.search_cost(wt)
        assert (ct.flops, ct.hbm_bytes, ct.n_dist, ct.breakdown) == \
            (cr.flops, cr.hbm_bytes, cr.n_dist, cr.breakdown), name
        assert tcost.est_hops(wt) == jcost.est_hops(wr)
    assert tcost.KERNEL_COSTS == {
        k: tcost.KernelCost(**dataclasses.asdict(v))
        for k, v in jcost.KERNEL_COSTS.items()}


def test_degrade_ladders_match_reference():
    for name, r, t in _preset_pairs():
        got = tpresets.degrade_ladder(t)
        exp = jpresets.degrade_ladder(r)
        assert [dataclasses.asdict(s) for s in got] == \
            [dataclasses.asdict(s) for s in exp], name
        assert got[0] == t.search
        costs = [tcost.predict_service_s(t, s) for s in got]
        assert all(a > b for a, b in zip(costs, costs[1:])), name
    assert len(tpresets.degrade_ladder(
        tpresets.ivf_index_config("deep_like"))) >= 2


# ------------------------------------------------ policy and model
def test_degrade_policy_moves_as_the_reference():
    base = dataclasses.asdict(tpresets.index_config("deep_like").search)
    ladder_t = tuple(tpresets.degrade_ladder(
        tpresets.ivf_index_config("deep_like")))
    ladder_r = tuple(jpresets.degrade_ladder(
        jpresets.ivf_index_config("deep_like")))
    obs = np.random.default_rng(4).choice(
        [1.0, 30.0, 200.0, 500.0], size=400, p=[0.35, 0.2, 0.25, 0.2])
    for patience in (1, 2, 3):
        t = DegradePolicy(ladder=ladder_t, high_ms=100.0, low_ms=10.0,
                          patience=patience)
        r = jdegrade.DegradePolicy(ladder=ladder_r, high_ms=100.0,
                                   low_ms=10.0, patience=patience)
        for i, o in enumerate(obs):
            assert t.observe(float(o)) == r.observe(float(o)), (patience, i)
            ask = dict(base, k=int(5 + i % 20), L=128)
            a = t.apply(SearchConfig(**ask))
            b = r.apply(RefSearchConfig(**ask))
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
        assert t.transitions == r.transitions and t.transitions
        assert t.occupancy == r.occupancy


def test_latency_model_moves_as_the_reference(engines):
    r_eng, t_eng = engines["ivf"]
    rng = np.random.default_rng(9)
    t, r = LatencyModel(alpha=0.3, slack=1.5), \
        jdegrade.LatencyModel(alpha=0.3, slack=1.5)
    ladder_r = jpresets.degrade_ladder(r_eng.index.config)
    ladder_t = tpresets.degrade_ladder(t_eng.index.config)
    for _ in range(50):
        j = int(rng.integers(len(ladder_r)))
        rows = int(rng.integers(1, 40))
        ms = float(rng.exponential(4.0))
        assert t.predict_ms(t_eng, ladder_t[j], rows) == \
            r.predict_ms(r_eng, ladder_r[j], rows)
        t.observe(t_eng, ladder_t[j], rows, ms)
        r.observe(r_eng, ladder_r[j], rows, ms)
    assert t.calibrated and r.calibrated


# ------------------------------------------------------------ launcher
def test_launcher_serves_both_families_on_two_shards(capsys):
    from repro_torch.launch.serve import serve_ann
    rep = serve_ann(600, shards=2, device="cpu")
    assert rep.n_served == 100 and rep.n_failed == 0
    assert set(rep.engine_stats) == {"graph", "ivf"}
    assert rep.recall_at_k > 0.8
    assert "host CPU" in capsys.readouterr().out


def test_launcher_offers_no_lm_mode(monkeypatch, capsys):
    """`--mode lm`, once refused, decodes a smoke LM through its cache."""
    from repro_torch.launch import serve as launcher
    monkeypatch.setattr("sys.argv", ["serve", "--mode", "lm", "--arch",
                                     "chatglm3-6b", "--device", "cpu"])
    launcher.main()
    out = capsys.readouterr().out
    assert "ms/token (smoke config, host CPU)" in out
    assert out.startswith("chatglm3-6b: ") and "cache len=17" in out
