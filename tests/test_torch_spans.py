"""The span recorder (`repro_torch/spans.py`) and the search's spans and
sync counts, on the host.

Off, a site records nothing and hands out the shared no-op. On, spans
nest by parent id and one call id covers a `KBest.search` call; the
`sync` counter counts the two syncs the sync lint allows (the traversal's
exit check, one an iteration and one more for the check that ends the
loop; the stable top-k's tie check, once in each of the IVF's probe,
merge and re-rank and in a quantized graph kind's re-rank); and answers
and `SearchStats` are the same with the recorder on and off. Under
`torch.profiler` a span's mapped interval holds the operator it ran.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import spans
from repro_torch.configs.kbest import ivf_smoke_config, smoke_config
from repro_torch.core.index import KBest
from repro_torch.core.types import QuantConfig, SearchConfig

torch.set_num_threads(1)

N, NQ, DIM = 1200, 24, 32


@pytest.fixture(autouse=True)
def recorder_off():
    spans.disable()
    spans.clear()
    yield
    spans.disable()
    spans.clear()


@pytest.fixture(scope="module")
def data():
    rng = np.random.default_rng(5)
    x = rng.normal(size=(N + NQ, DIM)).astype(np.float32)
    return x[:N], x[N:]


@pytest.fixture(scope="module")
def graph(data):
    return KBest(smoke_config(), device="cpu").add(data[0])


@pytest.fixture(scope="module")
def ivf(data):
    return KBest(ivf_smoke_config(), device="cpu").add(data[0])


def _quantized(base: KBest, quant: QuantConfig) -> KBest:
    """`base`'s graph with a quantizer trained over its rows."""
    idx = KBest(dataclasses.replace(base.config, quant=quant), device="cpu")
    idx._set_state(base.db, base.graph, base.entry, base.order)
    idx._train_quant(idx.db)
    return idx


BEAM = SearchConfig(L=16, k=5, beam_width=4, dist_impl="kernel")
# W=1 expands at most one node a lane an iteration, so three iterations
# end the loop by the hops bound before any lane runs out
HOPS = SearchConfig(L=16, k=5, max_hops=3)
CASES = {
    "graph-none-beam": (None, BEAM, 1),
    "graph-none-hops": (None, HOPS, 0),
    "graph-pq": (dict(kind="pq", pq_m=8, kmeans_iters=3), BEAM, 2),
    "graph-bin": (dict(kind="bin"), BEAM, 2),
}


def _index(name, graph):
    quant = CASES[name][0]
    return graph if quant is None else _quantized(graph, QuantConfig(**quant))


def _syncs(recs):
    return sum(r.n for r in recs
               if isinstance(r, spans.Count) and r.name == "sync")


def _named(recs, name):
    return [r for r in recs if isinstance(r, spans.Span) and r.name == name]


def test_off_records_nothing_and_hands_out_the_shared_no_op(graph, data):
    assert not spans.enabled()
    assert spans.span("search", family="graph", Q=1, k=1) is spans.NO_SPAN
    with spans.span("x") as s:
        spans.count("sync")
    assert s is spans.NO_SPAN
    graph.search(data[1], k=5, search_cfg=BEAM)
    assert spans.records() == [] and spans.dropped() == 0


def test_parents_nest_and_a_call_id_covers_a_call():
    spans.enable()
    with spans.span("a", q=3):
        with spans.span("b"):
            spans.count("sync", 2)
        with spans.span("c"):
            pass
    with spans.span("d"):
        pass
    spans.count("sync")
    recs = spans.records()
    by = {r.name: r for r in recs if isinstance(r, spans.Span)}
    a, b, c, d = by["a"], by["b"], by["c"], by["d"]
    assert (a.parent, a.call, a.attrs) == (-1, a.id, {"q": 3})
    assert (b.parent, b.call) == (a.id, a.id) == (c.parent, c.call)
    assert (d.parent, d.call) == (-1, d.id) and d.call != a.call
    assert a.start <= b.start <= b.end <= c.start <= c.end <= a.end
    counts = [r for r in recs if isinstance(r, spans.Count)]
    assert [(x.n, x.parent, x.call) for x in counts] == [
        (2, b.id, a.id), (1, -1, -1)]
    assert b.start <= counts[0].t <= b.end


def test_records_are_capped_and_the_rest_counted(monkeypatch):
    monkeypatch.setattr(spans, "CAP", 3)
    spans.enable()
    for _ in range(5):
        spans.count("sync")
    assert len(spans.records()) == 3 and spans.dropped() == 2
    spans.clear()
    assert spans.records() == [] and spans.dropped() == 0


@pytest.mark.parametrize("name", list(CASES))
def test_graph_syncs_and_iterations_match_search_stats(name, graph, data):
    idx = _index(name, graph)
    _, scfg, extra = CASES[name]
    spans.enable()
    _, _, st = idx.search(data[1], k=5, search_cfg=scfg, with_stats=True)
    recs = spans.records()
    iters = int(st.iters)
    assert 0 < iters
    if scfg is HOPS:
        assert iters == scfg.hops_bound
    assert _syncs(recs) == iters + extra
    assert len(_named(recs, "search.iter")) == iters
    assert len(_named(recs, "search.exit_sync")) == iters + (scfg is not HOPS)
    (root,) = _named(recs, "search")
    assert root.attrs == {"family": "graph", "Q": NQ, "k": 5}
    assert {r.call for r in recs} == {root.id}
    ids = {r.id: r for r in recs if isinstance(r, spans.Span)}
    for r in ids.values():
        if r.name.startswith("search.iter."):
            assert ids[r.parent].name == "search.iter"
        elif r.name != "search" and not r.name.startswith("topk."):
            assert r.parent == root.id, r.name
    names = {r.name for r in ids.values()}
    assert {"search.upload", "search.seed", "search.iter.filter",
            "search.iter.expand", "search.iter.et", "search.topk",
            "search.ids"} <= names
    assert ("search.rerank" in names) == (extra == 2)


def test_ivf_pq_syncs_three_times_a_call(ivf, data):
    spans.enable()
    ivf.search(data[1], k=5)
    ivf.search(data[1][:7], k=5)
    recs = spans.records()
    roots = _named(recs, "search")
    assert [r.attrs["Q"] for r in roots] == [NQ, 7]
    for root in roots:
        mine = [r for r in recs if r.call == root.id]
        assert _syncs(mine) == 3
        ids = {r.id: r.name for r in mine if isinstance(r, spans.Span)}
        ties = [ids[r.parent] for r in mine
                if isinstance(r, spans.Span) and r.name == "topk.tie_sync"]
        assert sorted(ties) == ["ivf.merge", "ivf.probe", "search.rerank"]
        assert {"search.upload", "ivf.luts", "ivf.scan"} <= set(ids.values())


@pytest.mark.parametrize("name", [*CASES, "ivf-pq", "graph-padded"])
def test_answers_and_stats_equal_with_the_recorder_on_and_off(name, graph,
                                                              ivf, data):
    q = data[1]
    if name == "ivf-pq":
        def call():
            return ivf.search(q, k=5, with_stats=True)
    elif name == "graph-padded":
        valid = np.arange(NQ) % 3 != 0

        def call():
            return graph.search_padded(q, valid, k=5, search_cfg=BEAM,
                                       with_stats=True)
    else:
        idx, scfg = _index(name, graph), CASES[name][1]

        def call():
            return idx.search(q, k=5, search_cfg=scfg, with_stats=True)
    off = call()
    spans.enable()
    on = call()
    assert spans.records()
    for a, b in zip(off[:2] + tuple(off[2]), on[:2] + tuple(on[2])):
        assert torch.equal(a, b)


def test_a_span_holds_its_operator_on_the_profilers_clock():
    from torch.profiler import ProfilerActivity, profile
    a = torch.randn(128, 128)
    torch.mm(a, a)
    spans.enable()
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with spans.span("mm"):
            torch.mm(a, a)
    (s,) = _named(spans.records(), "mm")
    (mm,) = [e for e in prof.profiler.kineto_results.events()
             if e.name() == "aten::mm"]
    lo, hi = spans.profiler_ns(s.start), spans.profiler_ns(s.end)
    assert lo <= mm.start_ns() <= mm.start_ns() + mm.duration_ns() <= hi
