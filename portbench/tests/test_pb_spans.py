"""The readers of the program's spans (pb/program_spans.py and the five
metrics/ readers that use it): the idle time of the device set against
spans by hand, the window's filter, the innermost span, the launches'
check of the shared clock, the readers on a program without a recorder,
and whole host runs, untraced (the recorder stays off) and traced."""
import sys
import time
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]

from pb import harness, program_spans, spec, tracing  # noqa: E402
from repro_torch import spans  # noqa: E402

SEED = 2 ** 31 + 77


class _Event:
    def __init__(self, name, start, dur, device=False):
        self._v = (name, start, dur, device)

    def name(self):
        return self._v[0]

    def activity_type(self):
        return "kernel" if self._v[3] else "cuda_runtime"

    def start_ns(self):
        return self._v[1]

    def duration_ns(self):
        return self._v[2]

    def device_type(self):
        d = torch.autograd.DeviceType
        return d.CUDA if self._v[3] else d.CPU


class _Run:
    """A window of 1,000-11,000 ns on both clocks."""
    marks = {"window": 1e-6}
    window_s = 1e-5

    def __init__(self, events):
        self.summary = tracing.TraceSummary(events)


def _span(name, start, end, id, parent):
    call = id if parent == -1 else 0
    return spans.Span(name, start, end, id, parent, call, None)


RECORDS = [
    # warm-up, before the window: left out
    _span("search", 100, 900, 90, -1),
    spans.Count("sync", 500, 1, 90, 90),
    # call 1: 2,000-6,000, its iteration 2,500-5,000 with a filter
    # 3,000-3,500, its exit check 5,000-5,500
    _span("search.iter.filter", 3000, 3500, 2, 1),
    _span("search.iter", 2500, 5000, 1, 0),
    spans.Count("sync", 5100, 1, 3, 0),
    _span("search.exit_sync", 5000, 5500, 3, 0),
    _span("search", 2000, 6000, 0, -1),
    # call 2: 7,000-9,000, no children
    spans.Count("sync", 8000, 2, 4, 4),
    _span("search", 7000, 9000, 4, -1),
    # after the window (a replay): left out
    _span("search", 12000, 13000, 5, -1),
]
DEVICE = [("k", 1500, 500), ("k", 2800, 100), ("k", 3200, 100),
          ("k", 5200, 1000), ("k", 7500, 200), ("k", 10500, 2000)]
HOST = [("cudaLaunchKernel", 1400, 10), ("cudaLaunchKernel", 2600, 10),
        ("cudaLaunchKernelExC", 7200, 10), ("cudaLaunchKernel", 9500, 10),
        ("cudaLaunchKernel", 11500, 10), ("cudaMemcpyAsync", 3000, 100)]


class _Recorder:
    Span, Count = spans.Span, spans.Count

    def records(self):
        return list(RECORDS)

    def dropped(self):
        return 0


def _window():
    events = [_Event(n, s, d, device=True) for n, s, d in DEVICE] + \
        [_Event(n, s, d) for n, s, d in HOST]
    run = _Run(events)
    return run, program_spans.Window(run, _Recorder(), to_clock=lambda t: t)


def test_the_window_keeps_the_records_that_start_inside_it():
    _, w = _window()
    assert (w.lo, w.hi) == (1000, 11000)
    assert sorted(w.calls) == [(2000, 6000), (7000, 9000)]
    assert w.counts == {"sync": 3}
    assert sorted(w.durations("search")) == [2000, 4000]
    assert w.durations("search.iter") == [2500]


def test_idle_time_by_hand():
    run, w = _window()
    rep = program_spans.idle_report(w, run.summary)
    # busy in the window: 1,500-2,000, 2,800-2,900, 3,200-3,300,
    # 5,200-6,200, 7,500-7,700, 10,500-11,000
    assert program_spans.idle(run.summary.device, 1000, 11000) == [
        (1000, 1500), (2000, 2800), (2900, 3200), (3300, 5200),
        (6200, 7500), (7700, 10500)]
    assert rep["idle"] == 10000 - 2400
    # call 1: 2,000-2,800, 2,900-3,200, 3,300-5,200; call 2: 7,000-7,500,
    # 7,700-9,000
    assert rep["in_calls"] == 800 + 300 + 1900 + 500 + 1300
    assert rep["by_span"] == {
        "search": 500 + 500 + 1300,           # 2,000-2,500 and call 2
        "search.iter": 300 + 100 + 1500,      # 2,500-2,800, 2,900-3,000,
                                              # 3,500-5,000
        "search.iter.filter": 200 + 200,      # 3,000-3,200, 3,300-3,500
        "search.exit_sync": 200,              # 5,000-5,200
        program_spans.OUTSIDE: 500 + 800 + 1500}
    assert sum(rep["by_span"].values()) == rep["idle"]
    # whole gaps by their middle: 1,250 outside; 2,400 in the root's own
    # time; 3,050 in the filter, but the host is in a copy then, so the
    # gap is left out; 4,250 in search.iter; 6,850 and 9,100 outside
    assert rep["no_call"] == {program_spans.OUTSIDE: 500 + 1300 + 2800,
                              "search": 800, "search.iter": 1900}
    assert rep["self"] == {"search": 500 + 500 + 2000,
                           "search.iter": 2000, "search.iter.filter": 500,
                           "search.exit_sync": 500}
    assert rep["under_child"] == pytest.approx(2500 / 4800)
    # launches at 2,600 and 7,200 start inside a call, 1,400 and 9,500
    # between calls; 11,500 lies past the window; a copy is no launch
    assert (rep["launches"], rep["launches_inside"]) == (4, 2)
    line = program_spans.describe(rep, w)
    assert "2 of 4 (50.000%)" in line and "52.08% of it" in line


def test_innermost_pieces_tile_each_span():
    s = [(0, 10, "a"), (1, 3, "b"), (4, 6, "c"), (4, 5, "d"), (12, 13, "e")]
    assert program_spans.innermost(s) == [
        (0, 1, "a"), (1, 3, "b"), (3, 4, "a"), (4, 5, "d"), (5, 6, "c"),
        (6, 10, "a"), (12, 13, "e")]


READERS = ("idle_in_search_ms.graph", "iter_host_us.graph", "syncs_per_call",
           "syncs_per_call.graph")


def test_readers_read_nothing_without_the_programs_recorder(monkeypatch):
    import repro_torch
    monkeypatch.setitem(sys.modules, "repro_torch.spans", None)
    monkeypatch.delattr(repro_torch, "spans")
    assert program_spans.recorder() is None
    run, _ = _window()
    for name in READERS:
        assert spec.reader(name).read(run) is None


def test_readers_read_nothing_from_a_recorder_never_turned_on(monkeypatch):
    monkeypatch.setattr(spans, "enable", lambda: None)
    monkeypatch.setattr(spans, "_first", None)
    spans.disable()
    spans.clear()
    run, _ = _window()
    for name in READERS:
        assert spec.reader(name).read(run) is None


def _small(name):
    """The cell at 1,000 rows and two calls of 100 queries."""
    cell = spec.Cell(spec.load_spec(BENCH.parent), name)
    cell.config["data"]["n"] = 1000
    cell.traffic.update(queries_per_call=100, query_pool=200)
    index = cell.config["index"]
    if index["index_type"] == "ivf":
        index["ivf"]["nlist"] = 200
    else:
        index["build"].update(search_passes=0, refine_iters=0)
    return cell


@pytest.fixture
def host_run(monkeypatch):
    monkeypatch.setattr(harness, "FORBIDDEN", ())
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    spans.disable()
    spans.clear()
    yield lambda name, trace: harness.run(_small(name), SEED, 0.0, trace,
                                          "cpu", time.perf_counter())
    torch.set_num_threads(old)


def test_an_untraced_host_run_leaves_the_recorder_off(host_run):
    result = host_run("ivfpq.batch", False)
    assert result["correct"] is True
    assert not spans.enabled() and spans.records() == []


@pytest.mark.parametrize("name", ["graph.batch", "ivfpq.batch"])
def test_a_traced_host_run_reads_the_spans_and_counts(host_run, name):
    m = {k: v["value"] for k, v in host_run(name, True)["metrics"].items()}
    assert spans.enabled()
    # no device activity on the host: the idle reader reads nothing
    assert not {"idle_in_search_ms", "idle_in_search_ms.graph"} & set(m)
    if name == "graph.batch":
        assert m["syncs_per_call.graph"] == m["lockstep_iters.graph"] + 1
        assert m["iter_host_us.graph"] > 0
    else:
        assert m["syncs_per_call"] == 3
