"""The comparison that decides `correct`, at a size a test run holds: the
program as served passes, the control (the reference in TF32 in the
program's place) fails, and a whole run of each cell on the host, past
the look for a card, with each planted fault underneath, comes out not
correct."""
import sys
import time
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(BENCH), str(BENCH.parent / "src")]

from pb import faults, harness, spec  # noqa: E402
from pb import system as system_mod  # noqa: E402

CELLS = ("graph.batch", "ivfpq.batch")
SEED = 2 ** 31 + 101


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One host thread, so that parallel test workers do not
    oversubscribe the host."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


@pytest.fixture(autouse=True)
def shared_process(monkeypatch):
    """Whole runs here share a test process with tests of the JAX
    package, so the check that a measured process holds no JAX, which
    the subprocess tests of test_pb_harness.py cover, is off."""
    monkeypatch.setattr(harness, "FORBIDDEN", ())


def small(name):
    """The cell at 1,000 rows and two calls of 100 queries, with its own
    limits; the graph built without its refinement passes, which only
    take time on the host; 200 IVF lists, of which the cell probes 96
    (a state left unchanged then probes lists 0..95 alone)."""
    cell = spec.Cell(spec.load_spec(BENCH.parent), name)
    cell.config["data"]["n"] = 1000
    cell.traffic.update(queries_per_call=100, query_pool=200)
    index = cell.config["index"]
    if index["index_type"] == "ivf":
        index["ivf"]["nlist"] = 200
    else:
        index["build"].update(search_passes=0, refine_iters=0)
    return cell


@pytest.fixture(scope="module", params=CELLS)
def built(request):
    cell = small(request.param)
    base, pool, metric, traffic = harness.prepare(cell, SEED)
    system = system_mod.KBestSystem(cell.config, "cpu")
    system.build(base)
    return cell, system, (base, pool, metric, traffic)


def verdict(cell, call, prepared):
    base, pool, metric, traffic = prepared
    r = harness.Run(cell, False, "cpu", time.perf_counter())
    harness.measure(r, call, traffic, 0.0, min_calls=traffic.n_batches)
    return harness.judge(r, base, pool, metric, traffic)


def test_the_program_as_served_is_correct(built):
    cell, system, prepared = built
    v = verdict(cell, system.search, prepared)
    assert v["correct"], v
    assert v["failed"] == 0 and v["attempted"] == 200


def test_the_control_is_not_correct(built):
    cell, _, prepared = built
    base, _, metric, _ = prepared
    v = verdict(cell, faults.ControlSystem(base, metric, "cpu").search,
                prepared)
    assert not v["correct"], v
    assert v["numbers"]["dist_gap"] > cell.limits["dist_gap"]


@pytest.mark.parametrize("fault", faults.FAULTS)
@pytest.mark.parametrize("name", CELLS)
def test_a_whole_run_with_a_fault_underneath_is_not_correct(name, fault,
                                                            monkeypatch):
    """harness.run as run.py calls it, with the fault planted under the
    system's call."""
    cell = small(name)
    orig = system_mod.KBestSystem.search
    with faults.plant(fault, cell.config["index"]["index_type"]) as wrap:
        def broken(self, q, k):
            return wrap(lambda q_, k_: orig(self, q_, k_))(q, k)
        monkeypatch.setattr(system_mod.KBestSystem, "search", broken)
        result = harness.run(cell, SEED, 0.0, False, "cpu",
                             time.perf_counter())
    assert result["correct"] is False
    assert set(result["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert {"recall_at_10", "setup_s"} < set(result["metrics"])
    assert list(result["checks"]) == ["invalid_answers", "dist_gap",
                                      "recall_deficit"]


@pytest.mark.parametrize("name", CELLS)
def test_a_whole_traced_run_on_the_host(name):
    result = harness.run(small(name), SEED, 0.0, True, "cpu",
                         time.perf_counter())
    assert result["correct"] is True
    want = spec.Cell(spec.load_spec(BENCH.parent), name).metrics(True)
    assert set(result["metrics"]) <= {m["name"] for m in want}
    assert "build_s" in result["metrics"]
    assert result["device"]["window_s"] > 0
    assert list(result)[-1] == "checks"
