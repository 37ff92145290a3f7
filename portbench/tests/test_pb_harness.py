"""The harness: what it loads, how it finds a cell's parts by name, the
contract's shape of BENCHMARK.json, the trace's reduction, and a run
without a card."""
import json
import re
import shutil
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest
import torch

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent
sys.path[:0] = [str(BENCH), str(ROOT / "src")]

from pb import spec, tracing  # noqa: E402

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _top_level_after(code: str) -> set:
    out = subprocess.run(
        [sys.executable, "-c", textwrap.dedent(code)
         + "\nimport sys, json\n"
         "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))"],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_loads_neither_jax_nor_the_jax_package():
    mods = _top_level_after(f"""
        import sys
        sys.path[:0] = [{str(BENCH)!r}, {str(ROOT / 'src')!r}]
        import run, calibrate
        from pb import (bounds, check, data, faults, harness, reference,
                        roofline, spec, system, tracing, traffic)
        import repro_torch.core.index
        import repro_torch.serve.engine
        cells = spec.load_spec(spec.HERE.parent)
        for m in cells["end_to_end"] + cells["per_layer"]:
            spec.reader(m["name"])
        for c in cells["configs"]:
            spec.module("datagen", spec.load_json(
                spec.HERE.parent / c["file"])["data"]["generator"])
    """)
    assert "repro_torch" in mods
    assert not mods & {"jax", "jaxlib", "flax", "repro"}


def test_reference_loads_nothing_of_the_program():
    mods = _top_level_after(f"""
        import sys
        sys.path[:0] = [{str(BENCH)!r}, {str(ROOT / 'src')!r}]
        from pb import bounds, check, data, reference, spec, traffic
        spec.module("datagen", "deep_like")
    """)
    assert not mods & {"repro_torch", "repro", "jax", "jaxlib", "flax"}


def test_forbidden_modules_compare_whole_top_level_names():
    from pb import harness
    assert harness.forbidden_modules(["repro_torch.core", "numpy"]) == []
    assert harness.forbidden_modules(["jax.numpy", "repro_torch"]) == ["jax"]
    assert harness.forbidden_modules(["repro.core.index", "jaxlib"]) == [
        "jaxlib", "repro"]


def test_every_cell_resolves_its_files_by_name():
    s = spec.load_spec(ROOT)
    for w in s["workloads"]:
        cell = spec.Cell(s, w["name"])
        assert cell.config["name"] == w["config"]
        assert set(cell.limits) >= {"invalid_answers", "dist_gap",
                                    "recall_deficit"}
        for m in cell.metrics(False) + cell.metrics(True):
            assert callable(spec.reader(m["name"]).read)


def test_benchmark_json_keeps_the_contracts_shape():
    s = spec.load_spec(ROOT)
    assert set(s) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024
    assert s["paths"] == ["portbench"] and 1 <= s["run_seconds"] <= 51
    assert all(not w.startswith("/") and ".." not in w for w in s["command"])
    configs = {c["name"] for c in s["configs"]}
    cells = {w["name"] for w in s["workloads"]}
    e2e = {m["name"] for m in s["end_to_end"]}
    names = [c["name"] for c in s["configs"]] + list(cells) + [
        m["name"] for m in s["end_to_end"] + s["per_layer"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for c in s["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("portbench/")
        assert (ROOT / c["file"]).exists()
        assert any(w["config"] == c["name"] for w in s["workloads"])
        assert 1 <= len(c["source"]) <= 200 and 1 <= len(c["why"]) <= 200
    for w in s["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["config"] in configs and w["chips"] in (1, 4)
        assert 1 <= len(w["why"]) <= 200
        reported = [m for m in s["end_to_end"] if spec.applies(m, w["name"])]
        assert "setup_s" in {m["name"] for m in reported} and len(reported) > 1
        assert any(spec.applies(m, w["name"]) for m in s["per_layer"])
    for m in s["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in s["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert set(m.get("workloads", cells)) <= cells
        assert m["better"] in ("lower", "higher")
        moved = [e for e in s["end_to_end"] if e["name"] == m["moves"]]
        assert all(spec.applies(moved[0], w)
                   for w in m.get("workloads", cells)), m["name"]


def test_a_new_config_mix_cell_and_metric_need_no_edit(tmp_path):
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    s = spec.load_spec(ROOT)
    base = root / "portbench"
    conf = json.loads((base / "configs" / "deep1m-graph.json").read_text())
    conf["name"] = "deep2m-graph"
    conf["data"]["n"] = 2_000_000
    (base / "configs" / "deep2m-graph.json").write_text(json.dumps(conf))
    (base / "traffic" / "small.json").write_text(json.dumps(
        {"loop": "closed", "queries_per_call": 100, "query_pool": 1000,
         "k": 10}))
    (base / "limits" / "graph2m.small.json").write_text(json.dumps(
        {"invalid_answers": 0, "dist_gap": 1e-5, "recall_deficit": 0.3}))
    (base / "metrics" / "calls.graph2m.py").write_text(
        "def read(run):\n    return len(run.calls)\n")
    s["configs"].append({"name": "deep2m-graph", "source": "x",
                         "file": "portbench/configs/deep2m-graph.json",
                         "reduced": [], "why": "x"})
    s["workloads"].append({"name": "graph2m.small", "config": "deep2m-graph",
                           "traffic": "small", "chips": 1, "why": "x"})
    s["per_layer"].append({"name": "calls.graph2m", "unit": "calls",
                           "better": "higher", "source": "host_clock",
                           "layer": "facade", "moves": "qps.graph",
                           "workloads": ["graph2m.small"]})
    for m in s["end_to_end"]:
        if m["name"] == "qps.graph":
            m["workloads"].append("graph2m.small")
    (root / "BENCHMARK.json").write_text(json.dumps(s))
    cell = spec.Cell(spec.load_spec(root), "graph2m.small", base)
    assert cell.config["data"]["n"] == 2_000_000
    assert cell.traffic["queries_per_call"] == 100
    assert [m["name"] for m in cell.metrics(True)][-1] == "calls.graph2m"
    reader = spec.reader("calls.graph2m", base)

    class R:
        calls = [1, 2]
    assert reader.read(R) == 2
    # the old cells still resolve in the new tree
    assert spec.Cell(spec.load_spec(root), "graph.batch", base).config[
        "data"]["n"] == 1_000_000


GAUSS = '''
import numpy as np


def generate(n, n_queries, seed):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(n + n_queries, 96)).astype(np.float32)
    x /= np.linalg.norm(x, axis=1, keepdims=True)
    return x[:n], x[n:], "ip"
'''

P95 = '''
import numpy as np


def read(run):
    return float(np.percentile(run.latencies, 95)) * 1e3
'''


def test_an_open_loop_cell_on_new_data_needs_no_edit(tmp_path,
                                                       monkeypatch):
    """A data generator, an open-loop mix served through the port's
    SearchEngine, a cell and a latency metric, each a new file and a new
    entry, run whole on the host."""
    import time

    from pb import harness
    monkeypatch.setattr(harness, "FORBIDDEN", ())  # a shared test process
    root = tmp_path / "checkout"
    shutil.copytree(BENCH, root / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    base = root / "portbench"
    s = spec.load_spec(ROOT)
    conf = json.loads((base / "configs" / "deep1m-graph.json").read_text())
    conf.update(name="gauss-graph", front_end={
        "engine": {"min_bucket": 8, "max_bucket": 32}})
    conf["data"] = {"generator": "gauss_like", "n": 600, "seed": 3}
    conf["index"]["build"].update(search_passes=0, refine_iters=0)
    (base / "datagen" / "gauss_like.py").write_text(GAUSS)
    (base / "configs" / "gauss-graph.json").write_text(json.dumps(conf))
    (base / "traffic" / "online.json").write_text(json.dumps(
        {"loop": "open", "query_pool": 120, "k": 10,
         "request_sizes": [1, 24], "rate_per_s": 40.0,
         "burst": {"factor": 2.0, "every_s": 0.5, "for_s": 0.1}}))
    (base / "limits" / "gauss.online.json").write_text(json.dumps(
        {"invalid_answers": 0, "dist_gap": 1e-5, "recall_deficit": 0.9}))
    (base / "metrics" / "request_p95_ms.py").write_text(P95)
    s["configs"].append({"name": "gauss-graph", "source": "x",
                         "file": "portbench/configs/gauss-graph.json",
                         "reduced": [], "why": "x"})
    s["workloads"].append({"name": "gauss.online", "config": "gauss-graph",
                           "traffic": "online", "chips": 1, "why": "x"})
    for m in s["end_to_end"]:         # the new cell reports the rate too
        if m["name"] == "qps":
            m["workloads"].append("gauss.online")
    s["end_to_end"].append({"name": "request_p95_ms", "unit": "ms",
                            "better": "lower", "bound": 0.1,
                            "source": "host_clock",
                            "workloads": ["gauss.online"]})
    (root / "BENCHMARK.json").write_text(json.dumps(s))
    cell = spec.Cell(spec.load_spec(root), "gauss.online", base)
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        result = harness.run(cell, 2 ** 31 + 9, 0.6, False, "cpu",
                             time.perf_counter())
    finally:
        torch.set_num_threads(old)
    assert result["correct"] is True, result["checks"]
    assert result["attempted"] >= 10
    assert {"qps", "recall_at_10", "setup_s", "request_p95_ms"} <= set(
        result["metrics"])
    assert result["metrics"]["request_p95_ms"]["value"] > 0


def test_without_a_card_run_exits_nonzero_and_prints_no_result():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: the no-card path is not taken")
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", "graph.batch",
         "--seed", "1", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, timeout=120, cwd=ROOT)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_without_the_program_run_exits_nonzero(tmp_path):
    """A directory that holds only BENCHMARK.json and portbench/."""
    shutil.copytree(BENCH, tmp_path / "portbench",
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    out = subprocess.run(
        [sys.executable, "-c",
         "import sys, runpy; sys.argv = ['portbench/run.py', '--workload', "
         "'graph.batch', '--seed', '1', '--seconds', '1']; "
         "import torch; torch.cuda.is_available = lambda: True; "
         "torch.cuda.device_count = lambda: 1; "
         "runpy.run_path('portbench/run.py', run_name='__main__')"],
        capture_output=True, text=True, timeout=120, cwd=tmp_path,
        env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0
    assert out.stdout.strip() == ""


class _Event:
    def __init__(self, name, act, start, dur, device=False):
        self._v = (name, act, start, dur, device)

    def name(self):
        return self._v[0]

    def activity_type(self):
        return self._v[1]

    def start_ns(self):
        return self._v[2]

    def duration_ns(self):
        return self._v[3]

    def device_type(self):
        d = torch.autograd.DeviceType
        return d.CUDA if self._v[4] else d.CPU


def test_trace_reduction_reads_kernels_copies_and_gaps():
    ev = [
        _Event("cudaLaunchKernel", "cuda_runtime", 100, 10),
        _Event("cudaStreamSynchronize", "cuda_runtime", 200, 2000),
        _Event("cudaMemcpyAsync", "cuda_runtime", 2100, 1200),
        _Event("void (anonymous namespace)::expand_kernel<F32Dist<3> >()",
               "kernel", 1000, 400, device=True),
        _Event("void at::native::reduce_kernel<512>()", "kernel", 1300, 200,
               device=True),
        _Event("Memcpy DtoH (Device -> Pageable)", "gpu_memcpy", 3000, 100,
               device=True),
        _Event("pb.call", "gpu_user_annotation", 0, 5000, device=True),
    ]
    t = tracing.TraceSummary(ev)
    # the union of 1000-1500 and 3000-3100; the annotation is no activity
    assert t.busy_s() == pytest.approx(600e-9)
    assert len(t.kernels()) == 2
    assert t.device_s(r"::(expand_kernel|warp_step_kernel)<") == \
        pytest.approx(400e-9)
    b = t.breakdown()
    assert b["device_ops"][0] == [ev[3].name(), pytest.approx(400e-9)]
    # the gap 1500-3000: at its middle the host is in cudaMemcpyAsync
    assert b["idle_gaps"] == [["cudaMemcpyAsync", pytest.approx(1500e-9)]]
    assert tracing.TraceSummary(ev[3:]).breakdown()["idle_gaps"] == [
        [tracing.NO_CALL, pytest.approx(1500e-9)]]


class _UntypedEvent(_Event):
    """An event of a torch build whose events carry no activity type."""

    def __getattribute__(self, name):
        if name == "activity_type":
            raise AttributeError(name)
        return super().__getattribute__(name)


def test_trace_reduction_without_activity_types():
    ev = [_UntypedEvent("cudaLaunchKernel", "", 100, 10),
          _UntypedEvent("void (anonymous namespace)::scan_kernel<PqScan>()",
                        "", 1000, 400, device=True),
          _UntypedEvent("Memcpy HtoD (Pageable -> Device)", "", 1500, 100,
                        device=True)]
    t = tracing.TraceSummary(ev)
    assert not hasattr(ev[0], "activity_type")
    assert [k[2] for k in t.kernels()] == [ev[1].name()]
    assert t.busy_s() == pytest.approx(500e-9)
    assert t.device_s(r"::scan_kernel<") == pytest.approx(400e-9)
