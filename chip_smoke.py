#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, one card

Phases:
  1. device and build: the card's name and power limit, the nvcc build of
     every kernel in src/repro_torch/kernels/csrc;
  2. each kernel against its plain torch version on the card, at the main
     path's shapes, with its time, its bound, the plain version's time and
     a library yardstick;
  3. the 50k anchor: deep_like at n=50,000 against the committed
     BENCH_traverse.json row (W=4, early termination on);
  4. the main path at Deep1M scale: KBest.add over 1,000,000 deep_like
     vectors (the deep_like preset with the exact kNN builder), 10,000
     queries served in batches of 1,000 through KBest.search at W=4 and
     W=1 on the kernels (L=96; the preset's L=64 once, for the record),
     then the plain path, search_padded and a save/load round trip.

Every check that fails raises, so the script exits non-zero; without a
CUDA device it exits non-zero before printing any result. The last line of
standard output is the device JSON; the line before it lists the kernels.
The full report also goes to chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 FLOP/s (no TF32)
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
RTOL, ATOL = 3e-5, 3e-4          # the reference's own (tests/test_kernels.py)
N_MAIN, Q_MAIN, BATCH = 1_000_000, 10_000, 1000
N_ANCHOR, Q_ANCHOR = 50_000, 100
# The main path's build and queue size at 1M (benchmarks/
# torch_build_quality.py on the H100): the preset's NN-descent start
# reaches kNN recall 0.21 at 1M and caps search recall@10 at 0.75 even at
# L=160, while the exact kNN builder takes about 23 s on batch_dist tiles;
# the preset's L=64 was tuned at 50k and gives 0.76 over that graph, L=96
# gives 0.83.
MAIN_BUILDER, MAIN_L = "brute", 96
DEVICE = "cuda"
ANCHOR = dict(recall=0.957, iters=23)   # BENCH_traverse.json, W=4, ET on

REPORT: dict = {}


def log(*a):
    print(*a, flush=True)


class StageLog(dict):
    """Build stage times, printed as each stage ends."""

    def __init__(self, tag):
        super().__init__()
        self.tag = tag

    def __setitem__(self, key, value):
        super().__setitem__(key, value)
        log(f"[{self.tag}] stage {key}: {value:.2f} s")


def sync():
    import torch
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def cuda_ms(fn, reps: int = 10, warmup: int = 2) -> float:
    """Median milliseconds of fn() on the card, from CUDA events."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    times.sort()
    return times[len(times) // 2]


def bound(bytes_moved: float, flops: float):
    t_b = bytes_moved / PEAK_BYTES * 1e3
    t_f = flops / PEAK_FP32 * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def close(a, b) -> "tuple[bool, float]":
    import torch
    fa, fb = torch.isfinite(a), torch.isfinite(b)
    if not torch.equal(fa, fb) or not torch.equal(a[~fa], b[~fb]):
        return False, float("inf")
    diff = (a[fa] - b[fb]).abs()
    err = float(diff.max()) if diff.numel() else 0.0
    ok = bool((diff <= ATOL + RTOL * b[fb].abs()).all())
    return ok, err


# --------------------------------------------------------------------------
# phase 1
# --------------------------------------------------------------------------
def phase_device():
    import torch
    from repro_torch.kernels import _build
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.returncode == 0 else \
        f"nvidia-smi failed: {smi.stderr.strip()}"
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    secs = _build.build_all()
    log(f"[build] {len(_build.SOURCES)} kernels in {secs:.1f} s "
        f"({_build.build_dir()})")
    for name, text in _build.build_logs.items():
        for line in text.splitlines():
            if "registers" in line or "spill" in line:
                log(f"[ptxas {name}] {line.strip()}")
    REPORT["card"] = card
    REPORT["build_s"] = secs
    return card


# --------------------------------------------------------------------------
# phase 2
# --------------------------------------------------------------------------
def phase_kernels(db):
    """Each kernel vs its plain version at the main path's shapes."""
    import torch
    from repro_torch.kernels import batch_dist as bd_mod
    from repro_torch.kernels import gather_dist as gd_mod
    from repro_torch.kernels import ref
    from repro_torch.kernels import traverse_step as ts_mod
    dev = db.device
    n, d = db.shape
    g = torch.Generator(device=dev).manual_seed(0)
    Q = 1000
    q = torch.nn.functional.normalize(
        torch.randn((Q, d), generator=g, device=dev), dim=1)
    rows = {}

    def rand_ids(M):
        ids = torch.randint(0, n, (Q, M), generator=g, device=dev,
                            dtype=torch.int32)
        drop = torch.rand((Q, M), generator=g, device=dev) < 0.05
        return torch.where(drop, torch.full_like(ids, -1), ids)

    # ---- gather_dist: seeds (M=8) and W=1 steps (M=24) ----
    for M in (8, 24):
        for metric in ("ip", "l2"):
            ids = rand_ids(M)
            out = gd_mod.gather_dist(q, db, ids, metric)
            exp = ref.gather_dist_ref(q, db, ids, metric)
            torch.cuda.synchronize()
            ok, err = close(out, exp)
            assert ok, f"gather_dist M={M} {metric}: max err {err}"
            ms = cuda_ms(lambda: gd_mod.gather_dist(q, db, ids, metric))
            plain = cuda_ms(lambda: ref.gather_dist_ref(q, db, ids, metric))
            valid = int((ids >= 0).sum())
            b_ms, b_by = bound(valid * d * 4 + Q * M * 8 + Q * d * 4,
                               3.0 * valid * d)
            log(f"[gather_dist] Q={Q} M={M} d={d} n={n} {metric}: "
                f"{ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
                f"{b_ms / ms:.1%} of it), plain {plain:.4f} ms, library none,"
                f" max err {err:.2e}")
            if M == 24 and metric == "ip":
                rows["gather_dist"] = dict(
                    max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                    bound_by=b_by, library_ms=None,
                    shape=f"Q={Q} M={M} d={d} n={n} ip")

    # ---- fused_expand: the main path's W=4 step (M=24, L=MAIN_L) and the
    # bigann preset's C=128, L=192 ----
    for W, M, L in ((4, 24, MAIN_L), (4, 32, 192)):
        C = W * M
        for metric in ("ip", "l2"):
            ids = rand_ids(C)
            # exact ties across expansions: expansion 1..W-1 repeat ids of
            # expansion 0 in some slots (bit-identical distances)
            for w in range(1, W):
                ids[:, w * M] = ids[:, 0]
                ids[:, w * M + 3] = ids[:, w]
            out = ts_mod.fused_expand(q, db, ids, metric, L, W)
            exp = ref.fused_expand_ref(q, db, ids, metric, L, W)
            torch.cuda.synchronize()
            ok_d, err = close(out[0], exp[0])
            ok_b, err_b = close(out[2], exp[2])
            sd = exp[0]
            gap_l = torch.ones_like(sd, dtype=torch.bool)
            gap_r = torch.ones_like(sd, dtype=torch.bool)
            dd = (sd[:, 1:] - sd[:, :-1]).abs()
            dd = torch.where(torch.isnan(dd), torch.zeros_like(dd), dd)
            gap_l[:, 1:] = dd > ATOL
            gap_r[:, :-1] = dd > ATOL
            sep = gap_l & gap_r
            ids_ok = bool((out[1][sep] == exp[1][sep]).all())
            ties_ok = torch.equal(out[3], exp[3])
            assert ok_d and ok_b and ids_ok and ties_ok, \
                (f"fused_expand C={C} L={L} {metric}: dists {ok_d} ({err}),"
                 f" bests {ok_b} ({err_b}), ids {ids_ok}, ties {ties_ok}")
            assert int(exp[3].sum()) > 0, "no injected tie was counted"
            ms = cuda_ms(lambda: ts_mod.fused_expand(q, db, ids, metric, L, W))
            plain = cuda_ms(lambda: ref.fused_expand_ref(q, db, ids, metric,
                                                         L, W))
            valid = int((ids >= 0).sum())
            T = min(L, C)
            b_ms, b_by = bound(valid * d * 4 + Q * C * 4 + Q * d * 4
                               + Q * T * 8 + Q * W * 8, 3.0 * valid * d)
            log(f"[fused_expand] Q={Q} W={W} M={M} C={C} L={L} d={d} "
                f"{metric}: {ms:.4f} ms, bound {b_ms:.4f} ms ({b_by}, "
                f"{b_ms / ms:.1%} of it), plain {plain:.4f} ms, library none,"
                f" max err {max(err, err_b):.2e}, separated ids equal on "
                f"{int(sep.sum())} of {sep.numel()} slots")
            if C == 96 and metric == "ip":
                rows["fused_expand"] = dict(
                    max_abs_err=max(err, err_b), ms=ms, plain_ms=plain,
                    bound_ms=b_ms, bound_by=b_by, library_ms=None,
                    shape=f"Q={Q} W={W} M={M} L={L} d={d} n={n} ip")

    # ---- batch_dist: 1000 x n x d, both metrics ----
    for metric in ("ip", "l2"):
        out = bd_mod.batch_dist(q, db, metric)
        exp = ref.batch_dist_ref(q, db, metric)
        torch.cuda.synchronize()
        ok, err = close(out, exp)
        del exp
        assert ok, f"batch_dist {metric}: max err {err}"
        ms = cuda_ms(lambda: bd_mod.batch_dist(q, db, metric), reps=5)
        plain = cuda_ms(lambda: ref.batch_dist_ref(q, db, metric), reps=5)
        lib = cuda_ms(lambda: torch.matmul(q, db.T), reps=5)
        b_ms, b_by = bound((Q * d + n * d + Q * n) * 4, 2.0 * Q * n * d)
        log(f"[batch_dist] Q={Q} B={n} d={d} {metric}: {ms:.4f} ms, bound "
            f"{b_ms:.4f} ms ({b_by}, {b_ms / ms:.1%} of it), plain "
            f"{plain:.4f} ms, library torch.matmul {lib:.4f} ms, "
            f"max err {err:.2e}")
        if metric == "ip":
            rows["batch_dist"] = dict(
                max_abs_err=err, ms=ms, plain_ms=plain, bound_ms=b_ms,
                bound_by=b_by, library_ms=lib,
                shape=f"Q={Q} B={n} d={d} ip")
        del out
    torch.cuda.synchronize()
    return rows


# --------------------------------------------------------------------------
# phase 3 and 4 helpers
# --------------------------------------------------------------------------
def serve(idx, queries, gt, scfg, k=10):
    """All queries in batches of BATCH through KBest.search; returns the
    ids and the summary row."""
    import numpy as np
    import torch
    from repro_torch.data.vectors import recall_at_k
    ids_all, it, hops, dists, et = [], [], [], [], []
    idx.search(queries[:BATCH], search_cfg=scfg)           # warm
    sync()
    t0 = time.perf_counter()
    for s in range(0, len(queries), BATCH):
        _, ids, st = idx.search(queries[s:s + BATCH], search_cfg=scfg,
                                with_stats=True)
        ids_all.append(ids)
        it.append(st.iters)
        hops.append(st.n_hops)
        dists.append(st.n_dist)
        et.append(st.early_terminated)
    sync()
    wall = time.perf_counter() - t0
    ids = torch.cat(ids_all).cpu().numpy()
    row = dict(
        W=scfg.beam_width, dist_impl=scfg.dist_impl,
        recall=recall_at_k(ids, gt, k), qps=len(queries) / wall,
        iters_mean=float(np.mean([int(x) for x in it])),
        iters_max=max(int(x) for x in it),
        hops_per_query=float(torch.cat(hops).float().mean()),
        dists_per_query=float(torch.cat(dists).float().mean()),
        et_rate=float(torch.cat(et).float().mean()))
    return ids, row


def device_busy(fn):
    """(device kernel ms, wall ms) of one call of fn, from torch.profiler:
    the sum of the CUDA kernels' own times over the host's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    sync()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        sync()
        wall_ms = (time.perf_counter() - t0) * 1e3
    cuda = torch.autograd.DeviceType.CUDA
    dev_us = sum(getattr(e, "self_device_time_total", 0.0)
                 for e in prof.key_averages() if e.device_type == cuda)
    return dev_us / 1e3, wall_ms


def phase_anchor():
    import torch
    from repro_torch.core.index import KBest
    from repro_torch.core.types import BuildConfig, IndexConfig, SearchConfig
    from repro_torch.data.vectors import make_dataset
    ds = make_dataset("deep_like", n=N_ANCHOR, n_queries=Q_ANCHOR, k=10,
                      device=DEVICE)
    # benchmarks/traverse.py's build/search config at L=64, W=4
    cfg = IndexConfig(
        dim=96, metric=ds.metric,
        build=BuildConfig(M=32, knn_k=48, builder="auto", refine_iters=1,
                          refine_cands=96, reorder="mst"),
        search=SearchConfig(L=64, k=10, early_term=True, et_patience=16,
                            beam_width=4, dist_impl="kernel"))
    t0 = time.perf_counter()
    idx = KBest(cfg, device=DEVICE).add(ds.base, timings=StageLog("anchor"))
    sync()
    build_s = time.perf_counter() - t0
    global BATCH
    old, BATCH = BATCH, Q_ANCHOR
    try:
        _, row = serve(idx, ds.queries, ds.gt_ids, cfg.search)
    finally:
        BATCH = old
    log(f"[anchor 50k] build {build_s:.1f} s, recall@10 {row['recall']:.3f}"
        f" (reference {ANCHOR['recall']}), iters {row['iters_max']} "
        f"(reference {ANCHOR['iters']}), hops/q {row['hops_per_query']:.1f},"
        f" dists/q {row['dists_per_query']:.1f}, et {row['et_rate']:.2f}")
    REPORT["anchor"] = dict(row, build_s=build_s)
    assert abs(row["recall"] - ANCHOR["recall"]) <= 0.01, row
    assert abs(row["iters_max"] - ANCHOR["iters"]) <= 3, row


def phase_main():
    import numpy as np
    import torch
    from repro_torch.configs.kbest import beam_index_config
    from repro_torch.core.index import KBest
    from repro_torch.data.vectors import exact_topk, make_dataset
    from repro_torch.kernels import ops

    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    ds = make_dataset("deep_like", n=N_MAIN, n_queries=Q_MAIN, k=10,
                      device=DEVICE)
    sync()
    data_s = time.perf_counter() - t0
    host_gt = exact_topk(ds.base, ds.queries[:100], 10, ds.metric)
    agree = np.mean([len(set(a) & set(b)) / 10
                     for a, b in zip(host_gt, ds.gt_ids[:100])])
    log(f"[main] deep_like n={N_MAIN} q={Q_MAIN}: data + ground truth "
        f"{data_s:.1f} s; device vs numpy ground truth on 100 queries: "
        f"{agree:.4f}")
    assert agree >= 0.999, agree

    preset = beam_index_config("deep_like")
    cfg = dataclasses.replace(
        preset, build=dataclasses.replace(preset.build, builder=MAIN_BUILDER),
        search=dataclasses.replace(preset.search, L=MAIN_L))
    t0 = time.perf_counter()
    idx = KBest(cfg, device=DEVICE).add(ds.base, timings=StageLog("main"))
    sync()
    build_s = time.perf_counter() - t0
    peak_gb = (torch.cuda.max_memory_allocated() / 2 ** 30
               if DEVICE == "cuda" else 0.0)
    stages = {k: round(v, 3) for k, v in idx.build_times.items()}
    log(f"[main] build {build_s:.1f} s, peak device memory {peak_gb:.2f} GiB")
    log(f"[main] build stages (s): {json.dumps(stages)}")
    REPORT["main"] = dict(n=N_MAIN, queries=Q_MAIN, data_s=data_s,
                          build_s=build_s, peak_gib=peak_gb, stages=stages,
                          rows=[])

    kern = dataclasses.replace(cfg.search, dist_impl="kernel")
    plain = dataclasses.replace(cfg.search, dist_impl="ref")
    results = {}
    # the preset's own queue size first, for the record (not asserted)
    runs = [dataclasses.replace(kern, L=preset.search.L)]
    runs += [dataclasses.replace(s, beam_width=W)
             for W in (4, 1) for s in (kern, plain)]
    for s in runs:
        ids, row = serve(idx, ds.queries, ds.gt_ids, s)
        row["L"] = s.L
        REPORT["main"]["rows"].append(row)
        if s.L == MAIN_L:
            results[(s.beam_width, s.dist_impl)] = ids
        log(f"[main] W={s.beam_width} L={s.L} {s.dist_impl}: recall@10 "
            f"{row['recall']:.4f}, QPS {row['qps']:.0f}, iters mean "
            f"{row['iters_mean']:.1f} max {row['iters_max']}, hops/q "
            f"{row['hops_per_query']:.1f}, dists/q "
            f"{row['dists_per_query']:.1f}, ET rate {row['et_rate']:.3f}")
    for W in (4, 1):
        s = dataclasses.replace(kern, beam_width=W)
        dev_ms, wall_ms = device_busy(
            lambda: idx.search(ds.queries[:BATCH], search_cfg=s))
        log(f"[main] profile W={W}, one batch of {BATCH}: device kernels "
            f"{dev_ms:.2f} ms of {wall_ms:.2f} ms wall (idle share "
            f"{1 - dev_ms / wall_ms:.1%}, under the profiler)")
        REPORT["main"][f"profile_W{W}"] = dict(device_ms=dev_ms,
                                              wall_ms=wall_ms)
    rec = {(r["W"], r["dist_impl"]): r["recall"]
           for r in REPORT["main"]["rows"] if r["L"] == MAIN_L}
    assert rec[(4, "kernel")] >= 0.80, rec
    for W in (4, 1):
        same = float(np.mean(results[(W, "kernel")] == results[(W, "ref")]))
        log(f"[main] W={W} kernel vs plain: ids equal on {same:.4%} of "
            f"(query, rank), recall delta "
            f"{rec[(W, 'kernel')] - rec[(W, 'ref')]:+.4f}")
        assert same >= 0.995, same
        assert abs(rec[(W, "kernel")] - rec[(W, "ref")]) <= 0.002, rec

    # padded batch: valid rows equal search, padded rows (+inf, -1), 0 stats
    qb = ds.queries[:BATCH]
    vm = np.ones(BATCH, bool)
    vm[::7] = False
    d0, i0 = idx.search(qb[vm], search_cfg=kern)
    d1, i1, st = idx.search_padded(qb, vm, search_cfg=kern, with_stats=True)
    vmt = torch.as_tensor(vm, device=d1.device)
    assert torch.equal(i1[vmt], i0) and torch.equal(d1[vmt], d0)
    assert bool(torch.isinf(d1[~vmt]).all()) and bool((i1[~vmt] == -1).all())
    assert int(st.n_hops[~vmt].sum()) == 0 and int(st.n_dist[~vmt].sum()) == 0
    log("[main] search_padded: valid rows equal search, padded rows empty")

    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        idx.save(f"{tmp}/deep1m.graph")
        idx2 = KBest.load(f"{tmp}/deep1m.graph", device=DEVICE)
        rt_s = time.perf_counter() - t0
    _, i2 = idx2.search(qb, search_cfg=kern)
    _, i3 = idx.search(qb, search_cfg=kern)
    assert torch.equal(i2, i3)
    log(f"[main] save/load round trip {rt_s:.1f} s: identical ids")
    counts = ops.launch_counts()
    log(f"[main] kernel launches on the main path: {counts}")
    for name in ("fused_expand", "gather_dist", "batch_dist"):
        assert counts[name] > 0, counts
    REPORT["main"]["launches"] = counts
    return counts


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import ops  # noqa: F401  (fails outside the repo)

    t_all = time.perf_counter()
    card = phase_device()
    log(f"[device] {torch.cuda.get_device_name(0)}; {card}")
    from repro_torch.data.vectors import make_dataset
    g = torch.Generator(device="cuda").manual_seed(1)
    db = torch.nn.functional.normalize(
        torch.randn((N_MAIN, 96), generator=g, device="cuda"), dim=1)
    rows = phase_kernels(db)
    del db
    torch.cuda.empty_cache()
    phase_anchor()
    counts = phase_main()
    sources = {"gather_dist": ("src/repro_torch/kernels/csrc/gather_dist.cu",
                               "src/repro/kernels/gather_dist.py:49"),
               "fused_expand": ("src/repro_torch/kernels/csrc/traverse_step.cu",
                                "src/repro/kernels/traverse_step.py:102"),
               "batch_dist": ("src/repro_torch/kernels/csrc/batch_dist.cu",
                              "src/repro/kernels/batch_dist.py:45")}
    kernels = []
    for name, (src, rep) in sources.items():
        r = rows[name]
        kernels.append(dict(name=name, route="cuda", source=src,
                            replaces=rep, launches=counts[name],
                            max_abs_err=r["max_abs_err"], ms=r["ms"],
                            plain_ms=r["plain_ms"], bound_ms=r["bound_ms"],
                            bound_by=r["bound_by"],
                            library_ms=r["library_ms"], shape=r["shape"]))
    REPORT["kernels"] = kernels
    REPORT["total_s"] = time.perf_counter() - t_all
    out = ROOT / "chiprun_out"
    out.mkdir(exist_ok=True)
    (out / "chip_smoke.json").write_text(json.dumps(REPORT, indent=1))
    log(f"[done] {REPORT['total_s']:.1f} s")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
