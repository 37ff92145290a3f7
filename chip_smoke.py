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
     then the plain path, search_padded and a save/load round trip;
  5. the quantized kinds on the same Deep1M graph (no second build): the
     `sq` preset and the registry's `pq8` (pq_m=16) attached to a clone
     of the built index, trained, and served like phase 4 at W=4 and W=1,
     kernel and plain, with a save/load round trip of each, `pq8` once
     more with the re-rank over the whole queue of L, and a check that PQ
     training on the card is deterministic.

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
from typing import Callable, NamedTuple

ROOT = Path(__file__).resolve().parent
sys.path.insert(0, str(ROOT / "src"))

# H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, fp32 FLOP/s (no TF32)
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
L2_BYTES = 50 * 2 ** 20          # the H100's L2 cache
SECTOR = 32                      # bytes: the least a gather reads from HBM
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


def graph_ms(fn, sets, n: int = 20, reps: int = 5) -> float:
    """Median device milliseconds per call of fn(*args): max(n, len(sets))
    calls, rotating through the argument tuples `sets`, captured in one
    CUDA graph and replayed between two CUDA events. The host's time to
    enqueue each call (the Python wrapper, its checks) is not counted, and
    the sets gather more bytes in all than the card's L2 holds, so each
    call reads its rows from HBM, as the traversal's iterations do."""
    import torch
    n = max(n, len(sets))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for args in sets[:2]:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for i in range(n):
            fn(*sets[i % len(sets)])
    graph.replay()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        graph.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / n)
    del graph
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
def separated_ids_equal(out, exp):
    """(ok, slots): the sorted ids agree wherever a distance is apart from
    both neighbours by more than ATOL (near-ties may swap)."""
    import torch
    sd = exp[0]
    gap_l = torch.ones_like(sd, dtype=torch.bool)
    gap_r = torch.ones_like(sd, dtype=torch.bool)
    dd = (sd[:, 1:] - sd[:, :-1]).abs()
    dd = torch.where(torch.isnan(dd), torch.zeros_like(dd), dd)
    gap_l[:, 1:] = dd > ATOL
    gap_r[:, :-1] = dd > ATOL
    sep = gap_l & gap_r
    return bool((out[1][sep] == exp[1][sep]).all()), int(sep.sum())


class Case(NamedTuple):
    """One kernel at one shape. kern(*args) and plain(*args) run it and
    its plain version on one argument tuple of `sets` (set 0 is the one
    checked); cost(*args) gives the (bytes, operations) the function needs
    on those inputs."""
    name: str
    shape: str
    main: bool           # the shape whose numbers go into the kernels line
    fused: bool          # returns (dists, ids, bests, ties)
    kern: Callable
    plain: Callable
    cost: Callable
    sets: list


def pq_bytes(codes, ids) -> int:
    """Bytes of the (Q, m, K) f32 tables and the (n, m) u8 codes that a
    PQ ADC over `ids` must read: per query and subspace, the distinct
    32-byte sectors of its table that the valid ids' codes hit, and per
    valid id its code row, m bytes rounded up to whole sectors."""
    import torch
    valid = ids >= 0
    sec = codes[ids.clamp(min=0).long()].long() * 4 // SECTOR   # (Q, B, m)
    sec = torch.where(valid[..., None], sec, torch.full_like(sec, -1))
    sec = sec.sort(dim=1).values
    first = torch.ones_like(sec, dtype=torch.bool)
    first[:, 1:] = sec[:, 1:] != sec[:, :-1]
    tables = int((first & (sec >= 0)).sum()) * SECTOR
    return tables + int(valid.sum()) * -(-codes.shape[1] // SECTOR) * SECTOR


def kernel_inputs(db) -> dict:
    """Phase 2's operands over the (n, d) f32 rows `db`: Q=1000 unit
    queries, SQ codes of the n rows with per-dimension scale and zero, PQ8
    codes with m=16 subspaces of K=256 centroids, and the generator that
    draws the ids and tables of kernel_cases."""
    import torch
    dev = db.device
    n, d = db.shape
    g = torch.Generator(device=dev).manual_seed(0)
    Q, m, K = 1000, 16, 256
    q = torch.nn.functional.normalize(
        torch.randn((Q, d), generator=g, device=dev), dim=1)
    codes = torch.randint(0, 256, (n, d), generator=g, device=dev,
                          dtype=torch.int32).to(torch.uint8)
    scale = torch.rand((d,), generator=g, device=dev) * 0.01 + 1e-3
    zero = -torch.rand((d,), generator=g, device=dev) * 0.5
    pcodes = torch.randint(0, K, (n, m), generator=g, device=dev,
                           dtype=torch.int32).to(torch.uint8)
    return dict(db=db, q=q, codes=codes, scale=scale, zero=zero,
                pcodes=pcodes, K=K, g=g)


def kernel_cases(inp: dict) -> "list[Case]":
    """Every kernel at the shapes the served paths give it: the gathers at
    seeds (M=8) and W=1 steps (M=24), the fused steps at the W=4 step
    (C=96, L=MAIN_L; fused_expand also at the bigann preset's C=128,
    L=192), both metrics where a kernel takes one, and batch_dist over the
    whole db. Ids are random rows with 5% set to -1; the fused steps' ids
    repeat rows across expansions, so exact ties occur. Each case holds
    enough argument sets that they gather twice the card's L2 in all. The
    kernels are called through `ops`, so any checkout's can be timed."""
    import torch
    from repro_torch.kernels import ops, ref
    db, q, codes, scale, zero, pcodes, K, g = (
        inp[k] for k in ("db", "q", "codes", "scale", "zero", "pcodes", "K",
                         "g"))
    dev, (n, d), (Q, m) = db.device, db.shape, (q.shape[0], pcodes.shape[1])
    cases = []

    def rand_ids(M):
        ids = torch.randint(0, n, (Q, M), generator=g, device=dev,
                            dtype=torch.int32)
        drop = torch.rand((Q, M), generator=g, device=dev) < 0.05
        return torch.where(drop, torch.full_like(ids, -1), ids)

    def tied_ids(W, M):
        """C = W*M ids where expansions 1..W-1 repeat ids of expansion 0
        in some slots (bit-identical distances, so exact ties)."""
        ids = rand_ids(W * M)
        for w in range(1, W):
            ids[:, w * M] = ids[:, 0]
            ids[:, w * M + 3] = ids[:, w]
        return ids

    def lut():
        return torch.randn((Q, m, K), generator=g, device=dev)

    def valid(ids):
        return int((ids >= 0).sum())

    def add(name, shape, main, fused, kern, plain, cost, draw):
        first = draw()
        k = min(256, max(1, -(-2 * L2_BYTES // cost(*first)[0])))
        cases.append(Case(name, shape, main, fused, kern, plain, cost,
                          [first] + [draw() for _ in range(k - 1)]))

    # ---- the gathers: seeds (M=8) and W=1 steps (M=24); bytes: the valid
    # rows or codes, ids and outputs, queries, SQ scale and zero ----
    for M in (8, 24):
        io = Q * M * 8 + Q * d * 4
        for mt in ("ip", "l2"):
            shape = f"Q={Q} M={M} d={d} n={n} {mt}"
            main = M == 24 and mt == "ip"
            add("gather_dist", shape, main, False,
                lambda ids, mt=mt: ops.gather_dist(q, db, ids, metric=mt),
                lambda ids, mt=mt: ref.gather_dist_ref(q, db, ids, mt),
                lambda ids, io=io: (valid(ids) * d * 4 + io,
                                    3.0 * valid(ids) * d),
                lambda M=M: (rand_ids(M),))
            add("sq_gather_dist", shape, main, False,
                lambda ids, mt=mt: ops.sq_gather_dist(q, codes, scale, zero,
                                                      ids, metric=mt),
                lambda ids, mt=mt: ref.sq_gather_dist_ref(q, codes, scale,
                                                          zero, ids, mt),
                lambda ids, io=io: (valid(ids) * d + io + d * 8,
                                    4.0 * valid(ids) * d),
                lambda M=M: (rand_ids(M),))
        add("pq_adc", f"Q={Q} B={M} m={m} K={K} n={n}", M == 24, False,
            lambda t, ids: ops.pq_adc(t, pcodes, ids),
            lambda t, ids: ref.pq_adc_ref(t, pcodes, ids),
            lambda t, ids, M=M: (pq_bytes(pcodes, ids) + Q * M * 8,
                                 float(valid(ids) * m)),
            lambda M=M: (lut(), rand_ids(M)))

    # ---- the fused steps; bytes as the gathers', with (Q, T) sorted
    # dists and ids and (Q, W) bests and ties out ----
    for W, M, L in ((4, 24, MAIN_L), (4, 32, 192)):
        C, T = W * M, min(L, W * M)
        io = Q * C * 4 + Q * T * 8 + Q * W * 8
        for mt in ("ip", "l2"):
            shape = f"Q={Q} W={W} M={M} L={L} d={d} n={n} {mt}"
            main = C == 96 and mt == "ip"
            add("fused_expand", shape, main, True,
                lambda ids, mt=mt, L=L, W=W: ops.fused_expand(
                    q, db, ids, metric=mt, L=L, n_beam=W),
                lambda ids, mt=mt, L=L, W=W: ref.fused_expand_ref(
                    q, db, ids, mt, L, W),
                lambda ids, io=io: (valid(ids) * d * 4 + Q * d * 4 + io,
                                    3.0 * valid(ids) * d),
                lambda W=W, M=M: (tied_ids(W, M),))
            if C != 96:
                continue
            add("fused_expand_sq", shape, main, True,
                lambda ids, mt=mt, L=L, W=W: ops.fused_expand_sq(
                    q, codes, scale, zero, ids, metric=mt, L=L, n_beam=W),
                lambda ids, mt=mt, L=L, W=W: ref.fused_expand_sq_ref(
                    q, codes, scale, zero, ids, mt, L, W),
                lambda ids, io=io: (valid(ids) * d + Q * d * 4 + d * 8 + io,
                                    4.0 * valid(ids) * d),
                lambda W=W, M=M: (tied_ids(W, M),))
        if C == 96:
            add("fused_expand_pq", f"Q={Q} W={W} M={M} L={L} m={m} K={K} "
                f"n={n}", True, True,
                lambda t, ids, L=L, W=W: ops.fused_expand_pq(
                    t, pcodes, ids, L=L, n_beam=W),
                lambda t, ids, L=L, W=W: ref.fused_expand_pq_ref(
                    t, pcodes, ids, L, W),
                lambda t, ids, io=io: (pq_bytes(pcodes, ids) + io,
                                       float(valid(ids) * m)),
                lambda W=W, M=M: (lut(), tied_ids(W, M)))

    # ---- batch_dist: Q x n x d, both metrics; a 4 GB output a call ----
    for mt in ("ip", "l2"):
        add("batch_dist", f"Q={Q} B={n} d={d} {mt}", mt == "ip", False,
            lambda mt=mt: ops.batch_dist(q, db, metric=mt),
            lambda mt=mt: ref.batch_dist_ref(q, db, mt),
            lambda: ((Q * d + n * d + Q * n) * 4, 2.0 * Q * n * d),
            lambda: ())
    return cases


def phase_kernels(db):
    """Each kernel vs its plain version at the served paths' shapes: the
    error; `ms`, one call with its launch between CUDA events (the time
    of PR 11's table); `device_ms`, the device time per call from graph
    replay over the case's argument sets; the plain version's two times;
    the bound from those inputs; and the library yardstick."""
    import torch
    inp = kernel_inputs(db)
    rows = {}
    for c in kernel_cases(inp):
        out, exp = c.kern(*c.sets[0]), c.plain(*c.sets[0])
        torch.cuda.synchronize()
        note = ""
        if c.fused:
            ok_d, err = close(out[0], exp[0])
            ok_b, err_b = close(out[2], exp[2])
            ids_ok, n_sep = separated_ids_equal(out, exp)
            ties_ok = torch.equal(out[3], exp[3])
            assert ok_d and ok_b and ids_ok and ties_ok, \
                (f"{c.name} {c.shape}: dists {ok_d} ({err}), bests {ok_b} "
                 f"({err_b}), ids {ids_ok}, ties {ties_ok}")
            assert int(exp[3].sum()) > 0, "no injected tie was counted"
            err = max(err, err_b)
            note = (f", separated ids equal on {n_sep} of "
                    f"{exp[0].numel()} slots")
        else:
            ok, err = close(out, exp)
            assert ok, f"{c.name} {c.shape}: max err {err}"
        del out, exp
        costs = [c.cost(*args) for args in c.sets]
        b_ms, b_by = bound(sum(b for b, _ in costs) / len(costs),
                           sum(f for _, f in costs) / len(costs))
        t = dict(ms=cuda_ms(lambda: c.kern(*c.sets[0])),
                 plain_ms=cuda_ms(lambda: c.plain(*c.sets[0])))
        if c.name == "batch_dist":
            # its launch is a negligible share of a call; no graph
            t.update(device_ms=t["ms"], plain_device_ms=t["plain_ms"])
            lib = ("torch.matmul", cuda_ms(
                lambda: torch.matmul(inp["q"], db.T)))
        else:
            t.update(device_ms=graph_ms(c.kern, c.sets),
                     plain_device_ms=graph_ms(c.plain, c.sets))
            lib = None
        log(f"[{c.name}] {c.shape}: {t['device_ms']:.4f} ms on the device "
            f"over {len(c.sets)} input sets ({t['ms']:.4f} ms a call with "
            f"its launch), bound {b_ms:.4f} ms ({b_by}, "
            f"{b_ms / t['device_ms']:.1%} of it), plain "
            f"{t['plain_device_ms']:.4f} ms ({t['plain_ms']:.4f}), library "
            + ("none" if lib is None else f"{lib[0]} {lib[1]:.4f} ms")
            + f", max err {err:.2e}{note}")
        if c.main:
            rows[c.name] = dict(max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
                                library_ms=None if lib is None else lib[1],
                                shape=c.shape, sets=len(c.sets), **t)
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
    return counts, idx, ds, rec


def phase_quant(idx, ds, none_rec):
    """The sq preset and the registry's pq8 on phase 4's graph: a clone of
    the built index (db, graph, entry, order) with the quantizer trained
    over its rows, as the reference's tuner attaches one, served at W=4
    and W=1 with the kernels and with the plain path."""
    import numpy as np
    import torch
    from repro_torch.configs.kbest import sq_index_config
    from repro_torch.core import quantize as qz
    from repro_torch.core.index import KBest
    from repro_torch.core.types import QuantConfig
    from repro_torch.kernels import ops

    quants = {"sq": sq_index_config("deep_like").quant,
              "pq": QuantConfig(**qz.quant_variants()["pq8"])}
    kern = dataclasses.replace(idx.config.search, dist_impl="kernel")
    plain = dataclasses.replace(kern, dist_impl="ref")
    qb = ds.queries[:BATCH]
    s4 = dataclasses.replace(kern, beam_width=4)
    served = {"none": idx}
    REPORT["quant"] = {}
    ops.reset_launch_counts()
    for kind, quant in quants.items():
        cfg = dataclasses.replace(idx.config, quant=quant)
        qidx = KBest(cfg, device=DEVICE)
        qidx._set_state(idx.db, idx.graph, idx.entry, idx.order)
        t0 = time.perf_counter()
        qidx._train_quant(qidx.db)
        sync()
        train_s = time.perf_counter() - t0
        code_b = qz.code_bytes_per_vector(qidx)
        log(f"[{kind}] {quant}: trained and encoded {len(qidx.db):,} rows "
            f"in {train_s:.1f} s, {code_b} code bytes per vector")
        rep_q = REPORT["quant"][kind] = dict(train_s=train_s,
                                              code_bytes=code_b, rows=[])
        results, rec = {}, {}
        for W in (4, 1):
            for s in (kern, plain):
                s = dataclasses.replace(s, beam_width=W)
                ids, row = serve(qidx, ds.queries, ds.gt_ids, s)
                row["L"] = s.L
                rep_q["rows"].append(row)
                results[(W, s.dist_impl)] = ids
                rec[(W, s.dist_impl)] = row["recall"]
                log(f"[{kind}] W={W} L={s.L} {s.dist_impl}: recall@10 "
                    f"{row['recall']:.4f}, QPS {row['qps']:.0f}, iters mean "
                    f"{row['iters_mean']:.1f} max {row['iters_max']}, hops/q "
                    f"{row['hops_per_query']:.1f}, dists/q "
                    f"{row['dists_per_query']:.1f}, ET rate "
                    f"{row['et_rate']:.3f}")
        dev_ms, wall_ms = device_busy(lambda: qidx.search(qb, search_cfg=s4))
        log(f"[{kind}] profile W=4, one batch of {BATCH}: device kernels "
            f"{dev_ms:.2f} ms of {wall_ms:.2f} ms wall (idle share "
            f"{1 - dev_ms / wall_ms:.1%}, under the profiler)")
        rep_q["profile_W4"] = dict(device_ms=dev_ms, wall_ms=wall_ms)
        for W in (4, 1):
            same = float(np.mean(results[(W, "kernel")]
                                 == results[(W, "ref")]))
            log(f"[{kind}] W={W} kernel vs plain: ids equal on {same:.4%} "
                f"of (query, rank), recall delta "
                f"{rec[(W, 'kernel')] - rec[(W, 'ref')]:+.4f}; kind none at "
                f"this W: {none_rec[(W, 'kernel')]:.4f}")
            assert same >= 0.995, (kind, W, same)
            assert abs(rec[(W, "kernel")] - rec[(W, "ref")]) <= 0.002, rec
            if kind == "sq":
                # the preset's docstring: nearly recall-transparent
                assert rec[(W, "kernel")] >= none_rec[(W, "kernel")] - 0.02, \
                    (rec, none_rec)
            else:
                # a build-fault detector only; the value is recorded
                assert rec[(W, "kernel")] >= 0.60, rec
        with tempfile.TemporaryDirectory() as tmp:
            t0 = time.perf_counter()
            qidx.save(f"{tmp}/deep1m_{kind}.graph")
            back = KBest.load(f"{tmp}/deep1m_{kind}.graph", device=DEVICE)
            rt_s = time.perf_counter() - t0
        _, i2 = back.search(qb, search_cfg=s4)
        _, i3 = qidx.search(qb, search_cfg=s4)
        assert torch.equal(i2, i3)
        log(f"[{kind}] save/load round trip {rt_s:.1f} s: identical ids")
        rep_q["save_load_s"] = rt_s
        served[kind] = qidx
        del back
        if kind == "pq":
            # the same codes re-ranked over the whole queue of L (the
            # default depth is 4k = 40): how much of pq8's recall the
            # re-rank depth holds back
            deep = KBest(dataclasses.replace(cfg, quant=dataclasses.replace(
                quant, rerank=s4.L)), device=DEVICE)
            deep._set_state(idx.db, idx.graph, idx.entry, idx.order)
            deep.pq, deep.pq_codes = qidx.pq, qidx.pq_codes
            _, row = serve(deep, ds.queries, ds.gt_ids, s4)
            log(f"[pq] W=4 kernel, re-rank depth {s4.L}: recall@10 "
                f"{row['recall']:.4f} (depth 40: {rec[(4, 'kernel')]:.4f}),"
                f" QPS {row['qps']:.0f}, dists/q {row['dists_per_query']:.1f}")
            rep_q["rerank_L"] = row
            del deep
    counts = ops.launch_counts()
    log(f"[quant] kernel launches on the quantized paths: {counts}")
    # the three kinds' QPS in turns (none, sq, pq, pq, sq, none) at W=4 on
    # the kernels: the host's speed drifts within a run, so the kinds are
    # compared side by side and not across phases
    qps = {kind: [] for kind in served}
    for kind in [*served, *reversed(served)]:
        qps[kind].append(serve(served[kind], ds.queries, ds.gt_ids,
                               s4)[1]["qps"])
    log("[quant] QPS in turns, W=4 kernel: " + ", ".join(
        f"{kind} {a:.0f} / {b:.0f}" for kind, (a, b) in qps.items()))
    REPORT["quant"]["qps_in_turns"] = qps
    for name in ("sq_gather_dist", "fused_expand_sq", "pq_adc",
                 "fused_expand_pq", "gather_dist"):
        assert counts[name] > 0, counts
    REPORT["quant"]["launches"] = counts

    # PQ training on the card is deterministic: two trainings, one result
    sub = idx.db[:100_000]
    a = qz.pq_train(sub, quants["pq"]).codebooks
    b = qz.pq_train(sub, quants["pq"]).codebooks
    assert torch.equal(a, b), "pq_train differs between two runs"
    log("[pq] two pq_train runs on 100,000 rows: identical codebooks")
    return counts


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import ops  # noqa: F401  (fails outside the repo)

    t_all = time.perf_counter()
    phase_s = REPORT["phase_s"] = {}

    def timed(name, fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        phase_s[name] = time.perf_counter() - t0
        log(f"[phase] {name}: {phase_s[name]:.1f} s")
        return out

    card = timed("device and build", phase_device)
    log(f"[device] {torch.cuda.get_device_name(0)}; {card}")
    g = torch.Generator(device="cuda").manual_seed(1)
    db = torch.nn.functional.normalize(
        torch.randn((N_MAIN, 96), generator=g, device="cuda"), dim=1)
    rows = timed("kernels", phase_kernels, db)
    del db
    torch.cuda.empty_cache()
    timed("anchor", phase_anchor)
    counts, idx, ds, none_rec = timed("main", phase_main)
    qcounts = timed("quant", phase_quant, idx, ds, none_rec)
    csrc = "src/repro_torch/kernels/csrc/"
    # name: (source, the TPU kernel it replaces, the path whose launches
    # count: phase 4's main path or phase 5's quantized paths)
    sources = {
        "gather_dist": (csrc + "gather_dist.cu",
                        "src/repro/kernels/gather_dist.py:49", counts),
        "fused_expand": (csrc + "traverse_step.cu",
                         "src/repro/kernels/traverse_step.py:102", counts),
        "batch_dist": (csrc + "batch_dist.cu",
                       "src/repro/kernels/batch_dist.py:45", counts),
        "sq_gather_dist": (csrc + "gather_dist.cu",
                           "src/repro/kernels/gather_dist.py:99", qcounts),
        "fused_expand_sq": (csrc + "traverse_step.cu",
                            "src/repro/kernels/traverse_step.py:160", qcounts),
        "pq_adc": (csrc + "pq_adc.cu", "src/repro/kernels/pq_adc.py:36",
                   qcounts),
        "fused_expand_pq": (csrc + "traverse_step.cu",
                            "src/repro/kernels/traverse_step.py:222", qcounts)}
    kernels = []
    for name, (src, rep, path_counts) in sources.items():
        kernels.append(dict(name=name, route="cuda", source=src,
                            replaces=rep, launches=path_counts[name],
                            **rows[name]))
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
