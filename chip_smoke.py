#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (src/repro_torch) on one NVIDIA GPU.

    python3 chip_smoke.py            # all phases, one card

Phases:
  1. device and build: the card's name and power limit, the nvcc build of
     every kernel in src/repro_torch/kernels/csrc, the port's lint
     (`repro_torch.analysis`, all seven checks; any violation fails) and
     its static shared bytes of each kernel held against the `bytes smem`
     that ptxas reports for each instantiation;
  2. each kernel against its plain torch version on the card, at the main
     path's shapes, with its time, its bound, the plain version's time and
     a library yardstick (the bin kernels, the PQ and PQ4 gathers and
     fused steps and the list scans exactly; the PQ gathers also on code
     rows at a 1-byte offset, `pq_adc` at m=12 over K=64 tables and
     `pq4_adc` over u8-requantized tables; `fused_expand_pq` also on code
     rows at a 1-byte offset, at m=12 over K=64 and at m=32, at C=128 and
     C=192, at the traversal's share of valid ids and on tables at a
     4-byte offset; `fused_expand_pq4` also on code rows at a 1-byte
     offset, at m=32 and over u8-requantized tables, `fused_expand_bin`
     also at nw=4 and 7, and both at C=128 and C=192, at the traversal's
     share of valid ids and with one expansion's ids all -1; `bin_dist`
     also at nw=4 and 7 and at B=1 and 33;
     `ivf_scan` also at 4x the ivf_pq preset's nprobe, and it and the bin
     scan on a tie storm and at L = max_len; `beam_filter`, which replaces
     no TPU kernel, at the graph cell's Q=10,000, W=4, M=24, L=320, at the
     build's search pass, over a queue longer than one tile and in bitmap
     mode, exactly), and the gathers' and fused steps' fixed costs split
     by calls on ids that are all -1;
  3. the 50k anchor: deep_like at n=50,000 against the committed
     BENCH_traverse.json row (W=4, early termination on);
  4. the main path at Deep1M scale: KBest.add over 1,000,000 deep_like
     vectors (the deep_like preset with the exact kNN builder), 10,000
     queries served in batches of 1,000 through KBest.search at W=4 and
     W=1 on the kernels (L=96; the preset's L=64 once, for the record),
     then the plain path, search_padded and a save/load round trip of
     the same config over the first ROUND_TRIP_N rows;
  5. the quantized kinds on the same Deep1M graph (no second build): the
     `sq` preset and the registry's `pq8` (pq_m=16) attached to a clone
     of the built index, trained, and served like phase 4 at W=4 and W=1,
     kernel and plain, with a save/load round trip of each (the kind
     attached to a graph over the first ROUND_TRIP_N rows, as in phases
     6-8), `pq8` once more with the re-rank over the whole queue of L,
     and a check that PQ training on the card is deterministic;
  6. the 8- and 12-byte kinds on the same graph, the same way: the
     registry's `pq4` and `pq4+u8lut` (pq_m=16, L=96) and the `bin`
     preset (L=320, re-rank of rescore_factor * k = 320), all 10,000
     queries at W=4 and W=1 on the kernels, one batch of each on the plain
     path, QPS in turns with `none`, a save/load round trip of a pq4 and
     a bin index at ROUND_TRIP_N rows, and what caps their recall at 1M:
     pq4 re-ranked over its whole queue, bin twice as deep, and the share
     of the true top-10 within bin's exact Hamming top-320 over all rows;
  7. the IVF family on the same 1,000,000 vectors and 10,000 queries (no
     graph): the `ivf_index_config`, `ivf_pq4_index_config` and
     `ivf_bin_index_config` presets for deep_like (nlist = 1,000, residual
     codes, ip) built on the card and served in batches of 1,000 through
     the three list-scan kernels, one batch of each on the plain path,
     `ivf_pq` once more at 4x its nprobe, and a save/load round trip of
     the bin preset at ROUND_TRIP_N rows;
  8. the sharded composition (`ShardedKBest`) on the same vectors and
     queries: phase 4's index wrapped as one shard (bit-identical to
     `KBest.search`), phase 4's config over two shards (two independent
     500,000-row builds) served at W=4 and W=1, a save/load round trip
     of two shards over ROUND_TRIP_N rows, and
     `sharded_ivf_index_config("deep_like")` (two shards of `ivf_pq`,
     nlist = sqrt(500,000)) beside phase 7's row;
  9. the serving tier: a `SearchEngine` (buckets 8-256) over phase 4's
     graph, warmed (6 traces), a closed `serve_loop` drain of all queries
     as seeded requests of 1-64 with every request's ids held against
     `KBest.search`, the same drain over phase 8's two shards, the
     dispatch latency at buckets 8 and 256, and the reference's overload
     pair (benchmarks/serving.py: Poisson arrivals at twice the measured
     capacity, no policy against admission + degrade ladder + bounded
     queue) over phase 7's `ivf_pq` index;
 10. the tuner (core/tune.py) on the same vectors, queries and ground
     truth, every search on the kernels: `tune_early_term` on phase 4's
     graph at W=4, L=96 over 1,000 queries, then the tuned and untuned
     configs in turns over the other 9,000; `tune_quant_kind(pq_m=16)`
     on the same graph (five quantizer trainings at 1M); `tune_config`
     over the IVF kinds at 1M (5,000 tune and 5,000 holdout queries, SLO
     0.90) and over the graph kinds at 100,000 vectors (a cut: one more
     1M graph build would cost about 90 s), each held to the reference's
     invariants (at most half the grid measured, rows cheapest-first,
     the winner the first row at SLO + margin, else the best measured
     with a note);
 11. the RecSys family (models/recsys.py) at each arch's full_config()
     (10^6 ids a field or items, the assigned widths, f32): fm, deepfm,
     bst and bert4rec each take 20 AdamW steps through the port's Trainer
     on the pipeline's streams (B=65,536; bert4rec B=8 with the full
     loss and B=32 with 40 masked positions), bst once more with a failure
     injected at step 12 and a resume from its step-10 checkpoint, held to
     the uninterrupted run; serve_step at 512 and 262,144 rows (bert4rec
     16,384); exact retrieval on batch_dist against the plain path at 1
     and 512 queries over the 10^6 candidates; and a KBest graph over
     the first 500,000 rows of bst's item table (the reference example's
     config at full width, cut from 10^6 to keep the smoke inside its
     limit) searched with 512 query vectors, its recall@10 against the
     exact top-10 of those rows;
 12. the LM and GNN families (models/transformer.py, layers/moe.py,
     models/dimenet.py): (a) each of the six smoke configs on the card
     against the port on the host with the same params, f32 with TF32
     off (forward, loss, every gradient, prefill, four decode steps; the
     MoE archs' routing and kept sets equal); (b) the five LM archs at
     their full widths in bf16 with seeded weights, depth cut only where
     one card forces it (llama4-scout 12 of 48 layers, kimi-k2 1 of 61):
     prefill at B=1 (S=4,096; 2,048 for the two MoE archs), 32 greedy
     decode steps from a cache of 32,768 positions (B=4; 8 for chatglm3
     and gemma, 2 for llama4) with the step's memory floor and the card's
     busy share of BUSY_STEPS steps, and prefill + decode against a
     forward over the same 256 tokens; (c) 20 AdamW steps (donated
     buffers) of gemma-2b at full depth, B=1 x 4,096, and of
     llama4-scout at one layer, B=1 x 2,048;
     (d) DimeNet's molecule and minibatch_lg shapes, 20 steps each
     through the Trainer, one batch's forward against the host; (e) the
     launchers' `--mode lm` and `--arch dimenet` on their default device;
 13. the device mesh (launch/mesh.py), run after phase 10 while phase 4's
     index is held: an NCCL process group of one rank over a file store
     and make_test_mesh(); (a) build_sharded_search over phase 4's graph
     as the one shard, on the gather_dist kernel, all queries at W=4 and
     W=1, ids and distances bit-equal to `search`, recall@10 and QPS;
     (b) serve_retrieval_shardmap on batch_dist over bst's 10^6-item
     table at full width, 1 and 512 queries, against serve_retrieval;
     (c) moe_ffn_shardmap at ep = tp = 1 against moe_ffn: both MoE archs'
     f32 smoke layers (forward, aux, every gradient) and one llama4-scout
     layer at full width in bf16;
 14. the shape layer (sharding/rules.py, launch/specs.py,
     launch/dryrun.py), once phase 13's group is gone: (a) the dry-run of
     the 40 (arch x shape) cells on both production meshes (256 and 512
     ranks over a `fake` process group, each step once on meta tensors)
     in two subprocesses at once, one a mesh, all 80 records ok; (b) the per-rank shards of the
     record with the most per-rank argument bytes below half the card's
     free memory allocated on the card, memory_allocated held to the
     record's bytes. No kernel launches.

Every check that fails raises, so the script exits non-zero; without a
CUDA device it exits non-zero before printing any result. The last line of
standard output is the device JSON; the line before it lists the kernels.
The full report also goes to chiprun_out/chip_smoke.json.
"""
from __future__ import annotations

import dataclasses
import json
import math
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
# the save/load round trips of phases 4-8 run on indexes over the first
# ROUND_TRIP_N rows (a cut: np.savez_compressed of the 1M rows and graph
# took 25-37 s each on the card's host)
ROUND_TRIP_N = 50_000
# The main path's build and queue size at 1M (benchmarks/
# torch_build_quality.py on the H100): the preset's NN-descent start
# reaches kNN recall 0.21 at 1M and caps search recall@10 at 0.75 even at
# L=160, while the exact kNN builder takes about 23 s on batch_dist tiles;
# the preset's L=64 was tuned at 50k and gives 0.76 over that graph, L=96
# gives 0.83.
MAIN_BUILDER, MAIN_L = "brute", 96
DEVICE = "cuda"
ANCHOR = dict(recall=0.957, iters=23)   # BENCH_traverse.json, W=4, ET on
# The share of a W=4 step's C=96 ids that are valid in the traversal at 1M:
# phase 4's dists/q over (lockstep iterations x C), 2,662.9 / (42.2 x 96)
# on the H100; the rest are -1 (visited, duplicate or padding)
TRAVERSAL_VALID = 0.66
# phase 9's overload pair: requests of 8 queries each run
OVERLOAD_REQUESTS = 2000
# phase 10: the ET search's queries (the rest are its holdout), the IVF
# tuner's SLO and the graph tuner's corpus, cut from 1M (PERF.md §4)
TUNE_Q, TUNE_SLO, N_TUNE_GRAPH = 1000, 0.90, 100_000
# phase 11, the RecSys family at full width (PERF.md §4): 20 AdamW steps
# a training run (steps 5-19 timed); training batches (the assigned
# train_batch, cut for bert4rec: its (B, 200, 10^6) logits take 6.4 GB a
# copy at B=8); the masked-loss run's batch and positions; the serving
# batches (serve_p99 and serve_bulk, bulk cut for bert4rec: its (B, 2,
# 200, 200) attention scores take about 84 GB at 262,144); the retrieval
# widths of the configs' candidate tables and the top-k
RECSYS_ARCHS = ("fm", "deepfm", "bst", "bert4rec")
TRAIN_STEPS, TRAIN_TIMED_FROM = 20, 5
TRAIN_B = dict(fm=65_536, deepfm=65_536, bst=65_536, bert4rec=8)
B4R_MASKED_B, B4R_MASKED_P = 32, 40
SERVE_P99, SERVE_BULK = 512, 262_144
SERVE_BULK_B = dict(fm=SERVE_BULK, deepfm=SERVE_BULK, bst=SERVE_BULK,
                    bert4rec=16_384)
RETRIEVAL_DIMS, RETRIEVAL_K = (10, 32, 64), 100
# bst's checkpoint test: the injected failure's step, the save cadence, and
# the tolerance against the uninterrupted run (a thirtieth of one AdamW
# step at lr 3e-4: the card's index backward may add in another order)
RESUME_FAIL_AT, RESUME_EVERY, RESUME_ATOL = 12, 5, 1e-5
# phase 11's ANN over bst's item table: its first rows (a cut from 10^6 to
# keep the smoke inside its limit: the 10^6 build took 248 s, 161 s of it
# the connectivity repair, and 500,000 rows 82 s)
RECSYS_ANN_N = 200_000
# phase 12, the LM and GNN families (PERF.md §4). Parity: the smoke configs
# on the card against the port on the host, f32, TF32 off, within the CPU
# tests' bounds (rtol 1e-5; atol a share of each output's or gradient
# leaf's largest magnitude) unless stated here. Full width, bf16: the
# layers one 80 GB card holds (the rest cut), the prefill length, decode's
# batch from a cache of decode_32k's 32,768 positions of which the last 32
# are generated, and the consistency check's lengths (prefill 192, then
# 64 decode steps, against a forward over 256). Training: 20 AdamW steps
# (steps 5-19 timed) of gemma-2b at full depth and llama4-scout at one
# layer, B=1; DimeNet 20 steps of the molecule and minibatch_lg shapes.
LM_ARCHS = ("qwen2_5_14b", "chatglm3_6b", "gemma_2b",
            "llama4_scout_17b_a16e", "kimi_k2_1t_a32b")
PARITY_OF_SCALE, PARITY_GRAD_OF_SCALE = 3e-6, 2e-5
LM_LAYERS = dict(llama4_scout_17b_a16e=12, kimi_k2_1t_a32b=1)
LM_PREFILL_S = dict(llama4_scout_17b_a16e=2048, kimi_k2_1t_a32b=2048)
PREFILL_S = 4096
LM_DECODE_B = dict(chatglm3_6b=8, gemma_2b=8, llama4_scout_17b_a16e=2)
DECODE_B, DECODE_MAX_LEN, DECODE_STEPS = 4, 32_768, 32
# decode steps under torch.profiler for the busy share (a cut: profiling
# 8 of qwen2.5-14b's steps took about 25 s)
BUSY_STEPS = 2
CONSIST_T, CONSIST_PREFILL = 256, 192
# prefill + decode against a forward, dense archs in bf16: on an H100 80GB
# HBM3 at 700 W this read 1.77e-2 (qwen2.5-14b), 1.64e-2 (chatglm3-6b) and
# 6.99e-3 (gemma-2b) of the logits' largest magnitude, so 5e-2; f32 parity
# is phase 12 (a)'s
CONSIST_BOUND = 5e-2
LM_TRAIN = (("gemma_2b", None, 4096), ("llama4_scout_17b_a16e", 1, 2048))
GNN_MOLECULE = (30, 64, 128, 32)         # atoms, edges, molecules, d_feat
GNN_MINIBATCH_NODES = 232_965            # minibatch_lg's graph
# minibatch_lg's 20 steps cycle over this many batches drawn ahead: a batch
# is 169,984 padded nodes x 602 features, about 3.3 s of the host's numpy
# draws whatever the graph's node count, so 20 live batches would take
# about 66 s (a cut of the stream, not of the shape)
GNN_MINIBATCH_BATCHES = 4
GNN_OF_SCALE = 2e-5      # card vs host forward: index_add order differs
FUSED_STEPS = ("fused_expand", "fused_expand_sq", "fused_expand_pq",
               "fused_expand_pq4", "fused_expand_bin")

REPORT: dict = {}
SMALL: dict = {}        # small_graph's one build

# Each kernel: its source (src/repro_torch/kernels/csrc/<source>.cu), the
# TPU kernel it replaces (or "none" and where the JAX package computes the
# same as plain jnp ops), and the path whose launches the kernels line
# counts (phase 4's main path, phase 5's or phase 6's quantized paths,
# phase 7's IVF paths)
KERNEL_SOURCES = {
    "gather_dist": ("gather_dist", "src/repro/kernels/gather_dist.py:49",
                    "main"),
    "fused_expand": ("traverse_step",
                     "src/repro/kernels/traverse_step.py:102", "main"),
    "batch_dist": ("batch_dist", "src/repro/kernels/batch_dist.py:45",
                   "main"),
    "sq_gather_dist": ("gather_dist", "src/repro/kernels/gather_dist.py:99",
                       "quant"),
    "fused_expand_sq": ("traverse_step",
                        "src/repro/kernels/traverse_step.py:160", "quant"),
    "pq_adc": ("pq_adc", "src/repro/kernels/pq_adc.py:36", "quant"),
    "fused_expand_pq": ("traverse_step",
                        "src/repro/kernels/traverse_step.py:222", "quant"),
    "fused_expand_pq4": ("traverse_step",
                         "src/repro/kernels/traverse_step.py:251", "pq4_bin"),
    "pq4_adc": ("pq4_scan", "src/repro/kernels/pq4_scan.py:62", "pq4_bin"),
    "bin_dist": ("bin_hamming", "src/repro/kernels/bin_hamming.py:55",
                 "pq4_bin"),
    "fused_expand_bin": ("traverse_step",
                         "src/repro/kernels/bin_hamming.py:99", "pq4_bin"),
    "pq4_ivf_scan": ("ivf_scan", "src/repro/kernels/pq4_scan.py:119", "ivf"),
    "bin_ivf_scan": ("bin_ivf_scan", "src/repro/kernels/bin_hamming.py:149",
                     "ivf"),
    "ivf_scan": ("ivf_scan", "src/repro/kernels/ivf_scan.py:62", "ivf"),
    "beam_filter": ("beam_filter", "none (src/repro/core/search.py, jnp)",
                    "main")}


T_START = time.perf_counter()


def log(*a):
    print(f"[{time.perf_counter() - T_START:7.1f}s]", *a, flush=True)


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
    REPORT["lint"] = phase_lint(_build.build_logs)
    return card


def ptxas_smem(log_text: str) -> "dict[str, int]":
    """Static shared bytes per entry function (mangled name) from the
    `-Xptxas -v` output of one source."""
    import re
    out, entry = {}, None
    for line in log_text.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            entry = m.group(1)
            out[entry] = 0
            continue
        if entry and "Used" in line and "registers" in line:
            m = re.search(r"(\d+) bytes smem", line)
            out[entry] = int(m.group(1)) if m else 0
            entry = None
    return out


def phase_lint(build_logs: dict) -> dict:
    """The port's lint on this checkout (raises on any violation), and
    smem_budget's static shared bytes of each kernel held against what
    ptxas reports for each of its instantiations: the estimate must not be
    lower, and every entry function must be a __global__ the lint knows."""
    from repro_torch.analysis import run_all, smem
    from repro_torch.analysis.common import Tree
    t0 = time.perf_counter()
    violations = run_all(ROOT)
    for v in violations:
        log(f"[lint] {v}")
    if violations:
        raise RuntimeError(f"repro_torch lint: {len(violations)} "
                           f"violation(s)")
    est = smem.estimate(Tree(ROOT))
    rows = []
    for source, text in sorted(build_logs.items()):
        for entry, ptx in sorted(ptxas_smem(text).items()):
            match = [k for k in est if k.source == source
                     and f"{len(k.name)}{k.name}" in entry]
            if len(match) != 1:
                raise RuntimeError(f"ptxas entry {entry} of {source}.cu "
                                   f"matches {len(match)} __global__ "
                                   f"functions of the smem check")
            k = match[0]
            rows.append(dict(source=source, kernel=k.name, entry=entry,
                             ptxas_smem=ptx, static_estimate=k.static_bytes))
            if k.static_bytes < ptx:
                raise RuntimeError(
                    f"smem_budget's static estimate of {k.name} "
                    f"({k.static_bytes} B) is below ptxas's {ptx} B "
                    f"({entry})")
    # per kernel: (ptxas's largest over its instantiations, the estimate)
    by_kernel = {}
    for r in rows:
        key = f"{r['source']}/{r['kernel']}"
        top = max(by_kernel.get(key, (0, 0))[0], r["ptxas_smem"])
        by_kernel[key] = (top, r["static_estimate"])
    log(f"[lint] 7 checks, 0 violations ({time.perf_counter() - t0:.1f} s); "
        f"static shared bytes, ptxas (max over {len(rows)} instantiations) "
        f"/ estimate: " + ", ".join(f"{key} {a}/{b}" for key, (a, b)
                                    in sorted(by_kernel.items())))
    return dict(violations=0, entries=len(rows),
                ptxas_smem={k: a for k, (a, _) in by_kernel.items()})


# --------------------------------------------------------------------------
# phase 2
# --------------------------------------------------------------------------
def separated_ids_equal(out, exp, width: float = ATOL):
    """(ok, slots): the sorted ids agree wherever a distance is apart from
    both neighbours by more than `width` (near-ties may swap)."""
    import torch
    sd = exp[0]
    gap_l = torch.ones_like(sd, dtype=torch.bool)
    gap_r = torch.ones_like(sd, dtype=torch.bool)
    dd = (sd[:, 1:] - sd[:, :-1]).abs()
    dd = torch.where(torch.isnan(dd), torch.zeros_like(dd), dd)
    gap_l[:, 1:] = dd > width
    gap_r[:, :-1] = dd > width
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
    exact: bool = False  # every output must equal the plain version's
    scan: bool = False   # an IVF list scan: returns (dists, ids) (Q, P, L)


def pq_bytes(codes, ids, nibbles: bool = False) -> int:
    """Bytes of the (Q, m, K) f32 tables and the (n, m) u8 codes (with
    `nibbles`, (n, m/2) bytes of two codes each) that a PQ ADC over `ids`
    must read: per query and subspace, the distinct 32-byte sectors of its
    table that the valid ids' codes hit, and per valid id the sectors of
    its code row."""
    import torch
    valid = ids >= 0
    c = codes[ids.clamp(min=0).long()].long()
    if nibbles:                       # byte j: subspace 2j low, 2j+1 high
        c = torch.stack([c & 15, c >> 4], dim=-1).flatten(-2)
    sec = c * 4 // SECTOR                                         # (Q, B, m)
    sec = torch.where(valid[..., None], sec, torch.full_like(sec, -1))
    sec = sec.sort(dim=1).values
    first = torch.ones_like(sec, dtype=torch.bool)
    first[:, 1:] = sec[:, 1:] != sec[:, :-1]
    tables = int((first & (sec >= 0)).sum()) * SECTOR
    return tables + row_bytes(ids, codes.shape[1])


def row_bytes(ids, width: int) -> int:
    """Bytes of the 32-byte sectors that the rows of `width` bytes of the
    valid ids span (a 12-byte bin row spans two where it straddles a
    sector boundary)."""
    i = ids[ids >= 0].long()
    first = i * width // SECTOR
    last = ((i + 1) * width - 1) // SECTOR
    return int((last - first + 1).sum()) * SECTOR


def offset_view(codes):
    """`codes` copied to a view one element into a flat buffer (one byte
    for u8 codes, 4 bytes for f32 rows): its rows are not aligned, so the
    kernels read them a byte (a float) at a time."""
    import torch
    flat = torch.empty(codes.numel() + 1, dtype=codes.dtype,
                       device=codes.device)
    flat[1:] = codes.reshape(-1)
    return flat[1:].view(codes.shape)


def u8_tables(lut):
    """(Q, m, 16) tables requantized to u8 steps per query, as the
    pq4+u8lut kind serves them (quantize.pq4_requant_lut)."""
    from repro_torch.core.quantize import pq4_requant_lut
    return pq4_requant_lut(lut.reshape(lut.shape[0], -1)).reshape(lut.shape)


def kernel_inputs(db) -> dict:
    """Phase 2's operands over the (n, d) f32 rows `db`: Q=1000 unit
    queries, SQ codes of the n rows with per-dimension scale and zero, PQ8
    codes with m=16 subspaces of K=256 centroids, PQ4 codes (m=16, two a
    byte), the queries' and rows' 96 sign bits (three int32 words each),
    and the generator that draws the ids and tables of kernel_cases."""
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
    p4codes = torch.randint(0, 256, (n, m // 2), generator=g, device=dev,
                            dtype=torch.int32).to(torch.uint8)
    nw = -(-d // 32)
    words = torch.randint(-2 ** 31, 2 ** 31, (n + Q, nw), generator=g,
                          device=dev, dtype=torch.int64).to(torch.int32)
    # IVF lists: 1,000 lists of max_len = 2,176 slots (17 * 128, the
    # padding of a longest list of 2,100), ragged lengths in [0, 2,100],
    # two lists all padding, 2% holes; codes per slot for PQ8 (m=16), PQ4
    # (m=32, 16 bytes) and bin (three words)
    nlist, max_len = 1000, 2176
    lens = torch.randint(0, 2101, (nlist,), generator=g, device=dev)
    lens[:2] = 0
    slot = torch.arange(max_len, device=dev)[None]
    lids = torch.randint(0, n, (nlist, max_len), generator=g, device=dev,
                         dtype=torch.int32)
    hole = torch.rand((nlist, max_len), generator=g, device=dev) < 0.02
    lids = torch.where((slot < lens[:, None]) & ~hole, lids,
                       torch.full_like(lids, -1))
    lists = dict(ids=lids, pq=torch.randint(
        0, 256, (nlist, max_len, 16), generator=g, device=dev,
        dtype=torch.int32).to(torch.uint8), pq4=torch.randint(
        0, 256, (nlist, max_len, 16), generator=g, device=dev,
        dtype=torch.int32).to(torch.uint8), bin=torch.randint(
        -2 ** 31, 2 ** 31, (nlist, max_len, nw), generator=g, device=dev,
        dtype=torch.int64).to(torch.int32))
    # tie storms: every slot of a list holds that list's first code
    for kind in ("pq", "bin"):
        lists[f"{kind}_storm"] = lists[kind][:, :1].expand(
            -1, max_len, -1).contiguous()
    return dict(db=db, q=q, codes=codes, scale=scale, zero=zero,
                pcodes=pcodes, K=K, g=g, p4codes=p4codes, signs=words[:n],
                qsigns=words[n:].contiguous(), lists=lists)


def table_sectors(lists, codes, K, probes, per_probe) -> int:
    """Bytes of the 32-byte table sectors a list scan must read: per
    (query, probe) with a table per probe, per query over the union of its
    probed lists otherwise, the sectors of each subspace's row of K f32
    entries that the lists' valid codes hit (PQ4 codes unpacked)."""
    import torch
    ids = lists["ids"]
    nlist = ids.shape[0]
    c = codes.long()
    if K == 16:                       # byte j: subspace 2j low, 2j+1 high
        c = torch.stack([c & 15, c >> 4], dim=-1).flatten(-2)
    m, nsec = c.shape[-1], K * 4 // SECTOR
    mask = torch.zeros((nlist, m, nsec), dtype=torch.bool, device=ids.device)
    li, _ = torch.nonzero(ids >= 0, as_tuple=True)
    cv = c[ids >= 0]                                        # (valid, m)
    j = torch.arange(m, device=ids.device)[None]
    mask.view(-1)[((li[:, None] * m + j) * nsec + cv * 4 // SECTOR)
                  .flatten()] = True
    hit = mask[probes.long()]                               # (Q, P, m, nsec)
    if not per_probe:
        hit = hit.any(dim=1)
    return int(hit.sum()) * SECTOR


def scan_bytes(lists, codes, probes, L, lead_bytes) -> int:
    """The list scans' bytes besides tables: each distinct probed list's
    ids (all slots: the kernel reads them to find the valid ones) and
    code rows of its valid slots once per call, the probes, the query
    words or bias-free lead operand, and the (Q, P, L) outputs."""
    import torch
    ids = lists["ids"]
    used = torch.unique(probes.long())
    width = codes.shape[-1] * codes.element_size()
    valid = int((ids[used] >= 0).sum())
    Q, P = probes.shape
    return (len(used) * ids.shape[1] * 4 + valid * width + Q * P * 4
            + lead_bytes + Q * P * L * 8)


def kernel_cases(inp: dict) -> "list[Case]":
    """Every kernel at the shapes the served paths give it: the gathers at
    seeds (M=8) and W=1 steps (M=24), the fused steps at the W=4 step
    (C=96, L=MAIN_L; fused_expand also at the bigann preset's C=128,
    L=192, fused_expand_bin also at the bin preset's L=320), both metrics
    where a kernel takes one, and batch_dist over the whole db. Ids are
    random rows with 5% set to -1 (34% for a second ip case of
    fused_expand and fused_expand_sq at C=96: the traversal's share,
    TRAVERSAL_VALID); the fused steps' ids repeat rows across
    expansions, so exact ties occur (and Hamming distances of random signs
    tie everywhere). The gathers also run at M=24 on their general paths,
    and gather_dist at the re-rank depths M=40 and M=640; fused_expand_pq,
    bin_dist, fused_expand_pq4 and fused_expand_bin on their other paths
    (drawn last, in that order). The bin kernels, the
    PQ and PQ4 gathers and fused steps (which sum as their plain versions
    do) and the list scans must equal their plain versions. Each case
    holds enough argument sets that they gather twice the card's L2 in
    all. The kernels are called through `ops`, so any checkout's can be
    timed."""
    import torch
    from repro_torch.kernels import ops, ref
    db, q, codes, scale, zero, pcodes, K, g = (
        inp[k] for k in ("db", "q", "codes", "scale", "zero", "pcodes", "K",
                         "g"))
    p4codes, signs, qsigns = inp["p4codes"], inp["signs"], inp["qsigns"]
    dev, (n, d), (Q, m) = db.device, db.shape, (q.shape[0], pcodes.shape[1])
    nw = signs.shape[1]
    cases = []

    def rand_ids(M, invalid=0.05):
        ids = torch.randint(0, n, (Q, M), generator=g, device=dev,
                            dtype=torch.int32)
        drop = torch.rand((Q, M), generator=g, device=dev) < invalid
        return torch.where(drop, torch.full_like(ids, -1), ids)

    def tied_ids(W, M, invalid=0.05):
        """C = W*M ids where expansions 1..W-1 repeat ids of expansion 0
        in some slots (bit-identical distances, so exact ties)."""
        ids = rand_ids(W * M, invalid)
        for w in range(1, W):
            ids[:, w * M] = ids[:, 0]
            ids[:, w * M + 3] = ids[:, w]
        return ids

    def lut(k=K, mm=m):
        return torch.randn((Q, mm, k), generator=g, device=dev)

    def valid(ids):
        return int((ids >= 0).sum())

    def add(name, shape, main, fused, kern, plain, cost, draw, exact=False,
            scan=False):
        first = draw()
        k = min(256, max(1, -(-2 * L2_BYTES // cost(*first)[0])))
        cases.append(Case(name, shape, main, fused, kern, plain, cost,
                          [first] + [draw() for _ in range(k - 1)], exact,
                          scan))

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
            lambda M=M: (lut(), rand_ids(M)), exact=True)
        add("pq4_adc", f"Q={Q} B={M} m={m} K=16 n={n}", M == 24, False,
            lambda t, ids: ops.pq4_adc(t, p4codes, ids),
            lambda t, ids: ref.pq4_adc_ref(t, p4codes, ids),
            lambda t, ids, M=M: (pq_bytes(p4codes, ids, nibbles=True)
                                 + Q * M * 8, float(valid(ids) * m)),
            lambda M=M: (lut(16), rand_ids(M)), exact=True)
        # bin: the valid rows' sectors, the queries' words, ids, outputs;
        # an XOR, a popcount and an add a word
        add("bin_dist", f"Q={Q} B={M} nw={nw} n={n}", M == 24, False,
            lambda ids: ops.bin_dist(qsigns, signs, ids),
            lambda ids: ref.bin_dist_ref(qsigns, signs, ids),
            lambda ids, M=M: (row_bytes(ids, nw * 4) + Q * nw * 4
                              + Q * M * 8, 3.0 * valid(ids) * nw),
            lambda M=M: (rand_ids(M),), exact=True)

    # ---- the PQ gathers' general paths at M=24, held exactly: code rows
    # at a 1-byte offset into a flat buffer (the byte path), PQ8 at m=12
    # over K=64 tables, PQ4 over u8-requantized tables (the pq4+u8lut
    # kind's, where many sums tie exactly) ----
    M = 24
    codes12 = torch.randint(0, 64, (n, 12), generator=g, device=dev,
                            dtype=torch.int32).to(torch.uint8)
    for note, cds, k, mm in ((" codes at offset 1", offset_view(pcodes), K, m),
                             ("", codes12, 64, 12)):
        add("pq_adc", f"Q={Q} B={M} m={mm} K={k} n={n}{note}", False, False,
            lambda t, ids, c=cds: ops.pq_adc(t, c, ids),
            lambda t, ids, c=cds: ref.pq_adc_ref(t, c, ids),
            lambda t, ids, c=cds: (pq_bytes(c, ids) + Q * M * 8,
                                   float(valid(ids) * c.shape[1])),
            lambda k=k, mm=mm: (lut(k, mm), rand_ids(M)), exact=True)
    for note, cds, u8 in ((" codes at offset 1", offset_view(p4codes), False),
                          (" u8 tables", p4codes, True)):
        add("pq4_adc", f"Q={Q} B={M} m={m} K=16 n={n}{note}", False, False,
            lambda t, ids, c=cds: ops.pq4_adc(t, c, ids),
            lambda t, ids, c=cds: ref.pq4_adc_ref(t, c, ids),
            lambda t, ids, c=cds: (pq_bytes(c, ids, nibbles=True)
                                   + Q * M * 8, float(valid(ids) * m)),
            lambda u8=u8: (u8_tables(lut(16)) if u8 else lut(16),
                           rand_ids(M)), exact=True)

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
            # the main step again at the share of valid ids the traversal
            # gives it (TRAVERSAL_VALID), ip: a logged case of its own
            shape = (f"Q={Q} W={W} M={M} L={L} d={d} n={n} ip valid "
                     f"{TRAVERSAL_VALID:.0%}")
            add("fused_expand", shape, False, True,
                lambda ids, L=L, W=W: ops.fused_expand(
                    q, db, ids, metric="ip", L=L, n_beam=W),
                lambda ids, L=L, W=W: ref.fused_expand_ref(
                    q, db, ids, "ip", L, W),
                lambda ids, io=io: (valid(ids) * d * 4 + Q * d * 4 + io,
                                    3.0 * valid(ids) * d),
                lambda W=W, M=M: (tied_ids(W, M, 1 - TRAVERSAL_VALID),))
            add("fused_expand_sq", shape, False, True,
                lambda ids, L=L, W=W: ops.fused_expand_sq(
                    q, codes, scale, zero, ids, metric="ip", L=L, n_beam=W),
                lambda ids, L=L, W=W: ref.fused_expand_sq_ref(
                    q, codes, scale, zero, ids, "ip", L, W),
                lambda ids, io=io: (valid(ids) * d + Q * d * 4 + d * 8 + io,
                                    4.0 * valid(ids) * d),
                lambda W=W, M=M: (tied_ids(W, M, 1 - TRAVERSAL_VALID),))
        if C == 96:
            add("fused_expand_pq", f"Q={Q} W={W} M={M} L={L} m={m} K={K} "
                f"n={n}", True, True,
                lambda t, ids, L=L, W=W: ops.fused_expand_pq(
                    t, pcodes, ids, L=L, n_beam=W),
                lambda t, ids, L=L, W=W: ref.fused_expand_pq_ref(
                    t, pcodes, ids, L, W),
                lambda t, ids, io=io: (pq_bytes(pcodes, ids) + io,
                                       float(valid(ids) * m)),
                lambda W=W, M=M: (lut(), tied_ids(W, M)), exact=True)
            add("fused_expand_pq4", f"Q={Q} W={W} M={M} L={L} m={m} K=16 "
                f"n={n}", True, True,
                lambda t, ids, L=L, W=W: ops.fused_expand_pq4(
                    t, p4codes, ids, L=L, n_beam=W),
                lambda t, ids, L=L, W=W: ref.fused_expand_pq4_ref(
                    t, p4codes, ids, L, W),
                lambda t, ids, io=io: (pq_bytes(p4codes, ids, nibbles=True)
                                       + io, float(valid(ids) * m)),
                lambda W=W, M=M: (lut(16), tied_ids(W, M)), exact=True)
            # the bin preset's queue is L=320 (T = C = 96 all the same)
            for Lb in (L, 320):
                add("fused_expand_bin", f"Q={Q} W={W} M={M} L={Lb} nw={nw} "
                    f"n={n}", Lb == 320, True,
                    lambda ids, Lb=Lb, W=W: ops.fused_expand_bin(
                        qsigns, signs, ids, L=Lb, n_beam=W),
                    lambda ids, Lb=Lb, W=W: ref.fused_expand_bin_ref(
                        qsigns, signs, ids, Lb, W),
                    lambda ids, io=io: (row_bytes(ids, nw * 4) + Q * nw * 4
                                        + io, 3.0 * valid(ids) * nw),
                    lambda W=W, M=M: (tied_ids(W, M),), exact=True)

    # ---- the IVF list scans at the Deep1M presets' shapes, tables per
    # probe (random) and per query (the ip presets' case, in the kernels
    # line); ivf_scan also at 4x the ivf_pq preset's nprobe, on a tie storm
    # and at L = max_len; every scan output equal to the plain version's
    lists = inp["lists"]
    nlist, max_len = lists["ids"].shape

    def probes(P):
        return torch.argsort(torch.rand((Q, nlist), generator=g, device=dev),
                             dim=1)[:, :P].to(torch.int32).contiguous()

    for name, P, L, m_, K_, codes_, note in (
            ("ivf_scan", 24, 128, 16, 256, "pq", ""),
            ("ivf_scan", 96, 128, 16, 256, "pq", ""),
            ("ivf_scan", 24, 128, 16, 256, "pq_storm", " tie storm"),
            ("ivf_scan", 8, max_len, 16, 256, "pq", ""),
            ("pq4_ivf_scan", 32, 192, 32, 16, "pq4", "")):
        lc = lists[codes_]
        fn = ops.ivf_scan if K_ == 256 else ops.pq4_ivf_scan
        plain = ref.ivf_scan_ref if K_ == 256 else ref.pq4_ivf_scan_ref
        served = P in (24, 32) and not note      # the presets' shapes
        for Pl in ((P, 1) if served else (1,)):
            add(name, f"Q={Q} P={P} Pl={Pl} L={L} m={m_} K={K_} nlist={nlist}"
                f" max_len={max_len}{note}", Pl == 1 and served, False,
                lambda t, pr, fn=fn, L=L, lc=lc: fn(t, lc, lists["ids"], pr,
                                                    L=L),
                lambda t, pr, plain=plain, L=L, lc=lc: plain(
                    t, lc, lists["ids"], pr, L),
                lambda t, pr, L=L, lc=lc, K_=K_, Pl=Pl: (
                    table_sectors(lists, lc, K_, pr, Pl > 1)
                    + scan_bytes(lists, lc, pr, L, 0),
                    float(int((lists["ids"][pr.long()] >= 0).sum()) * m_)),
                lambda P=P, Pl=Pl, m_=m_, K_=K_: (
                    torch.randn((Q, Pl, m_, K_), generator=g, device=dev),
                    probes(P)), exact=True, scan=True)
    # the bin scan at the ivf_bin preset's shape (in the kernels line), on
    # a tie storm (every distance of a list equal), and at L = max_len
    for P, L, words, note in ((96, 768, "bin", ""),
                              (96, 768, "bin_storm", " tie storm"),
                              (8, max_len, "bin", "")):
        add("bin_ivf_scan", f"Q={Q} P={P} L={L} nw={nw} nlist={nlist} "
            f"max_len={max_len}{note}", not note and L == 768, False,
            lambda pr, L=L, w=words: ops.bin_ivf_scan(
                qsigns, lists[w], lists["ids"], pr, L=L),
            lambda pr, L=L, w=words: ref.bin_ivf_scan_ref(
                qsigns, lists[w], lists["ids"], pr, L),
            lambda pr, L=L, w=words: (
                scan_bytes(lists, lists[w], pr, L, Q * nw * 4),
                3.0 * nw * int((lists["ids"][pr.long()] >= 0).sum())),
            lambda P=P: (probes(P),), exact=True, scan=True)

    # ---- batch_dist: Q x n x d, both metrics; a 4 GB output a call ----
    def dist_cost(qq, xx):
        (nq, dd), nb = qq.shape, xx.shape[0]
        return (nq * dd + nb * dd + nq * nb) * 4, 2.0 * nq * nb * dd

    for mt in ("ip", "l2"):
        add("batch_dist", f"Q={Q} B={n} d={d} {mt}", mt == "ip", False,
            lambda qq, xx, mt=mt: ops.batch_dist(qq, xx, metric=mt),
            lambda qq, xx, mt=mt: ref.batch_dist_ref(qq, xx, mt),
            dist_cost, lambda: (q, db))
    # ---- and at the RecSys retrieval shapes (phase 11): one query or a
    # serving batch of 512 against 10^6 candidate rows of the configs'
    # widths (d=10: fm and deepfm, rows not 16-byte aligned; 32: bst; 64:
    # bert4rec), ip; fresh tables a set, so the rows come from HBM; their
    # own generator, so the cases below keep their inputs ----
    gr = torch.Generator(device=dev).manual_seed(11)
    for dd in RETRIEVAL_DIMS:
        for nq in (1, SERVE_P99):
            add("batch_dist", f"Q={nq} B={n} d={dd} ip (retrieval)", False,
                False,
                lambda qq, xx: ops.batch_dist(qq, xx, metric="ip"),
                lambda qq, xx: ref.batch_dist_ref(qq, xx, "ip"),
                dist_cost,
                lambda nq=nq, dd=dd: (
                    torch.randn((nq, dd), generator=gr, device=dev),
                    0.02 * torch.randn((n, dd), generator=gr, device=dev)))

    # ---- the gathers where else they run (drawn last, so the cases above
    # keep their inputs): gather_dist at the exact re-rank depths M=40
    # (the quantized kinds' default) and M=640 (bin at L=640), on rows at
    # a 4-byte offset (float units) and at d=100 (float4 in one pass of
    # 32 units); sq_gather_dist on codes at a 1-byte offset (byte units).
    # Bytes as the gathers' above ----
    db100 = torch.nn.functional.normalize(
        torch.randn((n, 100), generator=g, device=dev), dim=1)
    q100 = torch.nn.functional.normalize(
        torch.randn((Q, 100), generator=g, device=dev), dim=1)
    for M, rows, qq, note in ((40, db, q, ""), (640, db, q, ""),
                              (24, offset_view(db), q, " rows at offset 4"),
                              (24, db100, q100, "")):
        dd = rows.shape[1]
        io = Q * M * 8 + Q * dd * 4
        add("gather_dist", f"Q={Q} M={M} d={dd} n={n} ip{note}", False,
            False,
            lambda ids, r=rows, qq=qq: ops.gather_dist(qq, r, ids,
                                                       metric="ip"),
            lambda ids, r=rows, qq=qq: ref.gather_dist_ref(qq, r, ids, "ip"),
            lambda ids, io=io, dd=dd: (valid(ids) * dd * 4 + io,
                                       3.0 * valid(ids) * dd),
            lambda M=M: (rand_ids(M),))
    M, codes1 = 24, offset_view(codes)
    add("sq_gather_dist", f"Q={Q} M={M} d={d} n={n} ip codes at offset 1",
        False, False,
        lambda ids: ops.sq_gather_dist(q, codes1, scale, zero, ids,
                                       metric="ip"),
        lambda ids: ref.sq_gather_dist_ref(q, codes1, scale, zero, ids, "ip"),
        lambda ids: (valid(ids) * d + Q * M * 8 + Q * d * 4 + d * 8,
                     4.0 * valid(ids) * d),
        lambda: (rand_ids(M),))

    # ---- the PQ step's other paths, held exactly: code rows at a 1-byte
    # offset (byte loads), m=12 over K=64 (a 3 KB table), m=32 (a 32 KB
    # table), C=128 (the largest sort in registers), C=192 (W=8: the sort
    # in shared memory), the traversal's share of valid ids, tables at a
    # 4-byte offset. Bytes as the main PQ step's ----
    codes32 = torch.randint(0, K, (n, 32), generator=g, device=dev,
                            dtype=torch.int32).to(torch.uint8)
    for note, cds, k, W, M, L, invalid, off in (
            (" codes at offset 1", offset_view(pcodes), K, 4, 24, MAIN_L,
             0.05, False),
            ("", codes12, 64, 4, 24, MAIN_L, 0.05, False),
            ("", codes32, K, 4, 24, MAIN_L, 0.05, False),
            ("", pcodes, K, 4, 32, 192, 0.05, False),
            ("", pcodes, K, 8, 24, MAIN_L, 0.05, False),
            (f" valid {TRAVERSAL_VALID:.0%}", pcodes, K, 4, 24, MAIN_L,
             1 - TRAVERSAL_VALID, False),
            (" tables at offset 4", pcodes, K, 4, 24, MAIN_L, 0.05, True)):
        C, T, mm = W * M, min(L, W * M), cds.shape[1]
        io = Q * C * 4 + Q * T * 8 + Q * W * 8
        add("fused_expand_pq", f"Q={Q} W={W} M={M} L={L} m={mm} K={k} "
            f"n={n}{note}", False, True,
            lambda t, ids, c=cds, L=L, W=W: ops.fused_expand_pq(
                t, c, ids, L=L, n_beam=W),
            lambda t, ids, c=cds, L=L, W=W: ref.fused_expand_pq_ref(
                t, c, ids, L, W),
            lambda t, ids, c=cds, io=io: (pq_bytes(c, ids) + io,
                                          float(valid(ids) * c.shape[1])),
            lambda k=k, mm=mm, W=W, M=M, invalid=invalid, off=off: (
                offset_view(lut(k, mm)) if off else lut(k, mm),
                tied_ids(W, M, invalid)), exact=True)

    # ---- bin_dist's other shapes, held exactly: nw = 4 and 7 (d = 128,
    # 200), B = 1 and 33, query 0's ids all -1 and query 1's one id
    # repeated. Bytes as bin_dist's above ----
    def marked_ids(M):
        ids = rand_ids(M)
        ids[0] = -1
        ids[1] = ids[1, 0].clone()
        return ids

    for words, M in ((nw, 1), (nw, 33), (4, 24), (7, 24)):
        cw, qw = signs, qsigns
        if words != nw:
            cw, qw = (torch.randint(-2 ** 31, 2 ** 31, (k, words), generator=g,
                                    device=dev, dtype=torch.int64)
                      .to(torch.int32) for k in (n, Q))
        add("bin_dist", f"Q={Q} B={M} nw={words} n={n} query 0 all -1, "
            f"query 1 one id", False, False,
            lambda ids, cw=cw, qw=qw: ops.bin_dist(qw, cw, ids),
            lambda ids, cw=cw, qw=qw: ref.bin_dist_ref(qw, cw, ids),
            lambda ids, M=M, words=words: (
                row_bytes(ids, words * 4) + Q * words * 4 + Q * M * 8,
                3.0 * valid(ids) * words),
            lambda M=M: (marked_ids(M),), exact=True)

    # ---- the PQ4 and bin steps' other paths, held exactly: PQ4 code rows
    # at a 1-byte offset (byte loads), m=32 (the ivf_pq4 preset's m) and
    # u8-requantized tables (the pq4+u8lut kind's exact ties); bin at nw = 4
    # and 7 (d = 128, 200); both at C=128 (the largest sort in registers),
    # C=192 (W=8: the block path), the traversal's share of valid ids and
    # with expansion 1's ids all -1 (its best +inf, expansion 0's +inf
    # entries its ties). Bytes as the main steps' ----
    def step_ids(W, M, invalid, blank):
        ids = tied_ids(W, M, invalid)
        if blank:
            ids[:, M:2 * M] = -1
        return ids

    p4codes32 = torch.randint(0, 256, (n, 16), generator=g, device=dev,
                              dtype=torch.int32).to(torch.uint8)
    words = {nw: (signs, qsigns)}
    for k in (4, 7):
        words[k] = tuple(torch.randint(-2 ** 31, 2 ** 31, (r, k), generator=g,
                                       device=dev, dtype=torch.int64)
                         .to(torch.int32) for r in (n, Q))
    blank, valid66 = " expansion 1 all -1", f" valid {TRAVERSAL_VALID:.0%}"
    shapes = ((4, 32, 192, 0.05, ""), (8, 24, MAIN_L, 0.05, ""),
              (4, 24, MAIN_L, 1 - TRAVERSAL_VALID, valid66),
              (4, 24, MAIN_L, 0.05, blank))
    for note, cds, u8, W, M, L, invalid in (
            (" codes at offset 1", offset_view(p4codes), False, 4, 24,
             MAIN_L, 0.05),
            ("", p4codes32, False, 4, 24, MAIN_L, 0.05),
            (" u8 tables", p4codes, True, 4, 24, MAIN_L, 0.05),
            *((nt, p4codes, False, W_, M_, L_, inv)
              for W_, M_, L_, inv, nt in shapes)):
        C, T, mm = W * M, min(L, W * M), 2 * cds.shape[1]
        io = Q * C * 4 + Q * T * 8 + Q * W * 8
        add("fused_expand_pq4", f"Q={Q} W={W} M={M} L={L} m={mm} K=16 "
            f"n={n}{note}", False, True,
            lambda t, ids, c=cds, L=L, W=W: ops.fused_expand_pq4(
                t, c, ids, L=L, n_beam=W),
            lambda t, ids, c=cds, L=L, W=W: ref.fused_expand_pq4_ref(
                t, c, ids, L, W),
            lambda t, ids, c=cds, io=io, mm=mm: (
                pq_bytes(c, ids, nibbles=True) + io, float(valid(ids) * mm)),
            lambda mm=mm, u8=u8, W=W, M=M, invalid=invalid, note=note: (
                u8_tables(lut(16, mm)) if u8 else lut(16, mm),
                step_ids(W, M, invalid, note == blank)), exact=True)
    for k, W, M, L, invalid, note in (
            (4, 4, 24, 320, 0.05, ""), (7, 4, 24, 320, 0.05, ""),
            *((nw, W_, M_, 320, inv, nt) for W_, M_, _, inv, nt in shapes)):
        cw, qw = words[k]
        C, T = W * M, min(L, W * M)
        io = Q * C * 4 + Q * T * 8 + Q * W * 8
        add("fused_expand_bin", f"Q={Q} W={W} M={M} L={L} nw={k} "
            f"n={n}{note}", False, True,
            lambda ids, cw=cw, qw=qw, L=L, W=W: ops.fused_expand_bin(
                qw, cw, ids, L=L, n_beam=W),
            lambda ids, cw=cw, qw=qw, L=L, W=W: ref.fused_expand_bin_ref(
                qw, cw, ids, L, W),
            lambda ids, io=io, k=k: (row_bytes(ids, k * 4) + Q * k * 4 + io,
                                     3.0 * valid(ids) * k),
            lambda W=W, M=M, invalid=invalid, note=note: (
                step_ids(W, M, invalid, note == blank),), exact=True)

    # ---- beam_filter, the traversal's candidate filter (no TPU kernel),
    # every output equal to the plain version's: at the graph cell's shape
    # (Q = Q_MAIN, W=4, M=24, L=320, queue mode; the kernels line), at the
    # build's search pass (W=1 over M=30 ids, L=48: a warp a row), over a
    # queue longer than one shared-memory tile (L=1,500) and in bitmap mode
    # over 100,000 rows with a quarter of the bits set beforehand. A banded
    # graph (neighbours within 64 rows), expanded nodes within 8 rows of one
    # another and queue ids within 256 rows, so ids repeat within and across
    # expansions and many are queued; 5% of the lanes do not expand, 5% of
    # the adjacency and 20% of the queue slots are -1. Its own generator, so
    # the cases above keep their inputs. Bytes: the expanded ids, their
    # rows' sectors, the queue, the outputs and in bitmap mode a word read
    # and written a gathered id; operations: the id compares ----
    gf = torch.Generator(device=dev).manual_seed(7)

    def banded(nn, M):
        g_ = (torch.arange(nn, device=dev)[:, None] + torch.randint(
            -64, 65, (nn, M), generator=gf, device=dev)) % nn
        g_[torch.rand((nn, M), generator=gf, device=dev) < 0.05] = -1
        return g_.to(torch.int32)

    def expansion(Qf, W, L, nn):
        base = torch.randint(0, nn, (Qf, 1), generator=gf, device=dev)
        v = (base + torch.randint(-8, 9, (Qf, W), generator=gf,
                                  device=dev)) % nn
        v[torch.rand((Qf, W), generator=gf, device=dev) < 0.05] = -1
        qids = (base + torch.randint(-256, 257, (Qf, L), generator=gf,
                                     device=dev)) % nn
        qids[torch.rand((Qf, L), generator=gf, device=dev) < 0.2] = -1
        return v.to(torch.int32), qids.to(torch.int32)

    def filtered(fn, gr, bm0):
        """fn's outputs as one tensor: flat, n_new and the bitmap after
        the call (a copy of bm0, as int32 pairs)."""
        def run(v, qids):
            bm = None if bm0 is None else bm0.clone()
            flat, n_new = fn(v, gr, qids, bm)
            return torch.cat([flat, n_new[:, None]]
                             + ([] if bm is None else [bm.view(torch.int32)]),
                             dim=1)
        return run

    for Qf, W, M, L, nn, mode in ((Q_MAIN, 4, 24, 320, n, "queue"),
                                  (Q_MAIN, 1, 30, 48, n, "queue"),
                                  (Q, 4, 24, 1500, n, "queue"),
                                  (Q, 4, 24, 320, 100_000, "bitmap")):
        gr, C = banded(nn, M), W * M
        bm0 = None
        if mode == "bitmap":
            bm0 = torch.randint(0, 2 ** 32, (Qf, (nn + 31) // 32),
                                generator=gf, device=dev, dtype=torch.int64)
            bm0 &= torch.randint(0, 2 ** 32, bm0.shape, generator=gf,
                                 device=dev, dtype=torch.int64)
        add("beam_filter", f"Q={Qf} W={W} M={M} L={L} n={nn} {mode}",
            (W, L, mode) == (4, 320, "queue"), False,
            filtered(ops.beam_filter, gr, bm0),
            filtered(ref.beam_filter_ref, gr, bm0),
            lambda v, qids, gr=gr, C=C, L=L, bm=bm0 is not None: (
                row_bytes(v, gr.shape[1] * 4) + v.numel() * 4
                + qids.numel() * 4 + v.shape[0] * (C + 1) * 4
                + (16 * int((gr[v.clamp(min=0).long()] >= 0)[v >= 0].sum())
                   if bm else 0),
                float(v.shape[0] * (C * (C - 1) / 2 + C * L))),
            lambda Qf=Qf, W=W, L=L, nn=nn: expansion(Qf, W, L, nn),
            exact=True)
    return cases


def chain_split(inp: dict, cases: dict) -> dict:
    """What the gathers' and the fused steps' fixed costs are made of, by
    phase 2's device clock (`graph_ms`), at Q=1000 over sets of ids that
    fill twice the L2 by themselves, so every call's ids come from device
    memory: the launch floor, a one-element `Tensor.zero_()` (a yardstick
    only); `bin_dist` and `gather_dist` (ip) at B=24 with every id -1
    (the launch, the id trip and the store; no row is read) and with 5% -1
    (the row trip added); the five fused steps at W=4, C=96 with every id
    -1 (the launch, the id trip, the id-independent loads, the sort and
    the outputs: what no scorer can cut); and `fused_expand_pq` on its
    main case's ids with one set of tables for every call, which the L2
    then holds, as it likely does across a traversal's iterations. The
    main `cases` (by name) give the operands."""
    import torch
    from repro_torch.kernels import ops
    q, db, signs, qsigns, g = (inp[k] for k in ("q", "db", "signs", "qsigns",
                                                "g"))
    Q, n, dev = q.shape[0], db.shape[0], q.device

    def id_sets(B, invalid):
        k = -(-2 * L2_BYTES // (Q * B * 4))
        ids = torch.randint(0, n, (k, Q, B), generator=g, device=dev,
                            dtype=torch.int32)
        ids[torch.rand((k, Q, B), generator=g, device=dev) < invalid] = -1
        return ids

    one = torch.zeros(1, device=dev)
    split = dict(launch_floor_ms=graph_ms(lambda: one.zero_(), [()]))
    none, some = id_sets(24, 1.0), id_sets(24, 0.05)
    for name, fn in (("bin_dist", lambda ids: ops.bin_dist(qsigns, signs,
                                                           ids)),
                     ("gather_dist", lambda ids: ops.gather_dist(
                         q, db, ids, metric="ip"))):
        split[f"{name}_invalid_ms"] = graph_ms(fn, [(i,) for i in none])
        split[f"{name}_ms"] = graph_ms(fn, [(i,) for i in some])
    none = id_sets(96, 1.0)
    for name in FUSED_STEPS:
        c = cases[name]
        lead = [a[:-1] for a in c.sets]         # the tables, if any
        split[f"{name}_invalid_ms"] = graph_ms(c.kern, [
            (*lead[i % len(lead)], ids) for i, ids in enumerate(none)])
    pq = cases["fused_expand_pq"]
    split["fused_expand_pq_l2_tables_ms"] = graph_ms(
        pq.kern, [(pq.sets[0][0], ids) for _, ids in pq.sets])
    log(f"[chain] Q={Q}, ids from device memory, device ms: launch floor "
        f"(a one-element zero_) {split['launch_floor_ms']:.4f}; "
        + "; ".join(f"{name} B=24 every id -1 "
                    f"{split[name + '_invalid_ms']:.4f}, 5% -1 "
                    f"{split[name + '_ms']:.4f}" for name in ("bin_dist",
                                                            "gather_dist")))
    log("[chain] fused steps W=4 C=96, every id -1, device ms: " + ", ".join(
        f"{name} {split[name + '_invalid_ms']:.4f}" for name in FUSED_STEPS)
        + f"; fused_expand_pq on one set of tables (L2-warm) "
        f"{split['fused_expand_pq_l2_tables_ms']:.4f}")
    REPORT["chain_split"] = split
    return split


def check_case(c: Case) -> "tuple[float, str]":
    """Run c's kernel and plain version on its first argument set and hold
    one to the other (raises if they disagree); returns the max abs error
    and a note for the log line."""
    import torch
    out, exp = c.kern(*c.sets[0]), c.plain(*c.sets[0])
    torch.cuda.synchronize()
    note = ""
    if c.scan:
        same = float((out[1] == exp[1]).float().mean())
        if c.exact:
            assert torch.equal(out[0], exp[0]) and same == 1.0, \
                f"{c.name} {c.shape}: ids equal on {same:.6f}"
            err = 0.0
        else:
            ok, err = close(out[0], exp[0])
            assert ok and same >= 0.995, \
                f"{c.name} {c.shape}: dists {ok} ({err}), ids {same}"
        note = f", ids equal on {same:.4%} of {exp[1].numel()} slots"
    elif c.exact:
        outs = out if c.fused else (out,)
        exps = exp if c.fused else (exp,)
        same = [torch.equal(a, b) for a, b in zip(outs, exps)]
        assert all(same), f"{c.name} {c.shape}: outputs equal {same}"
        if c.fused:
            assert int(exp[3].sum()) > 0, "no tie was counted"
            note = ", every output equal"
        err = 0.0
    elif c.fused:
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
    return err, note


def phase_kernels(db):
    """Each kernel vs its plain version at the served paths' shapes: the
    error; `ms`, one call with its launch between CUDA events (the time
    of PR 11's table); `device_ms`, the device time per call from graph
    replay over the case's argument sets; the plain version's two times;
    the bound from those inputs; and the library yardstick."""
    import torch
    inp = kernel_inputs(db)
    rows, main = {}, {}
    for c in kernel_cases(inp):
        err, note = check_case(c)
        costs = [c.cost(*args) for args in c.sets]
        b_ms, b_by = bound(sum(b for b, _ in costs) / len(costs),
                           sum(f for _, f in costs) / len(costs))
        t = dict(ms=cuda_ms(lambda: c.kern(*c.sets[0])),
                 plain_ms=cuda_ms(lambda: c.plain(*c.sets[0])))
        if c.name == "batch_dist":
            # its launch is a negligible share of a call at Q >= 512 (no
            # graph: each replayed call would hold its own output); the
            # one-query retrieval's device time comes from graph replay
            if c.sets[0][0].shape[0] == 1:
                t.update(device_ms=graph_ms(c.kern, c.sets),
                         plain_device_ms=graph_ms(c.plain, c.sets))
            else:
                t.update(device_ms=t["ms"], plain_device_ms=t["plain_ms"])
            qq, xx = c.sets[0]
            lib = ("torch.matmul", cuda_ms(lambda: torch.matmul(qq, xx.T)))
        elif c.scan:
            # the plain scans gather whole lists per query: events only
            t.update(device_ms=graph_ms(c.kern, c.sets),
                     plain_device_ms=None)
            lib = None
        else:
            t.update(device_ms=graph_ms(c.kern, c.sets),
                     plain_device_ms=graph_ms(c.plain, c.sets))
            lib = None
        plain_dev = ("not measured" if t["plain_device_ms"] is None
                     else f"{t['plain_device_ms']:.4f} ms")
        log(f"[{c.name}] {c.shape}: {t['device_ms']:.4f} ms on the device "
            f"over {len(c.sets)} input sets ({t['ms']:.4f} ms a call with "
            f"its launch), bound {b_ms:.4f} ms ({b_by}, "
            f"{b_ms / t['device_ms']:.1%} of it), plain "
            f"{plain_dev} ({t['plain_ms']:.4f}), library "
            + ("none" if lib is None else f"{lib[0]} {lib[1]:.4f} ms")
            + f", max err {err:.2e}{note}")
        row = dict(max_abs_err=err, bound_ms=b_ms, bound_by=b_by,
                   library_ms=None if lib is None else lib[1],
                   shape=c.shape, sets=len(c.sets), **t)
        REPORT.setdefault("kernel_cases", []).append(dict(name=c.name, **row))
        if c.main:
            rows[c.name] = row
            main[c.name] = c
    chain_split(inp, main)
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
    log(f"[main] exact kNN stage: {stages['knn']:.2f} s on "
        f"{ops.launch_counts()['batch_dist']} batch_dist launches (ground "
        f"truth included)")
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
        log_row("main", row)
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

    counts = ops.launch_counts()
    log(f"[main] kernel launches on the main path: {counts}")
    for name in ("fused_expand", "gather_dist", "batch_dist"):
        assert counts[name] > 0, counts
    REPORT["main"]["launches"] = counts
    REPORT["main"]["save_load_s"] = round_trip(
        "main", small_graph(idx, ds), qb, kern)
    return counts, idx, ds, rec


def qps_in_turns(tag, served, ds, scfgs):
    """QPS of each index of `served` (name -> index) at its SearchConfig
    `scfgs[name]` over all queries, in turns (a, b, ..., b, a): the host's
    speed drifts within a run, so indexes are compared side by side and
    not across phases."""
    qps = {name: [] for name in served}
    for name in [*served, *reversed(served)]:
        qps[name].append(serve(served[name], ds.queries, ds.gt_ids,
                               scfgs[name])[1]["qps"])
    log(f"[{tag}] QPS in turns: " + ", ".join(
        f"{name} {a:.0f} / {b:.0f}" for name, (a, b) in qps.items()))
    return qps


def attach(idx, quant, search=None):
    """A clone of the built index `idx` (db, graph, entry, order) with
    `quant` trained over its rows, as the reference's tuner attaches a
    quantizer, and `search` as its search config when given; returns the
    clone and the seconds of its training."""
    from repro_torch.core.index import KBest
    cfg = dataclasses.replace(idx.config, quant=quant,
                              search=search or idx.config.search)
    qidx = KBest(cfg, device=DEVICE)
    qidx._set_state(idx.db, idx.graph, idx.entry, idx.order)
    t0 = time.perf_counter()
    qidx._train_quant(qidx.db)
    sync()
    return qidx, time.perf_counter() - t0


def small_graph(idx, ds):
    """A graph over the first ROUND_TRIP_N rows with phase 4's config,
    built once: phase 4's save/load round trip, and what phases 5 and 6
    attach a kind to for theirs."""
    from repro_torch.core.index import KBest
    if "graph" not in SMALL:
        SMALL["graph"] = KBest(idx.config, device=DEVICE).add(
            ds.base[:ROUND_TRIP_N])
        sync()
    return SMALL["graph"]


def round_trip(tag, index, qb, scfg) -> float:
    """Save `index`, load it back through its class and hold the ids of
    the batch `qb` at `scfg` to the original's; returns the seconds of
    the save and the load."""
    import numpy as np
    import torch
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        index.save(f"{tmp}/index")
        back = type(index).load(f"{tmp}/index", device=DEVICE)
        rt_s = time.perf_counter() - t0
    _, i2 = back.search(qb, search_cfg=scfg)
    _, i3 = index.search(qb, search_cfg=scfg)
    assert torch.equal(i2, i3), tag
    if hasattr(index, "offsets"):
        assert np.array_equal(back.offsets, index.offsets), tag
    log(f"[{tag}] save/load round trip at {ROUND_TRIP_N:,} rows "
        f"{rt_s:.1f} s: identical ids")
    return rt_s


def log_row(tag, row):
    log(f"[{tag}] W={row['W']} L={row['L']} {row['dist_impl']}: recall@10 "
        f"{row['recall']:.4f}, QPS {row['qps']:.0f}, iters mean "
        f"{row['iters_mean']:.1f} max {row['iters_max']}, hops/q "
        f"{row['hops_per_query']:.1f}, dists/q {row['dists_per_query']:.1f}, "
        f"ET rate {row['et_rate']:.3f}")


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
    small = small_graph(idx, ds)
    ops.reset_launch_counts()
    for kind, quant in quants.items():
        qidx, train_s = attach(idx, quant)
        cfg = qidx.config
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
                log_row(kind, row)
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
        rep_q["save_load_s"] = round_trip(kind, attach(small, quant)[0], qb,
                                          s4)
        served[kind] = qidx
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
    # the kernels
    REPORT["quant"]["qps_in_turns"] = qps_in_turns(
        "quant", served, ds, dict.fromkeys(served, s4))
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


def phase_pq4_bin(idx, ds, none_rec):
    """The registry's pq4 and pq4+u8lut (L=96) and the bin preset (L=320,
    re-rank of rescore_factor * k) on phase 4's graph, attached as in
    phase 5: all queries at W=4 and W=1 on the kernels, one batch per kind
    and W on the plain path, the idle share, QPS in turns with none, and a
    save/load round trip of a pq4 and a bin index over ROUND_TRIP_N rows.
    The fault floors (written before the first run) detect faults; they
    are no targets."""
    import numpy as np
    from repro_torch.configs.kbest import bin_index_config
    from repro_torch.core import quantize as qz
    from repro_torch.core.types import QuantConfig
    from repro_torch.kernels import ops

    preset = bin_index_config("deep_like")
    bin_search = dataclasses.replace(
        idx.config.search, L=preset.search.L,
        rescore_factor=preset.search.rescore_factor)
    reg = qz.quant_variants()
    kinds = {"pq4": (QuantConfig(**reg["pq4"]), None, 8),
             "pq4+u8lut": (QuantConfig(**reg["pq4+u8lut"]), None, 8),
             "bin": (preset.quant, bin_search, 12)}
    qb = ds.queries[:BATCH]
    served = {"none": idx}
    rep = REPORT["pq4_bin"] = {}
    rec = {}
    small = small_graph(idx, ds)
    ops.reset_launch_counts()
    for name, (quant, search, want_bytes) in kinds.items():
        qidx, train_s = attach(idx, quant, search)
        code_b = qz.code_bytes_per_vector(qidx)
        log(f"[{name}] {quant}: trained and encoded {len(qidx.db):,} rows in "
            f"{train_s:.1f} s, {code_b} code bytes per vector")
        assert code_b == want_bytes, (name, code_b)
        r = rep[name] = dict(train_s=train_s, code_bytes=code_b, rows=[])
        kern = dataclasses.replace(qidx.config.search, dist_impl="kernel")
        for W in (4, 1):
            s = dataclasses.replace(kern, beam_width=W)
            ids, row = serve(qidx, ds.queries, ds.gt_ids, s)
            row["L"] = s.L
            _, plain_ids = qidx.search(qb, search_cfg=dataclasses.replace(
                s, dist_impl="ref"))
            row["plain_ids_equal"] = float(np.mean(
                ids[:BATCH] == plain_ids.cpu().numpy()))
            r["rows"].append(row)
            rec[(name, W)] = row["recall"]
            log_row(name, row)
            log(f"[{name}] W={W} kernel vs plain on one batch: ids equal on "
                f"{row['plain_ids_equal']:.4%} of (query, rank); kind none "
                f"at this W: {none_rec[(W, 'kernel')]:.4f}")
            assert row["plain_ids_equal"] >= (1.0 if name == "bin"
                                              else 0.995), row
        s4 = dataclasses.replace(kern, beam_width=4)
        dev_ms, wall_ms = device_busy(lambda: qidx.search(qb, search_cfg=s4))
        log(f"[{name}] profile W=4, one batch of {BATCH}: device kernels "
            f"{dev_ms:.2f} ms of {wall_ms:.2f} ms wall (idle share "
            f"{1 - dev_ms / wall_ms:.1%}, under the profiler)")
        r["profile_W4"] = dict(device_ms=dev_ms, wall_ms=wall_ms)
        if name in ("pq4", "bin"):
            r["save_load_s"] = round_trip(
                name, attach(small, quant, search)[0], qb, s4)
        served[name] = qidx
    counts = ops.launch_counts()
    log(f"[pq4/bin] kernel launches on these paths: {counts}")
    rep["launches"] = counts
    for k in ("pq4_adc", "fused_expand_pq4", "bin_dist", "fused_expand_bin",
              "gather_dist"):
        assert counts[k] > 0, counts
    # fault floors: a first pass this weak means a broken codec or kernel
    assert rec[("pq4", 4)] >= 0.20, rec
    assert abs(rec[("pq4+u8lut", 4)] - rec[("pq4", 4)]) <= 0.02, rec
    assert rec[("bin", 4)] >= 0.60 and rec[("bin", 1)] >= 0.60, rec
    probe_depth(idx, ds, served, kinds["pq4"][0])
    # QPS in turns at W=4 on the kernels, each kind at its own L
    rep["qps_in_turns"] = qps_in_turns("pq4/bin", served, ds, {
        name: dataclasses.replace(x.config.search, dist_impl="kernel",
                                  beam_width=4)
        for name, x in served.items()})
    return counts


def probe_depth(idx, ds, served, pq4_quant):
    """What caps the 8- and 12-byte first passes at 1M (after the launch
    count): pq4 re-ranked over its whole queue; bin with queue and re-rank
    twice as deep; and bin's ceiling, the share of the true top-10 that
    the exact Hamming ranking over all rows puts within its first R = 320
    (an interval: Hamming ties straddle the R-th place)."""
    import numpy as np
    import torch
    from repro_torch.core import quantize as qz
    from repro_torch.core.index import KBest
    from repro_torch.kernels import ops
    rep = REPORT["pq4_bin"]["depth"] = {}
    p4 = served["pq4"]
    deep = KBest(dataclasses.replace(p4.config, quant=dataclasses.replace(
        pq4_quant, rerank=p4.config.search.L)), device=DEVICE)
    deep._set_state(idx.db, idx.graph, idx.entry, idx.order)
    deep.pq, deep.pq_codes = p4.pq, p4.pq_codes
    s4 = dataclasses.replace(deep.config.search, dist_impl="kernel",
                             beam_width=4)
    rep["pq4_rerank_L"] = serve(deep, ds.queries, ds.gt_ids, s4)[1]
    b = served["bin"]
    sb = dataclasses.replace(b.config.search, dist_impl="kernel",
                             beam_width=4)
    sb = dataclasses.replace(sb, L=2 * sb.L,
                             rescore_factor=2 * sb.rescore_factor)
    rep["bin_twice_deep"] = dict(serve(b, ds.queries, ds.gt_ids, sb)[1],
                                 L=sb.L, rescore_factor=sb.rescore_factor)
    del deep
    # per query, how many rows lie at each Hamming distance
    Q, R, n, chunk = BATCH, 320, b.db.shape[0], 100_000
    qc = qz.bin_query_codes(b.bin, torch.as_tensor(
        ds.queries[:Q], dtype=torch.float32, device=b.device))
    hist = torch.zeros((Q, b.bin.dim + 1), dtype=torch.int64,
                       device=b.device)
    for s in range(0, n, chunk):
        ids = torch.arange(s, min(s + chunk, n), dtype=torch.int32,
                           device=b.device)[None].expand(Q, -1).contiguous()
        d = ops.bin_dist(qc, b.bin_codes, ids).long()
        hist.scatter_add_(1, d, torch.ones_like(d))
    cum = torch.cumsum(hist, 1)
    new_of_old = np.empty(n, np.int64)
    new_of_old[b.order] = np.arange(n)
    true = torch.as_tensor(new_of_old[ds.gt_ids[:Q, :10]], device=b.device)
    h = ops.bin_dist(qc, b.bin_codes, true.to(torch.int32)).long()
    ahead = torch.gather(cum, 1, h) - torch.gather(hist, 1, h)  # closer rows
    surely = float((torch.gather(cum, 1, h) <= R).float().mean())
    maybe = float((ahead < R).float().mean())
    rep["bin_ceiling_R320"] = dict(queries=Q, surely=surely, at_most=maybe,
                                   true_hamming_mean=float(h.float().mean()))
    log(f"[depth] pq4 re-ranked over the whole queue of {s4.L}: recall@10 "
        f"{rep['pq4_rerank_L']['recall']:.4f}; bin at L={sb.L}, "
        f"rescore_factor={sb.rescore_factor}: recall@10 "
        f"{rep['bin_twice_deep']['recall']:.4f}, QPS "
        f"{rep['bin_twice_deep']['qps']:.0f}, dists/q "
        f"{rep['bin_twice_deep']['dists_per_query']:.1f}; exact Hamming "
        f"top-{R} over all {n:,} rows holds {surely:.4f}–{maybe:.4f} of the "
        f"true top-10 ({Q} queries, their mean Hamming distance "
        f"{float(h.float().mean()):.1f} of {b.bin.dim})")


def phase_ivf(ds, none_rec):
    """The IVF presets for deep_like on phase 4's 1M vectors (no graph):
    each built on the card and all queries served through the list-scan
    kernels, one batch on the plain path held against them, the idle
    share, n_dist, the list lengths, build stages, peak memory and code
    bytes; ivf_pq once more at 4x its nprobe; a save/load round trip of
    the bin preset over ROUND_TRIP_N rows. Fault floors (written before
    the first run) detect faults; they are no targets."""
    import numpy as np
    import torch
    from repro_torch.configs.kbest import (ivf_bin_index_config,
                                           ivf_index_config,
                                           ivf_pq4_index_config)
    from repro_torch.core import quantize as qz
    from repro_torch.core.index import KBest
    from repro_torch.kernels import ops

    presets = {"ivf_pq": ivf_index_config("deep_like"),
               "ivf_pq4": ivf_pq4_index_config("deep_like"),
               "ivf_bin": ivf_bin_index_config("deep_like")}
    qb = ds.queries[:BATCH]
    rep = REPORT["ivf"] = {}
    rec = {}
    ops.reset_launch_counts()
    for name, cfg in presets.items():
        if DEVICE == "cuda":
            torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        idx = KBest(cfg, device=DEVICE).add(ds.base, timings=StageLog(name))
        sync()
        build_s = time.perf_counter() - t0
        peak_gb = (torch.cuda.max_memory_allocated() / 2 ** 30
                   if DEVICE == "cuda" else 0.0)
        lens = (idx.ivf.list_ids >= 0).sum(1).float()
        spread = dict(nlist=idx.ivf.nlist, max_len=idx.ivf.max_len,
                      min=int(lens.min()), median=float(lens.median()),
                      max=int(lens.max()), std=float(lens.std()))
        code_b = qz.code_bytes_per_vector(idx)
        r = rep[name] = dict(build_s=build_s, peak_gib=peak_gb,
                             stages={k: round(v, 3)
                                     for k, v in idx.build_times.items()},
                             lists=spread, code_bytes=code_b)
        log(f"[{name}] build {build_s:.1f} s, peak device memory "
            f"{peak_gb:.2f} GiB, {code_b} code bytes per vector, lists "
            f"{json.dumps(spread)}")
        kern = dataclasses.replace(cfg.search, dist_impl="kernel")
        ids, row = serve(idx, ds.queries, ds.gt_ids, kern)
        _, plain_ids = idx.search(qb, search_cfg=dataclasses.replace(
            kern, dist_impl="ref"))
        row.update(L=kern.L, nprobe=kern.nprobe, plain_ids_equal=float(
            np.mean(ids[:BATCH] == plain_ids.cpu().numpy())))
        r["row"] = row
        rec[name] = row["recall"]
        dev_ms, wall_ms = device_busy(lambda: idx.search(qb, search_cfg=kern))
        r["profile"] = dict(device_ms=dev_ms, wall_ms=wall_ms)
        log(f"[{name}] nprobe={kern.nprobe} L={kern.L}: recall@10 "
            f"{row['recall']:.4f}, QPS {row['qps']:.0f}, n_dist/q "
            f"{row['dists_per_query']:.1f}; kernel vs plain on one batch: "
            f"ids equal on {row['plain_ids_equal']:.4%}; one batch of "
            f"{BATCH}: device kernels {dev_ms:.2f} ms of {wall_ms:.2f} ms "
            f"wall (idle share {1 - dev_ms / wall_ms:.1%}, under the "
            f"profiler); graph none at W=4: {none_rec[(4, 'kernel')]:.4f}")
        assert row["plain_ids_equal"] >= (1.0 if name == "ivf_bin"
                                          else 0.995), row
        if name == "ivf_pq":
            # 4x the probes: does the probe fraction (2.4% of the lists at
            # 1M against 10.7% at the 50k the preset was tuned at) or the
            # codes set the recall?
            wide = dataclasses.replace(kern, nprobe=4 * kern.nprobe)
            _, row4 = serve(idx, ds.queries, ds.gt_ids, wide)
            row4.update(L=wide.L, nprobe=wide.nprobe)
            r["nprobe_x4"] = row4
            log(f"[{name}] nprobe={wide.nprobe}: recall@10 "
                f"{row4['recall']:.4f}, QPS {row4['qps']:.0f}, n_dist/q "
                f"{row4['dists_per_query']:.1f}")
        if name == "ivf_pq":
            ivf_pq = idx                 # phase 9 serves it under overload
        if name == "ivf_bin":
            r["save_load_s"] = round_trip(name, KBest(cfg, device=DEVICE).add(
                ds.base[:ROUND_TRIP_N]), qb, kern)
        del idx
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
    counts = ops.launch_counts()
    log(f"[ivf] kernel launches on the IVF paths: {counts}")
    rep["launches"] = counts
    for k in ("ivf_scan", "pq4_ivf_scan", "bin_ivf_scan", "gather_dist"):
        assert counts[k] > 0, counts
    # fault floors: a recall this low means a broken build, codec or scan
    assert all(v >= 0.30 for v in rec.values()), rec
    assert rep["ivf_pq"]["nprobe_x4"]["recall"] >= rec["ivf_pq"], rec
    return counts, ivf_pq


# --------------------------------------------------------------------------
# phases 8 and 9
# --------------------------------------------------------------------------
def phase_sharded(idx, ds, none_rec, ivf_pq):
    """The sharded composition on phase 4's vectors and queries: phase 4's
    index wrapped as one shard (bit-identical to it, no second build);
    phase 4's config over two shards (two independent 500,000-row builds)
    served at W=4 and W=1, a save/load round trip of the config over
    ROUND_TRIP_N rows; the deep_like IVF-PQ preset over two shards beside
    phase 7's `ivf_pq`; each QPS in turns with its one-index counterpart.
    Returns the 2-shard graph for phase 9."""
    import torch
    from repro_torch.configs.kbest import sharded_ivf_index_config
    from repro_torch.core.sharded import ShardedKBest, shard_bounds
    from repro_torch.kernels import ops

    rep = REPORT["sharded"] = {}
    qb = ds.queries[:BATCH]
    kern = dataclasses.replace(idx.config.search, dist_impl="kernel")

    one = ShardedKBest(idx.config, n_shards=1, device=DEVICE)
    one.offsets, one.shards = shard_bounds(idx.db.shape[0], 1), [idx]
    d0, i0, s0 = idx.search(qb, search_cfg=kern, with_stats=True)
    d1, i1, s1 = one.search(qb, search_cfg=kern, with_stats=True)
    assert torch.equal(i0, i1) and torch.equal(d0, d1)
    assert all(torch.equal(a, b) for a, b in zip(s0, s1))
    log(f"[sharded] one shard over phase 4's index: ids, distances and "
        f"stats on {BATCH} queries identical to KBest.search")

    # two shards of phase 4's own config: two independent builds
    ops.reset_launch_counts()
    cfg = dataclasses.replace(idx.config, n_shards=2)
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    sh = ShardedKBest(cfg, device=DEVICE).add(ds.base)
    sync()
    build_s = time.perf_counter() - t0
    peak_gb = (torch.cuda.max_memory_allocated() / 2 ** 30
               if DEVICE == "cuda" else 0.0)
    stages = [{k: round(v, 3) for k, v in s.build_times.items()}
              for s in sh.shards]
    g = rep["graph"] = dict(build_s=build_s, peak_gib=peak_gb,
                            offsets=sh.offsets.tolist(), stages=stages,
                            shard_s=[sum(st.values()) for st in stages],
                            rows=[])
    log(f"[sharded] 2-shard graph build {build_s:.1f} s (shards "
        f"{', '.join(f'{x:.1f}' for x in g['shard_s'])} s; phase 4's one "
        f"1M build {REPORT['main']['build_s']:.1f} s), peak device memory "
        f"{peak_gb:.2f} GiB")
    for s, st in enumerate(stages):
        log(f"[sharded] shard {s} stages (s): {json.dumps(st)}")
    rec = {}
    for W in (4, 1):
        scfg = dataclasses.replace(kern, beam_width=W)
        ids, row = serve(sh, ds.queries, ds.gt_ids, scfg)
        row["L"] = scfg.L
        g["rows"].append(row)
        rec[W] = row["recall"]
        log_row("sharded 2", row)
        log(f"[sharded] W={W}: one index (phase 4) recall@10 "
            f"{none_rec[(W, 'kernel')]:.4f}")
    dev_ms, wall_ms = device_busy(lambda: sh.search(qb, search_cfg=kern))
    g["profile_W4"] = dict(device_ms=dev_ms, wall_ms=wall_ms)
    log(f"[sharded] profile W=4, one batch of {BATCH}: device kernels "
        f"{dev_ms:.2f} ms of {wall_ms:.2f} ms wall (idle share "
        f"{1 - dev_ms / wall_ms:.1%}, under the profiler)")
    # multi-shard recall >= one index at equal per-shard L (the
    # reference's invariant), less a margin for ulp ties
    assert rec[4] >= none_rec[(4, "kernel")] - 0.005, (rec, none_rec)

    counts = ops.launch_counts()
    g["launches"] = counts
    log(f"[sharded] kernel launches on the 2-shard graph path: {counts}")
    for name in ("fused_expand", "gather_dist", "batch_dist"):
        assert counts[name] > 0, counts
    g["qps_in_turns"] = qps_in_turns("sharded", {"one": idx, "two": sh},
                                     ds, dict(one=kern, two=kern))
    g["save_load_s"] = round_trip("sharded", ShardedKBest(
        cfg, device=DEVICE).add(ds.base[:ROUND_TRIP_N]), qb, kern)

    # two shards of the IVF-PQ preset
    ops.reset_launch_counts()
    icfg = sharded_ivf_index_config("deep_like")
    t0 = time.perf_counter()
    ish = ShardedKBest(icfg, device=DEVICE).add(ds.base)
    sync()
    ibuild_s = time.perf_counter() - t0
    ikern = dataclasses.replace(icfg.search, dist_impl="kernel")
    _, irow = serve(ish, ds.queries, ds.gt_ids, ikern)
    idev_ms, iwall_ms = device_busy(lambda: ish.search(qb, search_cfg=ikern))
    one_row = REPORT["ivf"]["ivf_pq"]["row"]
    icounts = ops.launch_counts()
    iturns = qps_in_turns("sharded ivf_pq", {"one": ivf_pq, "two": ish},
                          ds, dict(one=ikern, two=ikern))
    rep["ivf_pq"] = dict(build_s=ibuild_s, nlist=[s.ivf.nlist
                                                  for s in ish.shards],
                         row=irow, launches=icounts, qps_in_turns=iturns,
                         profile=dict(device_ms=idev_ms, wall_ms=iwall_ms))
    log(f"[sharded] 2-shard ivf_pq (nlist {[s.ivf.nlist for s in ish.shards]}"
        f", nprobe={ikern.nprobe} a shard, L={ikern.L}): build {ibuild_s:.1f}"
        f" s, recall@10 {irow['recall']:.4f}, QPS {irow['qps']:.0f}, n_dist/q"
        f" {irow['dists_per_query']:.1f}; one index (phase 7) recall@10 "
        f"{one_row['recall']:.4f}, QPS {one_row['qps']:.0f}; one batch of "
        f"{BATCH}: device kernels {idev_ms:.2f} ms of {iwall_ms:.2f} ms wall")
    log(f"[sharded] kernel launches on the 2-shard IVF path: {icounts}")
    for name in ("ivf_scan", "gather_dist"):
        assert icounts[name] > 0, icounts
    assert irow["recall"] >= one_row["recall"] - 0.005, (irow, one_row)
    del ish
    return sh


def drain_requests(ds, scfg, engine, seed=0):
    """All queries as seeded requests of 1-64 queries at k=10 to the
    engine named `engine`."""
    import numpy as np
    from repro_torch.serve import Request
    rng = np.random.default_rng(seed)
    reqs, s = [], 0
    while s < len(ds.queries):
        e = min(s + int(rng.integers(1, 65)), len(ds.queries))
        reqs.append(Request(queries=ds.queries[s:e], gt_ids=ds.gt_ids[s:e],
                            k=10, search_cfg=scfg, engine=engine,
                            request_id=len(reqs)))
        s = e
    return reqs


def drain(eng, ds, scfg, tag):
    """A closed drain (coalescing on) of all queries through `eng`; asserts
    no new trace and the true served count. Returns (report, row,
    requests)."""
    from repro_torch.serve import serve_loop
    reqs = drain_requests(ds, scfg, eng.name)
    traces = eng.n_traces
    eng.reset_stats()
    sync()
    t0 = time.perf_counter()
    out = serve_loop(eng, reqs)
    wall = time.perf_counter() - t0
    assert eng.n_traces == traces, (eng.n_traces, traces)
    assert out.n_served == len(ds.queries), out.n_served
    row = dict(requests=out.n_requests, dispatches=out.n_dispatches,
               served=out.n_served, qps=out.n_served / wall, wall_s=wall,
               recall=out.recall_at_k, lat_p50_ms=out.lat_p50_ms,
               lat_p95_ms=out.lat_p95_ms, lat_p99_ms=out.lat_p99_ms,
               dists_per_query=eng.stats().dists_per_query)
    log(f"[serving] {tag}: {out.n_requests} requests of 1-64 queries in "
        f"{out.n_dispatches} dispatches, QPS {row['qps']:.0f}, recall@10 "
        f"{row['recall']:.4f}, dispatch latency p50/p95/p99 "
        f"{row['lat_p50_ms']:.2f}/{row['lat_p95_ms']:.2f}/"
        f"{row['lat_p99_ms']:.2f} ms")
    return out, row, reqs


def calibrate(eng, ds, ladder, batch):
    """benchmarks/serving.py's `_calibrate` on the card: run every rung's
    buckets, feed measured dispatches to the LatencyModel, and return it
    with the median service ms of a `batch`-row dispatch at rung 0 and
    of each rung's three calibration dispatches."""
    import numpy as np
    from repro_torch.serve import LatencyModel
    model = LatencyModel(slack=1.5)
    rung_ms = []
    for rung in ladder:
        eng.warmup(search_cfg=rung)
        for rows in (batch, eng.max_bucket):
            ms = []
            for _ in range(3):
                t0 = time.perf_counter()
                eng.search(ds.queries[:rows], search_cfg=rung)
                ms.append((time.perf_counter() - t0) * 1e3)
                model.observe(eng, rung, rows, ms[-1])
            if rows == batch:
                rung_ms.append(float(np.median(ms)))
    samples = []
    for _ in range(5):
        t0 = time.perf_counter()
        eng.search(ds.queries[:batch], search_cfg=ladder[0])
        samples.append((time.perf_counter() - t0) * 1e3)
    return model, float(np.median(samples)), rung_ms


def overload(eng, ds, ladder, n_requests, batch=8, seed=0):
    """benchmarks/serving.py's overload pair on the card: Poisson arrivals
    at 2x the measured capacity with a deadline on every request, served
    twice (no policy; admission + degrade ladder + bounded queue), the
    reference's three claims asserted. Coalescing is off for both runs, so
    every dispatch is `batch` rows, the shape admission calibrated on."""
    import numpy as np
    from repro_torch.serve import DegradePolicy, Request, serve_loop
    model, s_ms, rung_ms = calibrate(eng, ds, ladder, batch)
    capacity_qps = batch / (s_ms / 1e3)
    offered_qps = 2.0 * capacity_qps
    slo_ms = max(6.0 * s_ms, 20.0)
    _, floor_row = serve(eng.index, ds.queries, ds.gt_ids, ladder[-1])
    floor = floor_row["recall"]

    rng = np.random.default_rng(seed)
    arrivals_ms = np.cumsum(
        rng.exponential(batch / offered_qps, size=n_requests)) * 1e3
    starts = np.random.default_rng(seed + 1).integers(
        0, len(ds.queries) - batch + 1, size=n_requests)

    def make_requests():
        return [Request(queries=ds.queries[s:s + batch],
                        gt_ids=ds.gt_ids[s:s + batch], request_id=i,
                        search_cfg=ladder[0], engine=eng.name,
                        arrival_ms=float(a),
                        deadline_ms=slo_ms)
                for i, (a, s) in enumerate(zip(arrivals_ms, starts))]

    def run_row(out, mode):
        good = sum(r.n_served for r in out.results
                   if r.status == "ok" and not r.deadline_missed)
        return dict(mode=mode, n_requests=out.n_requests,
                    n_ok=sum(r.status == "ok" for r in out.results),
                    n_rejected=out.n_rejected, n_shed=out.n_shed,
                    n_failed=out.n_failed,
                    n_deadline_missed=out.n_deadline_missed,
                    goodput_qps=good / (max(out.t_end_ms,
                                            float(arrivals_ms[-1])) / 1e3),
                    sojourn_p50_ms=out.sojourn_p50_ms,
                    sojourn_p99_ms=out.sojourn_p99_ms,
                    recall_served=out.recall_at_k)

    eng.reset_stats()
    base = run_row(serve_loop(eng, make_requests(), coalesce=False,
                              admission=False), "baseline")
    eng.reset_stats()
    policy = DegradePolicy(ladder=tuple(ladder), high_ms=0.3 * slo_ms,
                           low_ms=0.05 * slo_ms, patience=2)
    pol = run_row(serve_loop(eng, make_requests(), coalesce=False,
                             admission=True, latency_model=model,
                             degrade=policy,
                             max_queue=max(4, n_requests // 10)), "policy")
    pol["degrade_transitions"] = len(policy.transitions)
    pol["degrade_occupancy"] = {str(k): v for k, v in
                                sorted(policy.occupancy.items())}
    result = dict(batch=batch, n_requests=n_requests, service_ms=s_ms,
                  capacity_qps=capacity_qps, offered_qps=offered_qps,
                  slo_ms=slo_ms, floor_recall=floor, rung_ms=rung_ms,
                  ladder=[f"L={r.L},nprobe={r.nprobe},rf={r.rescore_factor}"
                          for r in ladder], runs=[base, pol])
    log(f"[serving] overload on ivf_pq: service {s_ms:.3f} ms a batch of "
        f"{batch}, capacity {capacity_qps:.0f} QPS, offered "
        f"{offered_qps:.0f} QPS, SLO {slo_ms:.2f} ms, ladder "
        f"{result['ladder']}, bottom rung's recall@10 {floor:.4f}; "
        f"service ms a batch by rung (median of 3) "
        f"{', '.join(f'{x:.3f}' for x in rung_ms)}")
    for row in (base, pol):
        log(f"[serving]   {row['mode']}: goodput {row['goodput_qps']:.0f} "
            f"QPS, sojourn p50/p99 {row['sojourn_p50_ms']:.2f}/"
            f"{row['sojourn_p99_ms']:.2f} ms, ok {row['n_ok']}, rejected "
            f"{row['n_rejected']}, shed {row['n_shed']}, missed "
            f"{row['n_deadline_missed']}, recall {row['recall_served']}")
    log(f"[serving]   policy occupancy {pol['degrade_occupancy']}, "
        f"{pol['degrade_transitions']} transitions, served recall minus "
        f"the bottom rung's {pol['recall_served'] - floor:+.4f}")
    # the reference's three claims, with its margin on the recall: the
    # served queries are a sample of the set the floor was taken over
    assert pol["sojourn_p99_ms"] <= slo_ms, (pol, slo_ms)
    assert pol["goodput_qps"] > base["goodput_qps"], (pol, base)
    assert pol["recall_served"] >= floor - 0.02, (pol, floor)
    return result


def phase_serving(idx, sharded, ivf_pq, ds):
    """The serving tier on the card: a SearchEngine (buckets 8-256) over
    phase 4's graph at W=4, L=96 on the kernels, warmed, then a closed
    drain of all queries as requests of 1-64 through serve_loop, each
    request's ids held against KBest.search of its queries; the same drain
    through phase 8's 2-shard graph; the engine's latency at buckets 8 and
    256; the overload pair on phase 7's ivf_pq index."""
    import numpy as np
    import torch
    from repro_torch.configs.kbest import degrade_ladder
    from repro_torch.kernels import ops
    from repro_torch.serve import SearchEngine

    rep = REPORT["serving"] = {}
    kern = dataclasses.replace(idx.config.search, dist_impl="kernel")
    eng = SearchEngine(idx, name="deep1m")
    warm = eng.warmup(search_cfg=kern)
    log(f"[serving] warmup: {warm} traces (buckets "
        f"{eng.min_bucket}-{eng.max_bucket})")
    assert warm == 6, warm
    ops.reset_launch_counts()
    out, row, reqs = drain(eng, ds, kern, "Deep1M graph, W=4 L=96")
    counts = ops.launch_counts()
    log(f"[serving] kernel launches on the drain: {counts}")
    for name in ("fused_expand", "gather_dist"):
        assert counts[name] > 0, counts
    row["launches"] = counts
    t0 = time.perf_counter()
    for req, r in zip(reqs, out.results):
        assert req.request_id == r.request_id
        _, ids = idx.search(req.queries, search_cfg=kern)
        assert np.array_equal(r.ids, ids.cpu().numpy()), r.request_id
    log(f"[serving] every request's ids equal KBest.search of its queries "
        f"({time.perf_counter() - t0:.1f} s to check)")
    rep["graph"] = row

    # the engine's dispatch latency at the smallest and largest bucket,
    # and the device's busy share of one full bucket
    lat = {}
    for b in (8, 256):
        eng.reset_stats()
        for s in range(20):
            s = s * b % (len(ds.queries) - b + 1)
            eng.search(ds.queries[s:s + b], search_cfg=kern)
        st = eng.stats()
        lat[b] = (st.lat_p50_ms, st.lat_p95_ms, st.lat_p99_ms)
    dev_ms, wall_ms = device_busy(
        lambda: eng.search(ds.queries[:256], search_cfg=kern))
    # the same 20 bucket-256 calls again after that profiler session: does
    # a torch.profiler session leave every later launch slower?
    eng.reset_stats()
    for s in range(20):
        s = s * 256 % (len(ds.queries) - 255)
        eng.search(ds.queries[s:s + 256], search_cfg=kern)
    after = eng.stats()
    rep["bucket_256_after_profile_ms"] = dict(
        p50=after.lat_p50_ms, p95=after.lat_p95_ms, p99=after.lat_p99_ms)
    rep["bucket_lat_ms"] = {str(b): dict(zip(("p50", "p95", "p99"), v))
                            for b, v in lat.items()}
    rep["profile_256"] = dict(device_ms=dev_ms, wall_ms=wall_ms)
    log(f"[serving] dispatch latency p50/p95/p99, 20 calls: bucket 8 "
        f"{lat[8][0]:.2f}/{lat[8][1]:.2f}/{lat[8][2]:.2f} ms, bucket 256 "
        f"{lat[256][0]:.2f}/{lat[256][1]:.2f}/{lat[256][2]:.2f} ms; one "
        f"bucket-256 dispatch: device kernels {dev_ms:.2f} ms of "
        f"{wall_ms:.2f} ms wall (idle share {1 - dev_ms / wall_ms:.1%}, "
        f"under the profiler); bucket 256 again after it: "
        f"{after.lat_p50_ms:.2f}/{after.lat_p95_ms:.2f}/"
        f"{after.lat_p99_ms:.2f} ms")

    eng2 = SearchEngine(sharded, name="deep1m_2shard")
    assert eng2._cache_key(8, kern)[-1] == 2
    assert eng2.warmup(search_cfg=kern) == 6
    _, rep["sharded_graph"], _ = drain(eng2, ds, kern,
                                       "Deep1M 2-shard graph, W=4 L=96")

    cfg = ivf_pq.config
    ikern = dataclasses.replace(cfg.search, dist_impl="kernel")
    ladder = degrade_ladder(dataclasses.replace(cfg, search=ikern))
    ieng = SearchEngine(ivf_pq, min_bucket=8, max_bucket=32, name="ivf_pq")
    ops.reset_launch_counts()
    rep["overload"] = overload(ieng, ds, ladder, OVERLOAD_REQUESTS)
    counts = ops.launch_counts()
    log(f"[serving] kernel launches on the overload pair: {counts}")
    for name in ("ivf_scan", "gather_dist"):
        assert counts[name] > 0, counts
    rep["overload"]["launches"] = counts
    if DEVICE == "cuda":
        torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# phase 10
# --------------------------------------------------------------------------
def check_tune_result(res, tag):
    """The reference's invariants of tune_config: at most half the grid
    measured, rows cheapest-first by pred_us, and the winner the first row
    at slo + margin or better, else the best measured row with a note."""
    assert res.n_measured == len(res.rows) <= res.grid_size // 2, tag
    preds = [r["pred_us"] for r in res.rows]
    assert preds == sorted(preds), (tag, preds)
    s = res.config.search
    won = (res.config.quant.kind, s.L, s.nprobe, s.beam_width,
           s.rescore_factor)
    keys = [(r["kind"], r["L"], r["nprobe"], r["beam_width"],
             r["rescore_factor"]) for r in res.rows]
    cleared = [i for i, r in enumerate(res.rows)
               if r["recall"] >= res.recall_slo + 0.02]
    if cleared:
        assert cleared == [len(res.rows) - 1] and won == keys[-1], tag
    else:
        best = max(range(len(res.rows)), key=lambda i: res.rows[i]["recall"])
        assert won == keys[best] and res.notes, (tag, res.notes)


def tune_summary(res, seconds, counts):
    s = res.config.search
    return dict(
        grid_size=res.grid_size, n_deduped=res.n_deduped,
        n_measured=res.n_measured, n_pruned=res.n_pruned,
        winner=dict(kind=res.config.quant.kind, pq_m=res.config.quant.pq_m,
                    L=s.L, nprobe=s.nprobe, beam_width=s.beam_width,
                    rescore_factor=s.rescore_factor, early_term=s.early_term,
                    et_t_frac=s.et_t_frac, et_patience=s.et_patience),
        recall_tune=res.recall_tune, recall_holdout=res.recall_holdout,
        recall_slo=res.recall_slo, notes=res.notes, rows=res.rows,
        seconds=seconds, launches=counts)


def phase_tuner(idx, ds):
    """The tuner (core/tune.py) on the card, on phase 4's vectors, queries
    and exact ground truth, every search on the kernels: (a)
    tune_early_term on phase 4's graph at W=4, L=96 over TUNE_Q queries,
    the tuned and untuned configs then served in turns over the other
    queries; (b) tune_quant_kind(pq_m=16) on the same graph (five
    quantizer trainings at 1M); (c) tune_config over the IVF kinds at 1M
    with 5,000 tune and 5,000 holdout queries; (d) tune_config over the
    graph kinds at N_TUNE_GRAPH vectors (a cut: PERF.md §4)."""
    import torch
    from repro_torch.core import tune
    from repro_torch.core.index import KBest
    from repro_torch.data.vectors import exact_topk_device
    from repro_torch.kernels import ops

    rep = REPORT["tuner"] = {}
    kern = dataclasses.replace(idx.config.search, dist_impl="kernel",
                               beam_width=4, L=MAIN_L)
    # phase 4's graph, searched on the kernels by default (the clones of
    # tune_quant_kind search with their index's config)
    kidx = KBest(dataclasses.replace(idx.config, search=kern), device=DEVICE)
    kidx._set_state(idx.db, idx.graph, idx.entry, idx.order)
    tq, tgt = ds.queries[:TUNE_Q], ds.gt_ids[:TUNE_Q]
    hq, hgt = ds.queries[TUNE_Q:], ds.gt_ids[TUNE_Q:]

    # (a) the paper's two-stage (t, tau_max) search
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    ev = tune._memo_eval(kidx, tq, tgt)
    tuned = tune.tune_early_term(kidx, tq, tgt, kern, _ev=ev)
    sync()
    et_s = time.perf_counter() - t0
    rec0, hops0 = ev(dataclasses.replace(kern, early_term=False))
    rec_t, hops_t = ev(tuned)
    floor = min(0.95, rec0) - 0.005
    log(f"[tuner] ET search over {TUNE_Q} queries: {len(ev.cache)} configs "
        f"measured in {et_s:.1f} s; no ET: recall@10 {rec0:.4f}, hops "
        f"{hops0:.1f}; tuned t={tuned.et_t_frac} patience "
        f"{tuned.et_patience} (ET {tuned.early_term}): recall@10 "
        f"{rec_t:.4f} (floor {floor:.4f}), hops {hops_t:.1f}")
    assert rec_t >= floor and hops_t <= hops0, (rec_t, floor, hops_t, hops0)
    served = {}
    for name, s in (("untuned", kern), ("tuned", tuned), ("tuned", tuned),
                    ("untuned", kern)):
        served.setdefault(name, []).append(serve(kidx, hq, hgt, s)[1])
    counts = ops.launch_counts()
    for name in ("fused_expand", "gather_dist"):
        assert counts[name] > 0, counts
    rep["early_term"] = dict(
        configs_measured=len(ev.cache), seconds=et_s, floor=floor,
        no_et=dict(recall=rec0, hops=hops0),
        tuned=dict(recall=rec_t, hops=hops_t, t_frac=tuned.et_t_frac,
                   patience=tuned.et_patience, early_term=tuned.early_term),
        untuned=dict(t_frac=kern.et_t_frac, patience=kern.et_patience,
                     early_term=kern.early_term),
        holdout=served, launches=counts)
    for name, rows in served.items():
        log(f"[tuner] {name} on the other {len(hq)} queries, in turns: "
            f"recall@10 {rows[0]['recall']:.4f}, hops/q "
            f"{rows[0]['hops_per_query']:.1f}, QPS "
            + " / ".join(f"{r['qps']:.0f}" for r in rows))

    # (b) the quant-kind sweep over the registry on the built graph
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    best, qrows = tune.tune_quant_kind(kidx, tq, tgt, pq_m=16)
    sync()
    qk_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    for name in ("fused_expand_sq", "fused_expand_pq", "fused_expand_pq4",
                 "fused_expand_bin", "fused_expand"):
        assert counts[name] > 0, counts
    rep["quant_kind"] = dict(best=best, rows=qrows, seconds=qk_s,
                             launches=counts)
    log(f"[tuner] tune_quant_kind(pq_m=16), {qk_s:.1f} s: chose {best}; "
        + ", ".join(f"{r['quant']} {r['recall']:.4f} ({r['code_bytes']} B)"
                    for r in qrows))
    del kidx
    torch.cuda.empty_cache()

    # (c) the full-knob tuner over the IVF kinds at 1M
    n_half = len(ds.queries) // 2
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    res = tune.tune_config(ds.base, ds.queries, ds.gt_ids, metric=ds.metric,
                           index_type="ivf", k=10, recall_slo=TUNE_SLO,
                           dist_impl="kernel", device=DEVICE)
    sync()
    ivf_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    check_tune_result(res, "ivf")
    assert counts["gather_dist"] > 0 and sum(
        counts[k] for k in ("ivf_scan", "pq4_ivf_scan", "bin_ivf_scan")) > 0
    rep["ivf"] = tune_summary(res, ivf_s, counts)
    log(f"[tuner] tune_config ivf, n={len(ds.base)}, {n_half} + "
        f"{len(ds.queries) - n_half} queries, SLO {TUNE_SLO}, "
        f"{ivf_s:.1f} s: grid {res.grid_size}, deduped {res.n_deduped}, "
        f"measured {res.n_measured}; winner {json.dumps(rep['ivf']['winner'])}"
        f", recall tune {res.recall_tune:.4f}, holdout "
        f"{res.recall_holdout:.4f}; notes {res.notes}")
    torch.cuda.empty_cache()

    # (d) the full-knob tuner over the graph kinds at N_TUNE_GRAPH
    base = ds.base[:N_TUNE_GRAPH]
    ops.reset_launch_counts()
    t0 = time.perf_counter()
    gt = exact_topk_device(base, ds.queries, 10, ds.metric, DEVICE)
    res = tune.tune_config(base, ds.queries, gt, metric=ds.metric,
                           index_type="graph", k=10, recall_slo=TUNE_SLO,
                           dist_impl="kernel", device=DEVICE)
    sync()
    graph_s = time.perf_counter() - t0
    counts = ops.launch_counts()
    check_tune_result(res, "graph")
    assert counts["batch_dist"] > 0 and counts["gather_dist"] > 0, counts
    rep["graph"] = tune_summary(res, graph_s, counts)
    log(f"[tuner] tune_config graph, n={N_TUNE_GRAPH}, {graph_s:.1f} s "
        f"(ground truth included): grid {res.grid_size}, deduped "
        f"{res.n_deduped}, measured {res.n_measured}; winner "
        f"{json.dumps(rep['graph']['winner'])}, recall tune "
        f"{res.recall_tune:.4f}, holdout {res.recall_holdout:.4f}; notes "
        f"{res.notes}")
    for tag in ("ivf", "graph"):
        for r in rep[tag]["rows"]:
            log(f"[tuner {tag}] {r['kind']} L={r['L']} nprobe={r['nprobe']} "
                f"W={r['beam_width']} rf={r['rescore_factor']}: pred "
                f"{r['pred_us']:.2f} us/q, recall {r['recall']:.4f}, hops "
                f"{r['hops']:.1f}")
    torch.cuda.empty_cache()


# --------------------------------------------------------------------------
# phase 11
# --------------------------------------------------------------------------
def recsys_batch(cfg, B, g) -> dict:
    """A seeded serving batch of cfg's kind on the card (bert4rec's with
    its candidates)."""
    import torch

    def ints(hi, shape):
        return torch.randint(0, hi, shape, generator=g, device=g.device,
                             dtype=torch.int32)
    if cfg.kind in ("fm", "deepfm"):
        return {"sparse_ids": ints(cfg.vocab_per_field, (B, cfg.n_sparse))}
    if cfg.kind == "bst":
        return {"hist": ints(cfg.n_items, (B, cfg.seq_len)),
                "target": ints(cfg.n_items, (B,))}
    return {"seq": ints(cfg.n_items, (B, cfg.seq_len)),
            "cand": ints(cfg.n_items, (B,))}


def train_stream(cfg, B):
    """The pipeline's stream for cfg's kind (numpy; the Trainer moves each
    batch to the card)."""
    from repro_torch.data.pipeline import ctr_batches, seq_batches
    if cfg.kind in ("fm", "deepfm"):
        return ctr_batches(cfg.n_sparse, cfg.vocab_per_field, B)
    return seq_batches(cfg.kind, cfg.n_items, B, cfg.seq_len)


def train_run(cfg, B, params, ckpt_dir, data=None, **trainer_kw):
    """TRAIN_STEPS AdamW steps through the port's Trainer on the card,
    from `params` (untouched: updates are functional), on the pipeline's
    stream behind a Prefetcher unless `data` is given; returns the
    Trainer and fit's output."""
    from repro_torch.data.pipeline import Prefetcher
    from repro_torch.models import recsys as R
    from repro_torch.train.loop import Trainer, TrainerConfig
    from repro_torch.train.optimizer import OptConfig
    trainer = Trainer(lambda p, b: R.loss_fn(p, b, cfg), OptConfig(),
                      TrainerConfig(ckpt_dir=ckpt_dir, log_every=1,
                                    **trainer_kw), device=DEVICE)
    if data is None:
        data = Prefetcher(train_stream(cfg, B))
    return trainer, trainer.fit(params, data, n_steps=TRAIN_STEPS)


def recsys_train(tag, cfg, B, params) -> "tuple[dict, dict]":
    """One training run: its record and its output."""
    import numpy as np
    import torch
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    from repro_torch.train.tree import to_tensor
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        trainer, out = train_run(cfg, B, params, tmp)
        wall = time.perf_counter() - t0
    losses = [h["loss"] for h in out["history"]]
    assert [h["step"] for h in out["history"]] == list(range(TRAIN_STEPS))
    assert all(np.isfinite(losses)), (tag, losses)
    peak = (torch.cuda.max_memory_allocated() / 2 ** 30
            if DEVICE == "cuda" else 0.0)
    # the step alone: one batch already on the card, no data wait
    batch = {k: to_tensor(v, DEVICE)
             for k, v in next(train_stream(cfg, B)).items()}
    dev_ms = cuda_ms(lambda: trainer.step_fn(out["params"], out["opt"],
                                             batch), reps=5, warmup=1)
    rec = dict(batch=B, step_ms=1e3 * float(np.median(
        [h["sec"] for h in out["history"][TRAIN_TIMED_FROM:]])),
        step_device_ms=dev_ms, peak_gib=peak, first_loss=losses[0],
        last_loss=losses[-1], wall_s=wall)
    log(f"[recsys {tag}] train B={B}: step {rec['step_ms']:.2f} ms (median "
        f"of steps {TRAIN_TIMED_FROM}-{TRAIN_STEPS - 1}, data wait "
        f"included; {dev_ms:.2f} ms on a batch already on the card), peak "
        f"{peak:.2f} GiB, loss {rec['first_loss']:.5f} -> "
        f"{rec['last_loss']:.5f}, {wall:.1f} s for {TRAIN_STEPS} steps and "
        f"the final save")
    return rec, out


def recsys_resume(cfg, B, params, full) -> dict:
    """bst's checkpoint and resume: a run that fails at RESUME_FAIL_AT
    after saves every RESUME_EVERY steps, then a resume to TRAIN_STEPS,
    held to the uninterrupted run `full` within RESUME_ATOL (the card's
    index backward may sum in another order), and one synchronous save
    and restore of the whole state, timed."""
    import itertools
    import torch
    from repro_torch.train import checkpoint as ck
    from repro_torch.train.loop import SimulatedFailure
    with tempfile.TemporaryDirectory() as tmp:
        t0 = time.perf_counter()
        try:
            train_run(cfg, B, params, tmp, fail_at_step=RESUME_FAIL_AT,
                      ckpt_every=RESUME_EVERY)
            raise AssertionError("the injected failure did not fire")
        except SimulatedFailure:
            pass
        last = ck.latest_step(tmp)
        assert last == RESUME_FAIL_AT // RESUME_EVERY * RESUME_EVERY, last
        _, out = train_run(cfg, B, params, tmp, ckpt_every=RESUME_EVERY,
                           data=itertools.islice(train_stream(cfg, B), last,
                                                 None))
        resume_s = time.perf_counter() - t0
        assert out["history"][0]["step"] == last
        state = {"params": out["params"], "opt": out["opt"]}
        sync()
        t0 = time.perf_counter()
        path = ck.save(f"{tmp}/timed", TRAIN_STEPS, state)
        save_ms = (time.perf_counter() - t0) * 1e3
        mib = sum(f.stat().st_size for f in Path(path).iterdir()) / 2 ** 20
        t0 = time.perf_counter()
        back = ck.restore(f"{tmp}/timed", TRAIN_STEPS, state, DEVICE)
        sync()
        restore_ms = (time.perf_counter() - t0) * 1e3
    from repro_torch.train.tree import leaves
    assert all(torch.equal(a, b) for a, b in zip(leaves(back),
                                                 leaves(state)))
    pairs = list(zip(leaves(out["params"]), leaves(full["params"])))
    diff = max(float((a - b).abs().max()) for a, b in pairs)
    bit_equal = all(torch.equal(a, b) for a, b in pairs)
    loss_diff = max(abs(a["loss"] - b["loss"]) for a, b in zip(
        out["history"], full["history"][last:]))
    rec = dict(fail_at=RESUME_FAIL_AT, resumed_from=last, resume_s=resume_s,
               params_max_abs_diff=diff, bit_equal=bit_equal,
               loss_max_abs_diff=loss_diff, save_ms=save_ms,
               restore_ms=restore_ms, ckpt_mib=mib)
    log(f"[recsys bst] resume: failed at step {RESUME_FAIL_AT}, resumed "
        f"from {last} to {TRAIN_STEPS} ({resume_s:.1f} s in all); params "
        f"against the uninterrupted run: max abs diff {diff:.3e} "
        f"(bit-equal {bit_equal}), losses {loss_diff:.3e}; save "
        f"{save_ms:.1f} ms, restore {restore_ms:.1f} ms, {mib:.1f} MiB")
    assert diff <= RESUME_ATOL and loss_diff <= RESUME_ATOL, rec
    return rec


def recsys_serve(tag, cfg, params, g) -> dict:
    """serve_step at serve_p99 and serve_bulk (cut for bert4rec)."""
    import torch
    from repro_torch.models import recsys as R
    rows = {}
    for B in (SERVE_P99, SERVE_BULK_B[cfg.kind]):
        batch = recsys_batch(cfg, B, g)
        out = R.serve_step(params, batch, cfg)
        assert out.shape == (B,) and bool(torch.isfinite(out).all()), tag
        ms = cuda_ms(lambda: R.serve_step(params, batch, cfg), reps=5)
        rows[B] = dict(ms=ms, rows_per_s=B / ms * 1e3)
        log(f"[recsys {tag}] serve_step B={B}: {ms:.3f} ms, "
            f"{B / ms * 1e3:,.0f} rows/s")
    return rows


def recsys_retrieval(tag, cfg, params, g) -> "tuple[dict, object]":
    """Exact retrieval over the 10^6 candidates: serve_retrieval on the
    batch_dist kernel against its plain path at Q=1 and Q=SERVE_P99, each
    path's ms; returns the rows and the Q=SERVE_P99 batch."""
    from repro_torch.kernels import ops
    from repro_torch.models import recsys as R
    rows, batch512 = {}, None
    n, d = R.candidate_table(params, cfg).shape
    for Q in (1, SERVE_P99):
        batch = recsys_batch(cfg, Q, g)
        before = ops.launch_counts()["batch_dist"]
        kd, ki = R.serve_retrieval(params, batch, cfg, k=RETRIEVAL_K,
                                   use_kernel=True)
        launches = ops.launch_counts()["batch_dist"] - before
        pd, pi = R.serve_retrieval(params, batch, cfg, k=RETRIEVAL_K)
        ok, err = close(kd, pd)
        ids_ok, n_sep = separated_ids_equal((kd, ki), (pd, pi))
        assert launches == 1 and ok and ids_ok, (tag, Q, launches, err)
        assert bool(((ki >= 0) & (ki < n)).all()), tag
        # ATOL lies above fm's whole range of distances (tables at scale
        # 0.01): hold the error to RTOL of the distances' own scale as
        # well, and the ids wherever neighbours lie apart by more than
        # twice the error measured
        scale = float(pd.abs().max())
        ids_ok, n_apart = separated_ids_equal((kd, ki), (pd, pi), 2 * err)
        assert err <= RTOL * scale and ids_ok, (tag, Q, err, scale)
        kms = cuda_ms(lambda: R.serve_retrieval(
            params, batch, cfg, k=RETRIEVAL_K, use_kernel=True), reps=5)
        pms = cuda_ms(lambda: R.serve_retrieval(
            params, batch, cfg, k=RETRIEVAL_K), reps=5)
        rows[Q] = dict(d=d, kernel_ms=kms, plain_ms=pms, max_abs_err=err,
                       dist_scale=scale, separated_ids=n_sep,
                       ids_apart=n_apart)
        log(f"[recsys {tag}] retrieval Q={Q} x {n:,}, d={d}, "
            f"k={RETRIEVAL_K}: kernel path {kms:.3f} ms, plain {pms:.3f} "
            f"ms, max err {err:.2e} (distances up to {scale:.2e}); ids "
            f"equal on the {n_sep} slots apart by ATOL and the {n_apart} "
            f"apart by twice the error, of {ki.numel()}")
        if Q == SERVE_P99:
            batch512 = batch
    return rows, batch512


def recsys_ann(cfg, params, batch) -> dict:
    """The reference example (examples/retrieval_recsys.py) at full width:
    a KBest graph over the first RECSYS_ANN_N rows of bst's item table (d
    = 32; ip, exact kNN builder, M=24, knn_k=32, L=64, early termination
    on), searched with the query vectors of a serving batch; recall@10
    against the exact top-10 of those rows."""
    import numpy as np
    import torch
    from repro_torch.core.build import stable_topk_smallest
    from repro_torch.core.index import KBest
    from repro_torch.core.types import BuildConfig, IndexConfig, SearchConfig
    from repro_torch.data.vectors import recall_at_k
    from repro_torch.kernels import ops
    from repro_torch.models import recsys as R
    corpus = R.candidate_table(params, cfg)[:RECSYS_ANN_N].contiguous()
    q = R.query_vector(params, batch, cfg).detach().contiguous()
    exact_ids = stable_topk_smallest(-(q @ corpus.T), 10)[1]
    icfg = IndexConfig(
        dim=corpus.shape[1], metric="ip",
        build=BuildConfig(M=24, knn_k=32, builder="brute", refine_iters=1),
        search=SearchConfig(L=64, k=10, early_term=True, dist_impl="kernel"))
    before = ops.launch_counts()
    t0 = time.perf_counter()
    idx = KBest(icfg, device=DEVICE).add(corpus.cpu().numpy(),
                                         timings=StageLog("ann"))
    sync()
    build_s = time.perf_counter() - t0
    idx.search(q, search_cfg=icfg.search)                       # warm
    sync()
    t0 = time.perf_counter()
    _, ids = idx.search(q, search_cfg=icfg.search)
    sync()
    wall = time.perf_counter() - t0
    after = ops.launch_counts()
    ids = ids.cpu().numpy()
    assert ((ids >= 0) & (ids < corpus.shape[0])).all()
    recall = recall_at_k(ids, exact_ids.cpu().numpy(), 10)
    rec = dict(build_s=build_s, recall_at_10=recall, qps=len(q) / wall,
               queries=len(q), stages={k: round(v, 3)
                                       for k, v in idx.build_times.items()},
               launches={k: after[k] - before[k] for k in after
                         if after[k] > before[k]})
    log(f"[recsys ann] KBest over bst's {corpus.shape[0]:,} x "
        f"{corpus.shape[1]} item table: build {build_s:.1f} s, recall@10 "
        f"{recall:.4f} against the exact top-10 of {len(q)} queries, "
        f"{rec['qps']:,.0f} QPS (W=1, L=64); launches {rec['launches']}")
    assert recall > 0, rec
    del idx
    return rec


def phase_recsys():
    """The RecSys family at full width: each arch's full_config() trained
    (20 AdamW steps through the Trainer), bst's resume after an injected
    failure, serve_step at serve_p99 and serve_bulk, exact retrieval on
    batch_dist against the plain path at Q=1 and 512, and the ANN
    retrieval over bst's item table."""
    import torch
    from repro_torch import configs as reg
    from repro_torch.models import recsys as R
    from repro_torch.kernels import ops
    rep = REPORT["recsys"] = {}
    g = torch.Generator(device=DEVICE).manual_seed(24)
    before = ops.launch_counts()["batch_dist"]
    for i, arch in enumerate(RECSYS_ARCHS):
        cfg = reg.get(arch).full_config()
        params = R.init_params(
            cfg, torch.Generator(device=DEVICE).manual_seed(i))
        row = rep[arch] = dict(params=R.n_params(params))
        log(f"[recsys {arch}] full_config: {row['params']:,} params")
        row["train"], out = recsys_train(arch, cfg, TRAIN_B[arch], params)
        if arch == "bst":
            row["resume"] = recsys_resume(cfg, TRAIN_B[arch], params, out)
        del out
        if arch == "bert4rec":
            mcfg = dataclasses.replace(cfg, masked_positions=B4R_MASKED_P)
            row["train_masked"], out = recsys_train(
                f"{arch} masked P={B4R_MASKED_P}", mcfg, B4R_MASKED_B,
                params)
            del out
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
        row["serve"] = recsys_serve(arch, cfg, params, g)
        row["retrieval"], batch = recsys_retrieval(arch, cfg, params, g)
        if arch == "bst":
            row["ann"] = recsys_ann(cfg, params, batch)
        del params
        if DEVICE == "cuda":
            torch.cuda.empty_cache()
    # the exact retrievals (checked and timed) and the ANN build's kNN;
    # none of these count in the main path's launches (phase 4)
    rep["batch_dist_launches"] = ops.launch_counts()["batch_dist"] - before
    log(f"[recsys] batch_dist launches in this phase: "
        f"{rep['batch_dist_launches']}")
    assert rep["batch_dist_launches"] > 0


# --------------------------------------------------------------------------
# phase 12
# --------------------------------------------------------------------------
def reset_peak():
    import torch
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()


def peak_gib() -> float:
    import torch
    return (torch.cuda.max_memory_allocated() / 2 ** 30
            if DEVICE == "cuda" else 0.0)


def free_card():
    import gc
    import torch
    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()


def within(out, exp, of_scale, rtol=1e-5) -> "tuple[bool, float]":
    """The CPU tests' bound, on the host: |out - exp| <= rtol |exp| +
    of_scale * max|exp| everywhere; returns (ok, max error over max|exp|)."""
    a = out.detach().float().cpu()
    b = exp.detach().float().cpu()
    assert a.shape == b.shape, (a.shape, b.shape)
    scale = float(b.abs().max()) if b.numel() else 0.0
    diff = (a - b).abs()
    ok = bool((diff <= rtol * b.abs() + of_scale * scale).all())
    err = float(diff.max()) if diff.numel() else 0.0
    return ok, err / (scale or 1.0)


def weight_bytes(tree) -> int:
    from repro_torch.train.tree import leaves
    return sum(t.numel() * t.element_size() for t in leaves(tree))


def check_parity(tag, pairs, fails) -> dict:
    """Each (name, card tensor, host tensor) within PARITY_OF_SCALE (a
    gradient, "grad:<path>", within PARITY_GRAD_OF_SCALE); failures go to
    `fails`; returns {name: error over scale}, the gradients' largest."""
    errs = {}
    for name, card, host in pairs:
        key = name.split(":")[0]
        bound = PARITY_GRAD_OF_SCALE if key == "grad" else PARITY_OF_SCALE
        ok, err = within(card, host, bound)
        errs[key] = max(errs.get(key, 0.0), err)
        if not ok:
            fails.append(f"{tag} {name}: {err:.3e} of scale > {bound:g}")
    return errs


def lm_parity(name, fails) -> dict:
    """A smoke config on the card against the port on the host, same
    params: forward, loss_fn, every gradient, prefill, four decode steps;
    for an MoE config also the routing and the kept sets."""
    import numpy as np
    import torch
    from repro_torch import configs as reg
    from repro_torch.layers import moe as MOE
    from repro_torch.models import transformer as T
    from repro_torch.train.tree import (leaves_with_path, path_key,
                                        tree_map, unflatten)
    cfg = reg.get(name).smoke_config()
    host = T.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 17)).astype(np.int32))
    outs = {}
    for where, dev in (("host", "cpu"), ("card", DEVICE)):
        p = tree_map(lambda t: t.to(dev), host)
        tk = toks.to(dev)
        o = outs[where] = {}
        o["logits"], _ = T.forward(p, tk[:, :-1], cfg)
        req = [t.clone().requires_grad_(True) for _, t in leaves_with_path(p)]
        o["loss"], m = T.loss_fn(unflatten(p, req), {"tokens": tk}, cfg)
        o["nll"], o["aux"] = m["nll"], m["aux"]
        for (path, _), g in zip(leaves_with_path(p),
                                torch.autograd.grad(o["loss"], req)):
            o[f"grad:{path_key(path)}"] = g
        o["prefill"], pc = T.prefill(p, tk[:, :9], cfg)
        o["prefill_k"], o["prefill_v"] = pc["k"], pc["v"]
        cache = T.init_cache(cfg, 2, 16, dtype=torch.float32, device=dev)
        steps = []
        for s in range(4):
            lg, cache = T.decode_step(p, cache, tk[:, s:s + 1], cfg)
            steps.append(lg)
        o["decode"] = torch.cat(steps, dim=1)
        o["cache_k"], o["cache_v"] = cache["k"], cache["v"]
        assert int(cache["len"][0]) == 4
        if cfg.moe is not None:
            x = torch.from_numpy(np.random.default_rng(1).normal(
                size=(32, cfg.d_model)).astype(np.float32)).to(dev)
            p0 = {k: t[0] for k, t in p["layers"]["moe"].items()}
            _, w, eidx = MOE.route(p0, x, cfg.moe)
            dp = MOE.dispatch(w, eidx, cfg.moe.n_experts,
                              MOE.capacity(32, cfg.moe))
            o["route"] = (eidx.cpu(), dp.keep.cpu(), dp.slot.cpu(),
                          dp.buf_tok.cpu())
    h, c = outs["host"], outs["card"]
    pairs = [(k, c[k], h[k]) for k in h if k != "route"]
    errs = check_parity(f"[models parity {name}]", pairs, fails)
    if cfg.moe is not None:
        same = all(torch.equal(a, b) for a, b in zip(c["route"], h["route"]))
        errs["kept_sets_equal"] = same
        if not same:
            fails.append(f"[models parity {name}] top-k, keep or slot differ")
    log(f"[models parity {name}] card vs host, error over scale: " + ", ".join(
        f"{k} {v:.2e}" if isinstance(v, float) else f"{k} {v}"
        for k, v in errs.items()))
    return errs


def gnn_parity(fails) -> dict:
    """DimeNet's smoke config on the card against the host: forward, loss
    and every gradient, node classification on a sampled subgraph and
    graph regression on a molecule batch."""
    import torch
    from repro_torch import configs as reg
    from repro_torch.data.pipeline import gnn_minibatches, molecule_batches
    from repro_torch.models import dimenet as D
    from repro_torch.train.tree import (leaves_with_path, path_key,
                                        to_tensor, tree_map, unflatten)
    out = {}
    for task in ("node_clf", "graph_reg"):
        cfg = reg.get("dimenet").smoke_config()
        if task == "graph_reg":
            cfg = dataclasses.replace(cfg, task=task, n_out=1)
            batch, ng = next(molecule_batches(6, 12, 4, cfg.d_feat)), 4
        else:
            batch, ng = next(gnn_minibatches(500, cfg.d_feat, 8, (3, 2),
                                             cfg.n_out, triplet_cap=4)), 1
        host = D.init_params(cfg, torch.Generator().manual_seed(0))
        outs = {}
        for where, dev in (("host", "cpu"), ("card", DEVICE)):
            p = tree_map(lambda t: t.to(dev), host)
            b = {k: to_tensor(v, dev) for k, v in batch.items()}
            o = outs[where] = {"forward": D.forward(p, b, cfg, ng)}
            req = [t.clone().requires_grad_(True)
                   for _, t in leaves_with_path(p)]
            o["loss"], _ = D.loss_fn(unflatten(p, req), b, cfg, ng)
            for (path, _), g in zip(leaves_with_path(p),
                                    torch.autograd.grad(o["loss"], req)):
                o[f"grad:{path_key(path)}"] = g
        h, c = outs["host"], outs["card"]
        out[task] = check_parity(f"[models parity dimenet {task}]",
                                 [(k, c[k], h[k]) for k in h], fails)
        log(f"[models parity dimenet {task}] card vs host, error over "
            f"scale: " + ", ".join(f"{k} {v:.2e}"
                                   for k, v in out[task].items()))
    return out


def lm_full_config(name):
    """The arch's full_config(), its depth cut to LM_LAYERS where one card
    forces it."""
    from repro_torch import configs as reg
    cfg = reg.get(name).full_config()
    if name in LM_LAYERS:
        cfg = dataclasses.replace(cfg, n_layers=LM_LAYERS[name])
    return cfg


def decode_floor_bytes(cfg, params, B, start, steps) -> float:
    """What one decode step must read, on average over the run: every
    weight (an MoE step's batched expert GEMMs read all experts) except the
    untied embedding table, of which B rows; and the K/V of the positions
    it attends to."""
    emb = params["embed"]
    w = weight_bytes(params)
    if not cfg.tie_embeddings:
        w -= emb.numel() * emb.element_size()
        w += B * emb.shape[1] * emb.element_size()
    mean_len = start + (steps + 1) / 2
    kv = (2 * cfg.n_layers * B * mean_len * cfg.n_kv_heads * cfg.hd
          * params["embed"].element_size())
    return w + kv


def lm_full(i, name, fails) -> dict:
    """One LM arch at full width (bf16, seeded weights): prefill,
    DECODE_STEPS decode steps from a 32k cache, and (dense archs) prefill
    + decode held to a forward over the same tokens."""
    import torch
    from repro_torch import configs as reg
    from repro_torch.models import transformer as T
    cfg = lm_full_config(name)
    full_layers = reg.get(name).full_config().n_layers
    gen = torch.Generator(device=DEVICE).manual_seed(200 + i)
    t0 = time.perf_counter()
    params = T.init_params(cfg, gen)
    sync()
    row = dict(arch=cfg.name, params=T.n_params(params),
               weight_gb=weight_bytes(params) / 1e9, layers=cfg.n_layers,
               layers_full=full_layers,
               init_s=time.perf_counter() - t0)
    if cfg.n_layers < full_layers:
        row["reduced"] = [f"n_layers {cfg.n_layers} of {full_layers} "
                          f"(one 80 GB card)"]
    log(f"[models {name}] {row['params']:,} params ({row['weight_gb']:.2f} "
        f"GB bf16), {cfg.n_layers} of {full_layers} layers, drawn in "
        f"{row['init_s']:.1f} s")

    # prefill, B=1
    S = LM_PREFILL_S.get(name, PREFILL_S)
    toks = torch.randint(0, cfg.vocab, (1, S), generator=gen, device=DEVICE)
    T.prefill(params, toks[:, :64], cfg)                        # warm
    free_card()
    reset_peak()
    sync()
    t0 = time.perf_counter()
    lg, pc = T.prefill(params, toks, cfg)
    sync()
    ms = (time.perf_counter() - t0) * 1e3
    assert lg.shape == (1, 1, cfg.vocab) and bool(torch.isfinite(lg).all())
    assert pc["k"].shape == (cfg.n_layers, 1, S, cfg.n_kv_heads, cfg.hd)
    row["prefill"] = dict(S=S, ms=ms, tokens_per_s=S / ms * 1e3,
                          peak_gib=peak_gib())
    del lg, pc
    free_card()
    log(f"[models {name}] prefill B=1 S={S}: {ms:.1f} ms, "
        f"{S / ms * 1e3:,.0f} tokens/s, peak {row['prefill']['peak_gib']:.2f}"
        f" GiB")

    # decode from a cache of DECODE_MAX_LEN, the last DECODE_STEPS new
    B = LM_DECODE_B.get(name, DECODE_B)
    start = DECODE_MAX_LEN - DECODE_STEPS
    cache = T.init_cache(cfg, B, DECODE_MAX_LEN, device=DEVICE)
    cache["k"].normal_(generator=gen)
    cache["v"].normal_(generator=gen)
    tok = torch.randint(0, cfg.vocab, (B, 1), generator=gen, device=DEVICE)
    state = {}

    def run(n):
        cache["len"].fill_(start)
        lg, c = T.decode_step(params, cache, tok, cfg)
        for _ in range(n - 1):
            lg, c = T.decode_step(params, c, torch.argmax(lg[:, -1:], dim=-1),
                                  cfg)
        state.update(logits=lg, len=c["len"])

    run(2)                                                      # warm
    reset_peak()
    sync()
    a = torch.cuda.Event(enable_timing=True) if DEVICE == "cuda" else None
    b = torch.cuda.Event(enable_timing=True) if DEVICE == "cuda" else None
    t0 = time.perf_counter()
    if a is not None:
        a.record()
    run(DECODE_STEPS)
    if b is not None:
        b.record()
    sync()
    wall = (time.perf_counter() - t0) * 1e3 / DECODE_STEPS
    ms = a.elapsed_time(b) / DECODE_STEPS if a is not None else wall
    assert int(state["len"][0]) == DECODE_MAX_LEN
    assert bool(torch.isfinite(state["logits"]).all())
    peak = peak_gib()
    dev_ms, busy_wall = device_busy(lambda: run(BUSY_STEPS))
    floor = decode_floor_bytes(cfg, params, B, start, DECODE_STEPS)
    row["decode"] = dict(
        B=B, context=DECODE_MAX_LEN, steps=DECODE_STEPS, ms_per_token=ms,
        tokens_per_s=B / ms * 1e3, peak_gib=peak,
        busy_share=dev_ms / busy_wall if busy_wall else 0.0,
        floor_gb=floor / 1e9, floor_ms=floor / PEAK_BYTES * 1e3)
    d = row["decode"]
    log(f"[models {name}] decode B={B} from {start:,} of {DECODE_MAX_LEN:,}"
        f" positions, {DECODE_STEPS} steps: {ms:.2f} ms/token ({wall:.2f} "
        f"on the host clock), {d['tokens_per_s']:,.0f} tokens/s; memory "
        f"floor {d['floor_gb']:.2f} GB a step = {d['floor_ms']:.2f} ms "
        f"({d['floor_ms'] / ms:.1%} of the step); peak {peak:.2f} GiB; "
        f"busy {d['busy_share']:.1%} of {BUSY_STEPS} steps under the "
        f"profiler")
    del cache, state
    free_card()

    # prefill + decode against a forward over the same tokens
    toks = torch.randint(0, cfg.vocab, (1, CONSIST_T), generator=gen,
                         device=DEVICE)
    with torch.no_grad():
        full, _ = T.forward(params, toks, cfg)
    lg, pc = T.prefill(params, toks[:, :CONSIST_PREFILL], cfg)
    cache = T.init_cache(cfg, 1, CONSIST_T, device=DEVICE)
    cache["k"][:, :, :CONSIST_PREFILL] = pc["k"]
    cache["v"][:, :, :CONSIST_PREFILL] = pc["v"]
    cache["len"].fill_(CONSIST_PREFILL)
    steps = [lg]
    for s in range(CONSIST_PREFILL, CONSIST_T):
        lg, cache = T.decode_step(params, cache, toks[:, s:s + 1], cfg)
        steps.append(lg)
    got = torch.cat(steps, dim=1)
    exp = full[:, CONSIST_PREFILL - 1:]
    scale = float(exp.abs().max())
    err = float((got - exp).abs().max()) / scale
    row["consistency"] = dict(T=CONSIST_T, prefill=CONSIST_PREFILL,
                              err_of_scale=err, logit_scale=scale,
                              asserted=cfg.moe is None)
    log(f"[models {name}] prefill {CONSIST_PREFILL} + "
        f"{CONSIST_T - CONSIST_PREFILL} decode steps against a forward "
        f"over {CONSIST_T}: max error {err:.3e} of the logits' scale "
        f"{scale:.3f}" + ("" if cfg.moe is None else
                          " (MoE: reported only, capacity differs)"))
    if cfg.moe is None and not err <= CONSIST_BOUND:
        fails.append(f"[models {name}] consistency {err:.3e} > "
                     f"{CONSIST_BOUND}")
    del params, cache, full, pc
    free_card()
    return row


def lm_train(name, layers, S) -> dict:
    """TRAIN_STEPS AdamW steps of the Trainer's step (donated buffers: the
    params and moments update in place) at B=1 x S on lm_batches."""
    import numpy as np
    import torch
    from repro_torch import configs as reg
    from repro_torch.data.pipeline import lm_batches
    from repro_torch.models import transformer as T
    from repro_torch.train.loop import Trainer, TrainerConfig
    from repro_torch.train.optimizer import OptConfig, opt_init
    from repro_torch.train.tree import to_tensor
    cfg = reg.get(name).full_config()
    full_layers = cfg.n_layers
    if layers:
        cfg = dataclasses.replace(cfg, n_layers=layers)
    params = T.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(7))
    opt_cfg = OptConfig()
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(lambda p, b: T.loss_fn(p, b, cfg), opt_cfg,
                          TrainerConfig(ckpt_dir=tmp), device=DEVICE,
                          donate=True)
        opt = opt_init(params, opt_cfg)
        data = lm_batches(cfg.vocab, 1, S)
        reset_peak()
        losses, secs = [], []
        for _ in range(TRAIN_STEPS):
            batch = {k: to_tensor(v, DEVICE) for k, v in next(data).items()}
            t0 = time.perf_counter()
            params, opt, m = trainer.step_fn(params, opt, batch)
            losses.append(float(m["loss"]))        # the step's host sync
            secs.append(time.perf_counter() - t0)
    assert all(np.isfinite(losses)), (name, losses)
    step_ms = 1e3 * float(np.median(secs[TRAIN_TIMED_FROM:]))
    rec = dict(arch=cfg.name, params=T.n_params(params), layers=cfg.n_layers,
               layers_full=full_layers, B=1, S=S, steps=TRAIN_STEPS,
               step_ms=step_ms, tokens_per_s=S / step_ms * 1e3,
               peak_gib=peak_gib(), first_loss=losses[0],
               last_loss=losses[-1], losses=losses)
    if cfg.n_layers < full_layers:
        rec["reduced"] = [f"n_layers {cfg.n_layers} of {full_layers} (one "
                          f"80 GB card: weights, grads and AdamW moments)"]
    log(f"[models train {name}] {rec['params']:,} params, {cfg.n_layers} "
        f"of {full_layers} layers, B=1 x S={S}: step {step_ms:.1f} ms "
        f"(median of steps {TRAIN_TIMED_FROM}-{TRAIN_STEPS - 1}), "
        f"{rec['tokens_per_s']:,.0f} tokens/s, peak {rec['peak_gib']:.2f} "
        f"GiB, loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    del params, opt, trainer, m
    free_card()
    return rec


def gnn_run(tag, cfg, stream, n_graphs, fails) -> dict:
    """One batch's forward on the card against the host (same params),
    then TRAIN_STEPS AdamW steps through the Trainer on the stream."""
    import itertools
    import numpy as np
    import torch
    from repro_torch.data.pipeline import Prefetcher
    from repro_torch.models import dimenet as D
    from repro_torch.train.loop import Trainer, TrainerConfig
    from repro_torch.train.optimizer import OptConfig
    from repro_torch.train.tree import to_tensor, tree_map
    first = next(stream)
    params = D.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(9))
    host = tree_map(lambda t: t.cpu(), params)
    batch = {k: to_tensor(v, DEVICE) for k, v in first.items()}
    with torch.no_grad():
        card_out = D.forward(params, batch, cfg, n_graphs)
        host_out = D.forward(host, {k: to_tensor(v, "cpu")
                                    for k, v in first.items()}, cfg, n_graphs)
    ok, err = within(card_out, host_out, GNN_OF_SCALE)
    if not ok:
        fails.append(f"[models dimenet {tag}] forward {err:.3e} of scale > "
                     f"{GNN_OF_SCALE:g}")
    reset_peak()
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(lambda p, b: D.loss_fn(p, b, cfg, n_graphs),
                          OptConfig(), TrainerConfig(ckpt_dir=tmp,
                                                     log_every=1),
                          device=DEVICE)
        t0 = time.perf_counter()
        out = trainer.fit(params, Prefetcher(itertools.chain([first],
                                                             stream)),
                          n_steps=TRAIN_STEPS)
        wall = time.perf_counter() - t0
    losses = [h["loss"] for h in out["history"]]
    assert len(losses) == TRAIN_STEPS and all(np.isfinite(losses)), losses
    dev_ms = cuda_ms(lambda: trainer.step_fn(out["params"], out["opt"],
                                             batch), reps=5, warmup=1)
    n_edges = int((first["edge_src"] >= 0).sum())
    n_trip = int((first["trip_kj"] >= 0).sum())
    rec = dict(nodes=int(first["feats"].shape[0]), edges=n_edges,
               triplets=n_trip, params=D.n_params(params),
               forward_err_of_scale=err,
               step_ms=1e3 * float(np.median(
                   [h["sec"] for h in out["history"][TRAIN_TIMED_FROM:]])),
               step_device_ms=dev_ms, peak_gib=peak_gib(), wall_s=wall,
               first_loss=losses[0], last_loss=losses[-1])
    log(f"[models dimenet {tag}] {rec['nodes']:,} nodes, {n_edges:,} edges, "
        f"{n_trip:,} triplets a batch; forward card vs host {err:.2e} of "
        f"scale; step "
        f"{rec['step_ms']:.1f} ms with the data wait, {dev_ms:.2f} ms on a "
        f"batch on the card; peak {rec['peak_gib']:.2f} GiB; loss "
        f"{losses[0]:.4f} -> {losses[-1]:.4f}; {wall:.1f} s for "
        f"{TRAIN_STEPS} steps")
    del out, trainer, params
    free_card()
    return rec


def launchers_on_card() -> dict:
    """The launchers' LM and GNN modes with their default device (the
    card): `serve --mode lm` and `train --arch dimenet --smoke`."""
    from repro_torch.launch import serve as serve_launch
    from repro_torch.launch import train as train_launch
    ms = serve_launch.serve_lm("gemma-2b")
    with tempfile.TemporaryDirectory() as tmp:
        rc = train_launch.main(["--arch", "dimenet", "--smoke", "--steps",
                                "3", "--ckpt", tmp])
    assert rc == 0
    return dict(serve_lm_smoke_ms_per_token=ms)


def phase_models():
    """The LM and GNN families: (a) each smoke config on the card against
    the host, (b) the five LM archs at full width (prefill, decode from a
    32k cache, prefill + decode against a forward), (c) AdamW training of
    gemma-2b and llama4-scout, (d) DimeNet's molecule and minibatch_lg
    shapes trained, (e) the launchers' LM and GNN modes on the card."""
    import itertools
    import torch
    from repro_torch import configs as reg
    from repro_torch.data.pipeline import gnn_minibatches, molecule_batches
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    rep = REPORT["models"] = {}
    fails: list = []
    t0 = time.perf_counter()
    rep["parity"] = {name: lm_parity(name, fails) for name in LM_ARCHS}
    rep["parity"]["dimenet"] = gnn_parity(fails)
    rep["parity_s"] = time.perf_counter() - t0
    free_card()
    rep["lm"] = {name: lm_full(i, name, fails)
                 for i, name in enumerate(LM_ARCHS)}
    rep["train"] = {name: lm_train(name, layers, S)
                    for name, layers, S in LM_TRAIN}
    mod = reg.get("dimenet")
    atoms, edges, mols, d_feat = GNN_MOLECULE
    mcfg = mod.full_config("molecule")
    sp = mod.SHAPE_PARAMS["minibatch_lg"]
    gcfg = mod.full_config("minibatch_lg")
    rep["gnn"] = {"molecule": gnn_run("molecule", mcfg, molecule_batches(
        atoms, edges, mols, d_feat), mols, fails)}
    t0 = time.perf_counter()
    drawn = list(itertools.islice(gnn_minibatches(
        GNN_MINIBATCH_NODES, gcfg.d_feat, sp["batch_nodes"], sp["fanouts"],
        gcfg.n_out), GNN_MINIBATCH_BATCHES))
    synth_s = time.perf_counter() - t0
    log(f"[models dimenet minibatch_lg] {GNN_MINIBATCH_BATCHES} batches over "
        f"a {GNN_MINIBATCH_NODES:,}-node graph drawn in {synth_s:.1f} s")
    rec = rep["gnn"]["minibatch_lg"] = gnn_run(
        "minibatch_lg", gcfg, itertools.cycle(drawn), 1, fails)
    rec["synth_s"] = synth_s
    rec["reduced"] = [f"{TRAIN_STEPS} steps cycle over "
                      f"{GNN_MINIBATCH_BATCHES} batches drawn ahead"]
    if GNN_MINIBATCH_NODES < sp["n_nodes"]:
        rec["reduced"].append(
            f"graph nodes {GNN_MINIBATCH_NODES} of {sp['n_nodes']}")
    del drawn
    rep["launchers"] = launchers_on_card()
    if fails:
        raise AssertionError("phase models: " + "; ".join(fails))


# --------------------------------------------------------------------------
# phase 13
# --------------------------------------------------------------------------
def mesh_search(mesh, idx, ds) -> dict:
    """(a) build_sharded_search over phase 4's Deep1M graph as one shard,
    on the gather_dist kernel, every batch of queries at W=4 and W=1: ids
    and distances bit-equal to `search` on the same arrays (the P=1
    merge is the identity), recall@10 of the ids mapped through the
    index's order, and the sharded call's QPS."""
    import numpy as np
    import torch
    from repro_torch.core import search as S
    from repro_torch.core.sharded import (build_sharded_search,
                                          make_sharded_arrays)
    from repro_torch.data.vectors import recall_at_k
    from repro_torch.kernels import ops
    rep = {}
    n = idx.db.shape[0]
    t0 = time.perf_counter()
    db, graph, entries, queries = make_sharded_arrays(
        mesh, idx.db.cpu().numpy(), idx.graph.cpu().numpy(),
        np.asarray([idx.entry], np.int32), ds.queries)
    rep["arrays_s"] = time.perf_counter() - t0
    order = (torch.arange(n, device=db.device) if idx.order is None else
             torch.as_tensor(idx.order, device=db.device).long())
    for W in (4, 1):
        scfg = dataclasses.replace(idx.config.search, L=MAIN_L, beam_width=W,
                                   dist_impl="kernel")
        fn = build_sharded_search(mesh, scfg, idx.config.metric, n)
        fn(db, graph, entries, queries[:BATCH])                 # warm
        before = ops.launch_counts()["gather_dist"]
        sync()
        t0 = time.perf_counter()
        outs = [fn(db, graph, entries, queries[s:s + BATCH])
                for s in range(0, len(queries), BATCH)]
        sync()
        wall = time.perf_counter() - t0
        launches = ops.launch_counts()["gather_dist"] - before
        dist_fn = S.make_dist_fn(db, idx.config.metric, "kernel")
        equal = True
        for s, (d, i) in zip(range(0, len(queries), BATCH), outs):
            d0, i0, _ = S.search(graph, queries[s:s + BATCH], entries,
                                 dist_fn=dist_fn, cfg=scfg, n_total=n)
            equal &= torch.equal(i, i0) and torch.equal(d, d0)
        ids = torch.cat([i for _, i in outs])
        user = torch.where(ids >= 0, order[ids.clamp(min=0)], -1)
        row = rep[f"W{W}"] = dict(
            qps=len(queries) / wall, launches=launches,
            recall=recall_at_k(user.cpu().numpy(), ds.gt_ids, 10),
            equal_to_search=bool(equal))
        log(f"[mesh] (a) sharded search, 1 shard of {n:,}, W={W}"
            f", L={MAIN_L}: {row['qps']:.0f} QPS, recall@10 "
            f"{row['recall']:.4f}, {launches} gather_dist launches; ids "
            f"and distances bit-equal to search: {equal}")
        assert equal and launches > 0, row
    return rep


def mesh_retrieval(mesh) -> dict:
    """(b) serve_retrieval_shardmap on batch_dist over bst's 10^6-item
    table at full_config() width, the one rank holding the whole table,
    against serve_retrieval (the same kernel: equal distances and ids; the
    plain path: the CPU tests' distance bound and ids equal where apart by
    twice the error), at Q=1 and Q=SERVE_P99, with both calls' ms."""
    import torch
    from repro_torch import configs as reg
    from repro_torch.kernels import ops
    from repro_torch.models import recsys as R
    rep = {}
    cfg = reg.get("bst").full_config()
    params = R.init_params(cfg, torch.Generator(device=DEVICE).manual_seed(2))
    g = torch.Generator(device=DEVICE).manual_seed(25)
    n = R.candidate_table(params, cfg).shape[0]
    for Q in (1, SERVE_P99):
        batch = recsys_batch(cfg, Q, g)
        before = ops.launch_counts()["batch_dist"]
        sd, si = R.serve_retrieval_shardmap(params, batch, cfg, mesh,
                                            k=RETRIEVAL_K, use_kernel=True)
        launches = ops.launch_counts()["batch_dist"] - before
        kd, ki = R.serve_retrieval(params, batch, cfg, k=RETRIEVAL_K,
                                   use_kernel=True)
        pd, pi = R.serve_retrieval(params, batch, cfg, k=RETRIEVAL_K)
        same = torch.equal(sd, kd) and torch.equal(si, ki)
        ok, err = close(sd, pd)
        ids_ok, n_apart = separated_ids_equal((sd, si), (pd, pi), 2 * err)
        row = rep[Q] = dict(
            launches=launches, equal_to_kernel_path=same, max_abs_err=err,
            ids_apart=n_apart,
            shardmap_ms=cuda_ms(lambda: R.serve_retrieval_shardmap(
                params, batch, cfg, mesh, k=RETRIEVAL_K, use_kernel=True),
                reps=5),
            serve_ms=cuda_ms(lambda: R.serve_retrieval(
                params, batch, cfg, k=RETRIEVAL_K, use_kernel=True), reps=5))
        log(f"[mesh] (b) serve_retrieval_shardmap Q={Q} x {n:,}: "
            f"{row['shardmap_ms']:.3f} ms (serve_retrieval "
            f"{row['serve_ms']:.3f}), {launches} batch_dist launch; equal "
            f"to serve_retrieval on the kernel: {same}; max err against "
            f"the plain path {err:.2e}, ids equal on the {n_apart} slots "
            f"apart by twice it")
        assert launches == 1 and same and ok and ids_ok, row
    return rep


def mesh_moe(mesh, fails) -> dict:
    """(c) moe_ffn_shardmap at ep = tp = 1 against moe_ffn: each MoE
    arch's f32 smoke layer (TF32 off since phase 1), forward, aux and
    every gradient of <out, g> + aux within phase 12 (a)'s bounds; one
    llama4-scout layer at full width in bf16 over LM_PREFILL_S tokens,
    its difference and both forwards' ms recorded."""
    import torch
    from repro_torch import configs as reg
    from repro_torch.launch.mesh import mesh_context
    from repro_torch.layers import moe as MOE
    rep = {}
    g = torch.Generator(device=DEVICE).manual_seed(26)

    def shardmap_cfg(moe):
        return dataclasses.replace(moe, ep_axis="data", tp_axis="model",
                                   token_axes=("data",), use_shardmap=True,
                                   ep_size=1, tp_size=1)

    for name in ("kimi_k2_1t_a32b", "llama4_scout_17b_a16e"):
        lm = reg.get(name).smoke_config()
        cfg = shardmap_cfg(lm.moe)
        p = MOE.init_moe(g, lm.d_model, cfg)
        x = torch.randn((64, lm.d_model), generator=g, device=DEVICE)
        gy = torch.randn((64, lm.d_model), generator=g, device=DEVICE)
        outs = []
        for sharded in (False, True):
            leaves = {k: v.clone().requires_grad_(True) for k, v in p.items()}
            xx = x.clone().requires_grad_(True)
            with mesh_context(mesh):
                o, aux = (MOE.moe_ffn_shardmap if sharded else MOE.moe_ffn)(
                    leaves, xx, cfg)
            names = sorted(leaves)
            grads = torch.autograd.grad(torch.sum(o * gy) + aux,
                                        [leaves[k] for k in names] + [xx])
            outs.append([("out", o), ("aux", aux)] + [
                (f"grad:{k}", t) for k, t in zip(names + ["x"], grads)])
        pairs = [(k, a, b) for (k, a), (_, b) in zip(outs[1], outs[0])]
        rep[name] = check_parity(f"mesh moe {name}", pairs, fails)
        log(f"[mesh] (c) moe_ffn_shardmap, {name} smoke layer f32 at ep=tp=1 "
            f"against moe_ffn, largest error over scale: {rep[name]}")

    lm = reg.get("llama4_scout_17b_a16e").full_config()
    cfg = shardmap_cfg(lm.moe)
    free_card()
    p = MOE.init_moe(g, lm.d_model, cfg, dtype=torch.bfloat16)
    T = LM_PREFILL_S["llama4_scout_17b_a16e"]
    x = torch.randn((T, lm.d_model), generator=g, device=DEVICE).to(
        torch.bfloat16)
    with torch.no_grad(), mesh_context(mesh):
        o0, a0 = MOE.moe_ffn(p, x, cfg)
        o1, a1 = MOE.moe_ffn_shardmap(MOE.local_moe_params(p, cfg), x, cfg)
        ok, err = within(o1, o0, PARITY_OF_SCALE)
        rep["llama4_full_bf16"] = dict(
            tokens=T, err_over_scale=err, aux_diff=abs(float(a1 - a0)),
            moe_ffn_ms=cuda_ms(lambda: MOE.moe_ffn(p, x, cfg), reps=5),
            shardmap_ms=cuda_ms(lambda: MOE.moe_ffn_shardmap(p, x, cfg),
                                reps=5))
    log(f"[mesh] (c) llama4-scout layer at full width (d={lm.d_model}, "
        f"E={cfg.n_experts}, f={cfg.d_ff_expert}), bf16, {T} tokens: "
        f"moe_ffn_shardmap vs moe_ffn {err:.3e} of scale, aux apart by "
        f"{rep['llama4_full_bf16']['aux_diff']:.3e}; "
        f"{rep['llama4_full_bf16']['shardmap_ms']:.2f} ms against "
        f"{rep['llama4_full_bf16']['moe_ffn_ms']:.2f}")
    del p, x
    free_card()
    return rep


def phase_mesh(idx, ds):
    """phase 13: the device mesh over NCCL, world size 1 (a file store in
    a temporary directory; one card takes one rank), make_test_mesh():
    (a) the sharded search on phase 4's graph, (b) the sharded retrieval,
    (c) the sharded MoE. Any failure raises."""
    from repro_torch.launch import mesh as M
    rep = REPORT["mesh"] = {}
    fails = []
    t0 = time.perf_counter()
    with M.process_group(DEVICE):
        mesh = M.make_test_mesh(DEVICE)
        rep["init_s"] = time.perf_counter() - t0
        log(f"[mesh] {M.backend(DEVICE)} group, world size 1, mesh "
            f"{mesh.shape} {mesh.mesh_dim_names}: {rep['init_s']:.1f} s")
        rep["search"] = mesh_search(mesh, idx, ds)
        rep["retrieval"] = mesh_retrieval(mesh)
        rep["moe"] = mesh_moe(mesh, fails)
    if fails:
        raise AssertionError("phase mesh: " + "; ".join(fails))


# --------------------------------------------------------------------------
# phase 14
# --------------------------------------------------------------------------
def dryrun_records(since: float) -> list:
    """The 80 baseline records of the dry-run (40 cells x 2 meshes), each
    written after `since`."""
    from repro_torch import configs as reg
    from repro_torch.launch import dryrun
    recs = []
    for arch, shape in reg.all_cells():
        for mesh_name in ("pod16x16", "pod2x16x16"):
            path = dryrun.ART_DIR / f"{arch}__{shape}__{mesh_name}.json"
            assert path.stat().st_mtime >= since, f"{path} is stale"
            rec = json.loads(path.read_text())
            assert rec["ok"] and rec["variant"] == "baseline", rec
            recs.append(rec)
    return recs


def alloc_slack(nbytes: int) -> int:
    """The most that PyTorch's caching allocator adds to memory_allocated
    for one tensor of `nbytes`: sizes round up to 512 B, and a block of
    the large pool (over 1 MiB) is split off its segment only when more
    than 1 MiB would be left, so up to 1 MiB of the segment's tail stays
    in the block."""
    return 511 if nbytes <= 1 << 20 else (1 << 20) + 511


def phase_shapes():
    """phase 14: the shape layer (sharding/rules, launch/specs,
    launch/dryrun) on the card, run once phase 13's NCCL group is gone.
    (a) the dry-run of the 40 cells on both production meshes, on its
    default device: `python -m repro_torch.launch.dryrun --all` and
    `--all --multi-pod` in two subprocesses at once (the 80 records of
    `--all --both-meshes`, which took 63.1 s in one process on the
    card's host, over the phase's 60 s), each mesh on the card over a
    `fake` process group, each step run once on meta tensors; every one
    of the 80 records must say ok.
    (b) The record with the largest per-rank argument bytes below half the
    card's free memory: that cell's per-rank shards allocated on the card
    with `torch.empty`; `memory_allocated` must grow by at least the
    record's bytes and by at most the allocator's rounding a leaf
    (`alloc_slack`), and its requested bytes by exactly the record's. Reports how many of the 80 cells' per-rank argument bytes
    fit in the card's total memory (temporaries not counted). Launches no
    kernel. Any failure raises."""
    import os
    import torch
    import torch.distributed as dist
    from repro_torch.kernels import ops
    from repro_torch.launch import dryrun
    from repro_torch.launch.specs import build_cell
    assert not dist.is_initialized(), "phase 13's process group is alive"
    rep = REPORT["shapes"] = {}
    counts = ops.launch_counts()
    t0 = time.time()
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--all"] + (
        [] if DEVICE == "cuda" else ["--device", DEVICE])
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    procs = [subprocess.Popen(cmd + flag, cwd=ROOT, env=env, text=True,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE)
             for flag in ([], ["--multi-pod"])]
    outs = [p.communicate(timeout=600) for p in procs]
    rep["dryrun_s"] = time.time() - t0
    ok_lines = [line for out, _ in outs for line in out.splitlines()
                if line.startswith("[ok]")]
    rcs = [p.returncode for p in procs]
    log(f"[shapes] (a) dryrun --all on each production mesh: "
        f"{len(ok_lines)} [ok] lines, exits {rcs}, {rep['dryrun_s']:.1f} s")
    assert rcs == [0, 0] and len(ok_lines) == 80, \
        "".join(out[-2000:] + err[-2000:] for out, err in outs)
    recs = dryrun_records(t0 - 1)
    rep["cell_s"] = {f"{r['arch']} {r['shape']} {r['mesh']}": r["seconds"]
                     for r in recs}

    free, total = torch.cuda.mem_get_info()
    nbytes = [r["memory_analysis"]["argument_bytes"] for r in recs]
    pick = max((r for r, b in zip(recs, nbytes) if b < free / 2),
               key=lambda r: r["memory_analysis"]["argument_bytes"])
    want = pick["memory_analysis"]["argument_bytes"]
    with dryrun.production_mesh(pick["mesh"] == "pod2x16x16",
                                DEVICE) as mesh:
        cell = build_cell(pick["arch"], pick["shape"], mesh)
        shards = [(sh.shard_shape(x.shape), x.dtype)
                  for x, sh in dryrun.argument_leaves(cell)]
        assert dryrun.argument_bytes(cell) == want
    leaf_bytes = [math.prod(shape) * dt.itemsize for shape, dt in shards]
    slack = sum(alloc_slack(b) for b in leaf_bytes)

    def stats():
        torch.cuda.synchronize()
        return (torch.cuda.memory_allocated(),
                torch.cuda.memory_stats()["requested_bytes.all.current"])

    before = stats()
    bufs = [torch.empty(shape, dtype=dt, device=DEVICE)
            for shape, dt in shards]
    after = stats()
    grown, requested = after[0] - before[0], after[1] - before[1]
    del bufs
    free_card()
    n_fit = sum(b <= total for b in nbytes)
    rep["allocated"] = dict(
        cell=f"{pick['arch']} {pick['shape']} {pick['mesh']}",
        argument_bytes=want, leaves=len(shards), grown_bytes=grown,
        requested_bytes=requested, slack_bytes=slack, free_bytes=free,
        total_bytes=total, cells_fitting=n_fit, card=REPORT.get("card"))
    log(f"[shapes] (b) {pick['arch']} {pick['shape']} on {pick['mesh']}: "
        f"per-rank arguments {want / 2**30:.3f} GiB in {len(shards)} "
        f"leaves; the allocator's requested bytes grew {requested:,} B, "
        f"memory_allocated {grown:,} B (rounding allowed: {slack:,} B); "
        f"{n_fit} of {len(recs)} cells' per-rank argument bytes fit in the "
        f"card's {total / 2**30:.1f} GiB ({REPORT.get('card')}; "
        f"temporaries not counted)")
    assert requested == want, rep["allocated"]
    assert want <= grown <= want + slack, rep["allocated"]
    assert ops.launch_counts() == counts, "phase 14 launched a kernel"


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
    bcounts = timed("pq4 and bin", phase_pq4_bin, idx, ds, none_rec)
    torch.cuda.empty_cache()
    icounts, ivf_pq = timed("ivf", phase_ivf, ds, none_rec)
    sharded = timed("sharded", phase_sharded, idx, ds, none_rec, ivf_pq)
    timed("serving", phase_serving, idx, sharded, ivf_pq, ds)
    del sharded, ivf_pq
    torch.cuda.empty_cache()
    timed("tuner", phase_tuner, idx, ds)
    timed("mesh", phase_mesh, idx, ds)
    del idx
    torch.cuda.empty_cache()
    timed("shapes", phase_shapes)
    timed("recsys", phase_recsys)
    timed("models", phase_models)
    path_counts = dict(main=counts, quant=qcounts, pq4_bin=bcounts,
                       ivf=icounts)
    kernels = []
    for name, (src, rep, path) in KERNEL_SOURCES.items():
        kernels.append(dict(name=name, route="cuda",
                            source=f"src/repro_torch/kernels/csrc/{src}.cu",
                            replaces=rep, launches=path_counts[path][name],
                            **rows[name]))
    REPORT["kernels"] = kernels
    # what each kernel's time above its bound cost its path in this run:
    # launches x (device ms - bound ms), the order of the redesigns to come
    excess = sorted(((k["launches"] * (k["device_ms"] - k["bound_ms"]),
                      k["name"]) for k in kernels), reverse=True)
    REPORT["excess_ms"] = {name: ms for ms, name in excess}
    log("[kernels] launches x (device ms - bound ms): " + ", ".join(
        f"{name} {ms:.1f}" for ms, name in excess))
    log(f"[summary] exact kNN stage {REPORT['main']['stages']['knn']:.2f} s"
        f", ivf_bin QPS {REPORT['ivf']['ivf_bin']['row']['qps']:.0f} (recall@10"
        f" {REPORT['ivf']['ivf_bin']['row']['recall']:.4f}), graph none W=4 "
        f"recall@10 {none_rec[(4, 'kernel')]:.4f}, 2-shard graph W=4 "
        f"recall@10 {REPORT['sharded']['graph']['rows'][0]['recall']:.4f}, "
        f"engine drain QPS {REPORT['serving']['graph']['qps']:.0f}, "
        f"qwen2.5-14b decode "
        f"{REPORT['models']['lm']['qwen2_5_14b']['decode']['ms_per_token']:.2f}"
        f" ms/token at B={LM_DECODE_B.get('qwen2_5_14b', DECODE_B)} from a "
        f"{DECODE_MAX_LEN:,}-position cache")
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
