"""Serving launcher: the KBest ANN service over a synthetic corpus, or
greedy decode of a language model through its KV cache; the counterpart of
the JAX package's `repro/launch/serve.py`.

    # graph and IVF engines side by side, on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --mode ann --n 4000

    # the same service over 2-shard indexes (ShardedKBest, DESIGN.md §12):
    # the engines' cache key carries the shard count
    PYTHONPATH=src python -m repro_torch.launch.serve --mode ann --n 4000 \
        --shards 2

    # beam-parallel traversal for the graph engine (DESIGN.md §2)
    PYTHONPATH=src python -m repro_torch.launch.serve --mode ann --beam 4

    # 16 greedy decode steps of a smoke LM through its KV cache (the
    # decode_32k path)
    PYTHONPATH=src python -m repro_torch.launch.serve --mode lm \
        --arch gemma-2b

    # on the host instead of the card
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
"""
from __future__ import annotations

import argparse
import time

import numpy as np


def serve_ann(n: int, shards: int = 1, beam: int = 1, device: str = "cuda"):
    """Graph and IVF indexes served side by side through the serving tier
    (repro_torch.serve): mixed batch sizes and mixed k drain through one
    shape-bucketed callable cache per engine. shards > 1 builds each index
    as a ShardedKBest behind the same engines; beam > 1 searches the graph
    engine with beam-parallel traversal (beam_width rides SearchConfig, so
    it is part of the cache key)."""
    import torch

    from repro_torch.core.index import KBest
    from repro_torch.core.sharded import ShardedKBest
    from repro_torch.core.types import (BuildConfig, IVFConfig, IndexConfig,
                                        QuantConfig, SearchConfig)
    from repro_torch.data.vectors import make_dataset
    from repro_torch.serve import Request, SearchEngine, serve_loop

    def build(cfg, base):
        if cfg.n_shards > 1:
            return ShardedKBest(cfg, device=device).add(base)
        return KBest(cfg, device=device).add(base)

    ds = make_dataset("deep_like", n=n, n_queries=100, k=10, device=device)
    dim = ds.base.shape[1]
    graph = build(IndexConfig(
        dim=dim, metric=ds.metric, n_shards=shards,
        build=BuildConfig(M=32, knn_k=48, refine_iters=1, reorder="mst"),
        search=SearchConfig(L=64, k=10, early_term=True,
                            beam_width=beam)), ds.base)
    ivf = build(IndexConfig(
        dim=dim, metric=ds.metric, index_type="ivf", n_shards=shards,
        ivf=IVFConfig(kmeans_iters=6),
        quant=QuantConfig(kind="pq", pq_m=16, kmeans_iters=6),
        search=SearchConfig(L=64, k=10, nprobe=8)), ds.base)

    engines = {"graph": SearchEngine(graph, max_bucket=16, name="graph"),
               "ivf": SearchEngine(ivf, max_bucket=16, name="ivf")}
    for e in engines.values():
        for kk in (5, 10):        # warm every (bucket, k) the traffic emits,
            e.warmup(k=kk)        # or first calls pollute the latencies

    rng = np.random.default_rng(0)
    requests, s = [], 0
    while s < len(ds.queries):
        b = int(rng.integers(4, 17))          # variable-size traffic
        e = min(s + b, len(ds.queries))
        requests.append(Request(
            queries=ds.queries[s:e], gt_ids=ds.gt_ids[s:e],
            engine=rng.choice(["graph", "ivf"]),
            k=int(rng.choice([5, 10]))))
        s = e

    t0 = time.perf_counter()
    report = serve_loop(engines, requests)
    dt = time.perf_counter() - t0
    where = (torch.cuda.get_device_name(0) if graph.device.type == "cuda"
             else "host CPU")
    print(f"{report.summary()} | wall {dt * 1e3:.1f} ms ({where})")
    for name, st in sorted(report.engine_stats.items()):
        print(f"  [{name}] {st.summary()}")
    return report


def serve_lm(arch: str, device: str = "cuda") -> float:
    """The arch's smoke config with seeded weights: a cache of 64 slots for
    2 sequences, one warm-up step, then 16 greedy decode steps; prints and
    returns the mean ms a token."""
    import torch

    from repro_torch import configs as reg
    from repro_torch.models import transformer as T
    cfg = reg.get(arch).smoke_config()
    p = T.init_params(cfg, torch.Generator(device=device).manual_seed(0))
    cache = T.init_cache(cfg, 2, 64, dtype=torch.float32, device=device)
    toks = torch.randint(0, cfg.vocab, (2, 1), device=device,
                         generator=torch.Generator(device=device)
                         .manual_seed(1))
    logits, cache = T.decode_step(p, cache, toks, cfg)      # warm-up
    on_card = cache["len"].is_cuda
    if on_card:
        torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(16):
        nxt = torch.argmax(logits[:, -1:], dim=-1)
        logits, cache = T.decode_step(p, cache, nxt, cfg)
    if on_card:
        torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) / 16 * 1e3
    where = torch.cuda.get_device_name(0) if on_card else "host CPU"
    print(f"{arch}: {ms:.2f} ms/token (smoke config, {where}), "
          f"cache len={int(cache['len'][0])}")
    return ms


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("ann", "lm"), default="ann")
    ap.add_argument("--arch", default="gemma-2b",
                    help="the LM arch of --mode lm")
    ap.add_argument("--n", type=int, default=4000)
    ap.add_argument("--beam", type=int, default=1,
                    help="graph-engine beam width W (DESIGN.md §2)")
    ap.add_argument("--shards", type=int, default=1,
                    help="ShardedKBest shard count (1 = plain KBest)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args()
    if args.mode == "ann":
        serve_ann(args.n, shards=args.shards, beam=args.beam,
                  device=args.device)
    else:
        serve_lm(args.arch, device=args.device)


if __name__ == "__main__":
    main()
