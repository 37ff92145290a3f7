"""Serving launcher: the KBest ANN service over a synthetic corpus, the
counterpart of the JAX package's `repro/launch/serve.py --mode ann`.

    # graph and IVF engines side by side, on the card
    PYTHONPATH=src python -m repro_torch.launch.serve --mode ann --n 4000

    # the same service over 2-shard indexes (ShardedKBest, DESIGN.md §12):
    # the engines' cache key carries the shard count
    PYTHONPATH=src python -m repro_torch.launch.serve --mode ann --n 4000 \
        --shards 2

    # beam-parallel traversal for the graph engine (DESIGN.md §2)
    PYTHONPATH=src python -m repro_torch.launch.serve --mode ann --beam 4

    # on the host instead of the card
    PYTHONPATH=src python -m repro_torch.launch.serve --device cpu

The reference's `--mode lm` (a decode step of a language model) needs the
LM family, which the port does not have yet (ROADMAP queue 1 item 5b).
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


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", choices=("ann",), default="ann")
    ap.add_argument("--n", type=int, default=4000)
    ap.add_argument("--beam", type=int, default=1,
                    help="graph-engine beam width W (DESIGN.md §2)")
    ap.add_argument("--shards", type=int, default=1,
                    help="ShardedKBest shard count (1 = plain KBest)")
    ap.add_argument("--device", default="cuda",
                    help="'cuda' (the default) or 'cpu'")
    args = ap.parse_args()
    serve_ann(args.n, shards=args.shards, beam=args.beam, device=args.device)


if __name__ == "__main__":
    main()
