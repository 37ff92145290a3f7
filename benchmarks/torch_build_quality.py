"""Graph quality of the PyTorch port's build at scale, per kNN builder.

For each build variant this builds the `beam_index_config("deep_like")`
index with the port (src/repro_torch) on `deep_like` data, and reports:
the recall of the kNN graph it starts from (against exact kNN of a sample
of base rows, computed with batch_dist on the device), the build time per
stage, and search recall@10 / iterations at W=4 for each queue size L in
--Ls. It answers whether a low end-to-end recall comes from the kNN
stage, the refinement, or the search budget.

A variant is builder[:rounds[:search_passes[:refine_iters]]], e.g.

    python3 benchmarks/torch_build_quality.py --n 1000000 \
        --variants nn_descent:6 brute --Ls 64 96 128 160

Needs a CUDA device (or --device cpu at small n). Prints one JSON line per
variant and writes them to --out.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[1] / "src"))


def knn_recall(x, knn_ids, metric, sample, device):
    """Recall of knn_ids (n, k) against exact kNN for `sample` rows."""
    import torch

    from repro_torch.core.build import stable_topk_smallest
    from repro_torch.kernels import ops
    n, k = knn_ids.shape
    rows = torch.arange(0, n, max(1, n // sample), device=device)[:sample]
    d = ops.batch_dist(x[rows].contiguous(), x, metric=metric)
    d[torch.arange(len(rows), device=device), rows] = float("inf")
    _, exact = stable_topk_smallest(d, k)
    got = knn_ids[rows].long()
    hits = (got[:, :, None] == exact[:, None, :]).any(2).sum()
    return float(hits) / (len(rows) * k)


def run(n, n_queries, variants, device, Ls=(64,), sample=2000):
    import torch

    from repro_torch.configs.kbest import beam_index_config
    from repro_torch.core import build as build_mod
    from repro_torch.core.index import KBest
    from repro_torch.data.vectors import make_dataset, recall_at_k

    ds = make_dataset("deep_like", n=n, n_queries=n_queries, k=10,
                      device=device)
    base = beam_index_config("deep_like")
    rows = []
    for v in variants:
        parts = v.split(":")
        builder = parts[0]
        knobs = [int(x) for x in parts[1:]] + [None] * 3
        rounds, passes, iters = knobs[:3]
        b = dataclasses.replace(
            base.build, builder=builder,
            nn_descent_rounds=rounds or base.build.nn_descent_rounds,
            search_passes=passes or base.build.search_passes,
            refine_iters=iters or base.build.refine_iters)
        cfg = dataclasses.replace(base, build=b, search=dataclasses.replace(
            base.search, dist_impl="kernel"))
        kr = 1.0            # the brute builder is exact by construction
        if builder != "brute":
            x = torch.as_tensor(ds.base, device=device)
            ids, _ = build_mod.build_knn(
                x, b.knn_k, cfg.metric, builder=builder,
                rounds=b.nn_descent_rounds, sample=b.nn_descent_sample,
                seed=b.seed)
            kr = knn_recall(x, ids, cfg.metric, sample, device)
            del ids, x
        idx = KBest(cfg, device=device).add(ds.base)
        search = {}
        for L in Ls:
            scfg = dataclasses.replace(cfg.search, L=L)
            found, iters = [], []
            for s in range(0, n_queries, 1000):
                _, i, st = idx.search(ds.queries[s:s + 1000],
                                      search_cfg=scfg, with_stats=True)
                found.append(i.cpu())
                iters.append(int(st.iters))
            search[L] = dict(recall_at_10=recall_at_k(
                torch.cat(found).numpy(), ds.gt_ids, 10),
                iters_max=max(iters))
        row = dict(variant=v, n=n, knn_recall=kr,
                   build_s=sum(idx.build_times.values()),
                   stages={k: round(t, 3) for k, t in idx.build_times.items()},
                   search=search)
        print(json.dumps(row), flush=True)
        rows.append(row)
        del idx
        if device != "cpu":
            torch.cuda.empty_cache()
    return rows


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--queries", type=int, default=10_000)
    ap.add_argument("--variants", nargs="+",
                    default=["brute", "nn_descent:6"])
    ap.add_argument("--Ls", type=int, nargs="+", default=[64, 96, 128, 160])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out", default="chiprun_out/torch_build_quality.json")
    args = ap.parse_args()
    rows = run(args.n, args.queries, args.variants, args.device, args.Ls)
    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(rows, indent=1))
