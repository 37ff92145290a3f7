"""The operating-point sweep: recall@10 and seconds a call against the
search settings of a cell's configuration, one build for the whole grid.

    python3 portbench/sweep.py --workload graph.batch --seed 5 \
        --grid L=96,128,192,256 [--grid nprobe=24,48] [--batches 2] \
        [--out chiprun_out/sweep_graph.json]

Each point of the grid (the product of the --grid lists, fields of the
configuration's `search` group) serves the cell's first --batches calls
of its traffic twice, and the second pass is timed; recall@10 is taken
against the plain reference. A cell's settings are chosen from these
readings once, on the card; the benchmark's own runs never run this.
"""
import argparse
import dataclasses
import itertools
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent


def parse_grid(items):
    grid = []
    for item in items:
        key, values = item.split("=", 1)
        grid.append([(key, int(v)) for v in values.split(",")])
    return [dict(point) for point in itertools.product(*grid)]


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--grid", action="append", required=True)
    p.add_argument("--batches", type=int, default=1)
    p.add_argument("--out")
    args = p.parse_args(argv)
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(ROOT / "src"))
    from run import cache_dirs
    cache_dirs(ROOT)
    import numpy as np
    import torch

    from pb import harness, spec
    from pb.reference import exact_topk
    from pb.system import KBestSystem

    if not torch.cuda.is_available():
        print("sweep.py reads the card; none is available", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = spec.Cell(spec.load_spec(ROOT), args.workload)
    base, _, metric, traffic = harness.prepare(cell, args.seed)
    batches = [traffic.batch(b) for b in range(args.batches)]
    queries = np.concatenate(batches)
    k = traffic.k
    _, gt = exact_topk(base, queries, k, metric, device="cuda")
    t = time.perf_counter()
    system = KBestSystem(cell.config, "cuda")
    system.build(base)
    build_s = time.perf_counter() - t
    index = system.index
    rows = []
    for point in parse_grid(args.grid):
        scfg = dataclasses.replace(index.config.search, k=k, **point)
        ids, seconds = [], 0.0
        for timed in (False, True):
            ids = []
            torch.cuda.synchronize()
            t = time.perf_counter()
            for q in batches:
                _, i = index.search(q, k=k, search_cfg=scfg)
                ids.append(i.cpu().numpy())
            if timed:
                seconds = time.perf_counter() - t
        ids = np.concatenate(ids)
        hits = (ids[:, :, None] == gt[:, None, :k]).any(-1).sum()
        row = dict(workload=args.workload, seed=args.seed, **point,
                   recall_at_10=float(hits / (len(queries) * k)),
                   s_per_call=seconds / len(batches),
                   qps=len(queries) / seconds, build_s=build_s)
        print(json.dumps(row), flush=True)
        rows.append(row)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(rows, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
