#!/usr/bin/env python3
"""Time the port's kernels of one checkout on the card, to compare two
commits' kernels side by side.

    python3 benchmarks/torch_kernel_ab.py --root DIR     # DIR/src/repro_torch

Builds DIR's kernels (into DIR's own build directory) and times each one
DIR has, at the shape of `chip_smoke.py`'s kernels line, on the inputs of
its phase 2 (`kernel_inputs`, `kernel_cases`), with phase 2's two clocks:
`ms`, one call with its launch (the median of ten, from CUDA events), and
`device_ms`, the device time per call from a replayed CUDA graph over the
case's input sets (`batch_dist`: the event time, as its launch is a
negligible share of a 1000 x 1M call); for the five fused steps also
`enqueue_ms`, the host's time a call (wrapper, checks, launch) over 100
calls in a row that the card has not finished (the median of five
rounds); with `--all`, every case of phase 2 besides, keyed "name
shape"; with `--chain`, phase 2's `[chain]` split too
(`chip_smoke.chain_split`: the launch floor, the gathers and the five
fused steps on ids that are all -1). Prints one JSON line last. Compare
two commits within one machine, in turns (parent, change, change,
parent), each run in its own process:

    for r in OLD NEW NEW OLD; do python3 benchmarks/torch_kernel_ab.py --root $r; done
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def enqueue_ms(fn, calls: int = 100, rounds: int = 5) -> float:
    """Median host milliseconds a call of fn() over `calls` calls in a
    row, the card synchronised before each round only."""
    import torch
    times = []
    for _ in range(rounds):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        times.append((time.perf_counter() - t0) * 1e3 / calls)
    torch.cuda.synchronize()
    times.sort()
    return times[len(times) // 2]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(REPO),
                    help="checkout whose src/repro_torch kernels are timed")
    ap.add_argument("--all", action="store_true",
                    help="also time phase 2's other shapes of each kernel")
    ap.add_argument("--chain", action="store_true",
                    help="also time phase 2's [chain] split")
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    import chip_smoke as cs                 # imports no kernels at import
    sys.path.insert(0, str(Path(args.root).resolve() / "src"))
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_ab: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import _build, ops

    _build.build_all()
    g = torch.Generator(device="cuda").manual_seed(1)
    db = torch.nn.functional.normalize(
        torch.randn((cs.N_MAIN, 96), generator=g, device="cuda"), dim=1)
    have = ops.launch_counts()
    out, main = {}, {}
    inp = cs.kernel_inputs(db)
    for c in cs.kernel_cases(inp):
        if c.main:
            main[c.name] = c
        if (c.main or args.all) and c.name in have:
            ms = cs.cuda_ms(lambda: c.kern(*c.sets[0]))
            # batch_dist's launch is a negligible share of its call: CUDA
            # events alone, as in chip_smoke.py
            row = out[c.name if c.main else f"{c.name} {c.shape}"] = dict(
                ms=ms, device_ms=ms if c.name == "batch_dist"
                else cs.graph_ms(c.kern, c.sets))
            if c.main and c.name in cs.FUSED_STEPS:
                row["enqueue_ms"] = enqueue_ms(lambda: c.kern(*c.sets[0]))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    chain = cs.chain_split(inp, main) if args.chain else None
    print(json.dumps({"root": args.root, "card": card, "kernels": out,
                      "chain": chain}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
