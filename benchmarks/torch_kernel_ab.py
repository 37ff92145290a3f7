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
negligible share of a 1000 x 1M call); with `--all`, every case of
phase 2 besides, keyed "name shape". Prints one JSON line. Compare two
commits within one machine, in turns (parent, change, change, parent),
each run in its own process:

    for r in OLD NEW NEW OLD; do python3 benchmarks/torch_kernel_ab.py --root $r; done
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--root", default=str(REPO),
                    help="checkout whose src/repro_torch kernels are timed")
    ap.add_argument("--all", action="store_true",
                    help="also time phase 2's other shapes of each kernel")
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
    out = {}
    for c in cs.kernel_cases(cs.kernel_inputs(db)):
        if (c.main or args.all) and c.name in have:
            ms = cs.cuda_ms(lambda: c.kern(*c.sets[0]))
            # batch_dist's launch is a negligible share of its call: CUDA
            # events alone, as in chip_smoke.py
            out[c.name if c.main else f"{c.name} {c.shape}"] = dict(
                ms=ms, device_ms=ms if c.name == "batch_dist"
                else cs.graph_ms(c.kern, c.sets))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({"root": args.root, "card": card, "kernels": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
