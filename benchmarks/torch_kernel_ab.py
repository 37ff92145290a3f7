#!/usr/bin/env python3
"""Time the port's kernels of one checkout on the card, to compare two
commits' kernels side by side.

    python3 benchmarks/torch_kernel_ab.py --root DIR     # DIR/src/repro_torch

Builds DIR's kernels (into DIR's own build directory) and times each one
DIR has, at the shape of `chip_smoke.py`'s kernels line, on the inputs of
its phase 2 (`kernel_inputs`, `kernel_cases`), with phase 2's two clocks:
`ms`, one call with its launch, and `device_ms`, the device time per call
from a replayed CUDA graph over the case's input sets. Prints one JSON
line. Compare two commits within one machine, in turns (parent, change,
change, parent), each run in its own process:

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
        if c.main and c.name in have and c.name != "batch_dist":
            out[c.name] = dict(
                ms=cs.cuda_ms(lambda: c.kern(*c.sets[0])),
                device_ms=cs.graph_ms(c.kern, c.sets))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(json.dumps({"root": args.root, "card": card, "kernels": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
