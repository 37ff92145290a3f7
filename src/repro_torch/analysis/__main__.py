"""CLI of the port's lint: `python -m repro_torch.analysis [--report]
[--check NAME] [--root PATH] [--json PATH]`. Exits 0 only on a tree
without violations."""
from __future__ import annotations

import argparse
import dataclasses
import json
import sys

from repro_torch.analysis import (CHECKS, cost, default_root, run_all,
                                  run_check, smem, tracing)
from repro_torch.analysis.common import Tree


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="AST and text checks over the PyTorch/CUDA port's "
                    "tree (DESIGN.md §15/§16)")
    ap.add_argument("--check", choices=sorted(CHECKS),
                    help="run a single check (default: all seven)")
    ap.add_argument("--report", action="store_true",
                    help="also print the per-kernel shared-memory, "
                         "allowlisted-sync and cost-model tables")
    ap.add_argument("--root", default=None,
                    help="tree to check (default: this checkout)")
    ap.add_argument("--json", metavar="PATH", default=None,
                    help="write findings + the smem/cost tables as JSON")
    args = ap.parse_args(argv)

    root = args.root if args.root is not None else default_root()
    if args.report:
        tree = Tree(root)
        for check, mod in ((smem.CHECK, smem), (tracing.CHECK, tracing),
                           (cost.CHECK, cost)):
            if args.check in (None, check):
                print(mod.report(tree))
                print()

    violations = (run_check(args.check, root) if args.check
                  else run_all(root))
    for v in violations:
        print(v)
    names = sorted({v.check for v in violations})
    print(f"repro_torch lint: {len(violations)} violation(s)"
          + (f" [{', '.join(names)}]" if names else "")
          + f" in {root}")

    if args.json:
        tree = Tree(root)
        payload = {
            "root": str(root),
            "ok": not violations,
            "violations": [dataclasses.asdict(v) for v in violations],
            "smem": [dataclasses.asdict(e) for e in smem.estimate(tree)],
            "syncs": [dataclasses.asdict(s) for s in tracing.syncs(tree)],
            "cost": cost.cost_model(tree),
        }
        with open(args.json, "w") as f:
            json.dump(payload, f, indent=1)
        print(f"wrote {args.json}")

    return 1 if violations else 0


if __name__ == "__main__":
    sys.exit(main())
