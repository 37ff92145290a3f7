"""The port's benchmark: one run of one cell.

    python3 portbench/run.py --workload graph.batch --seed 7 --seconds 20 \
        --trace 0

from the root of a checkout. The cells, their configurations, traffic
mixes and metrics are named in BENCHMARK.json (see pb/spec.py). The run
needs a CUDA card for each chip the cell asks for and exits with an
error otherwise; it never falls back to the CPU. Its last line of
standard output is the result as one JSON object; its last lines of
standard error are the numbers that decided `correct`, each beside its
limit. With --trace 0 the metrics are the cell's end-to-end metrics,
with --trace 1 its per-layer metrics, read under the profiler.

Kernels are built into build/ inside the checkout, so only a checkout's
first run builds them.
"""
import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent


def cache_dirs(root: Path) -> None:
    """Every build and kernel cache of the program inside the checkout,
    at fixed paths."""
    build = root / "build"
    os.environ["REPRO_TORCH_BUILD_DIR"] = str(build / "repro_torch")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    cache_dirs(ROOT)
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(ROOT / "src"))
    from pb import harness, spec

    cell = spec.Cell(spec.load_spec(ROOT), args.workload)
    import torch
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA device(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"device_count() {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    import repro_torch  # noqa: F401  the program under test, from src/
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    result = harness.run(cell, args.seed, args.seconds, bool(args.trace),
                         "cuda", T0)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(f"correct: {result['correct']}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
