"""The readings that the correctness limits are set from.

    python3 portbench/calibrate.py --workload graph.batch --seeds 11,12,13 \
        [--seconds 0] [--out chiprun_out/calibrate_graph.batch.json]

For each seed, at the cell's own sizes and on its own traffic (a closed
loop serves each distinct request once at least; an open loop its
requests of a --seconds window, at the mix's own load): the control (the plain reference in
TF32 in the program's place, pb.faults.ControlSystem), the program as
served, and the program with each planted fault of pb.faults, each
judged by pb.check as a run's window is. One build a seed serves the
program and its faults. The numbers go to standard output, one JSON line
a reading, and to --out. The benchmark's own runs never run this.
"""
import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
HERE = Path(__file__).resolve().parent


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=0.0)
    p.add_argument("--out")
    args = p.parse_args(argv)
    sys.path.insert(0, str(HERE))
    sys.path.insert(0, str(ROOT / "src"))
    from run import cache_dirs
    cache_dirs(ROOT)
    import torch

    from pb import faults, harness, spec
    from pb.system import KBestSystem

    if not torch.cuda.is_available():
        print("calibrate.py reads the card; none is available",
              file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cell = spec.Cell(spec.load_spec(ROOT), args.workload)
    kind = cell.config["index"]["index_type"]
    readings = []
    for seed in (int(s) for s in args.seeds.split(",")):
        base, pool, metric, traffic = harness.prepare(cell, seed)
        t0 = time.perf_counter()

        def reading(label, call):
            r = harness.Run(cell, False, "cuda", t0)
            harness.measure(r, call, traffic, args.seconds,
                            min_calls=1 if traffic.open
                            else traffic.n_batches)
            v = harness.judge(r, base, pool, metric, traffic)
            row = dict(workload=args.workload, seed=seed, reading=label,
                       correct=v["correct"], attempted=v["attempted"],
                       failed=v["failed"], **v["numbers"])
            print(json.dumps(row), flush=True)
            readings.append(row)

        reading("control", faults.ControlSystem(base, metric, "cuda").search)
        system = KBestSystem(cell.config, "cuda")
        system.build(base)
        reading("program", system.search)
        for name in faults.FAULTS:
            with faults.plant(name, kind) as wrap:
                reading(name, wrap(system.search))
        system.close()
        del system
        torch.cuda.empty_cache()
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(readings, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
