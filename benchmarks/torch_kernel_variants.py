#!/usr/bin/env python3
"""Time variants of one CUDA source of the port on the card, in turns, in
one process: each variant is the source with some of its integer
`constexpr` constants set to other values.

    python3 benchmarks/torch_kernel_variants.py --source traverse_step \\
        --variant final \\
        --variant wide kGroupBlock=256 kGroupMinBlocks=1 kF32FlightRegs=36

Each variant's copy of `src/repro_torch/kernels/csrc/<source>.cu` is built
(all at once, nvcc as `kernels/_build.py` builds, ptxas registers and
spills kept) into `build/variants/<name>/`; then the cases of
`chip_smoke.py`'s phase 2 (`kernel_inputs`, `kernel_cases`) whose kernel
the source holds (`chip_smoke.KERNEL_SOURCES`; with `--kernel`, only
those kernels' cases) are checked against their
plain versions once per variant and timed
by phase 2's device clock (`graph_ms`), through every variant in order and
again in reverse. Prints the card, each variant's registers a kernel
instance, and one line a case (the lower and higher of its two times per
variant, device ms); the whole result goes to
`chiprun_out/kernel_variants.json`. A variant with no constants is the
source as it is.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]


def variant_source(text: str, sets: list) -> str:
    for item in sets:
        name, value = item.split("=")
        text, n = re.subn(rf"\b{name} = -?\d+\b", f"{name} = {int(value)}",
                          text)
        if n != 1:
            raise ValueError(f"{name}: {n} definitions in the source")
    return text


def instance(mangled: str) -> str:
    """A readable name for a kernel template instance: its functor and the
    integer and bool template arguments after it, the functor's or the
    kernel's (`F32Dist<3,4,1>`, `PqScan<1,1>`)."""
    m = re.search(r"_\d+([A-Z]\w*?(?:Dist|Scan))(\w*?)E+vT_", mangled)
    if not m:
        return mangled[-48:]
    args = re.findall(r"L[ib](\d+)", m.group(2))
    return m.group(1) + (f"<{','.join(args)}>" if args else "")


def registers(log: str) -> list:
    """(kernel instance, registers, spill bytes) from nvcc -Xptxas -v."""
    out, fn, spill = [], None, 0
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            fn, spill = m.group(1), 0
        m = re.search(r"(\d+) bytes spill stores", line)
        if m:
            spill = int(m.group(1))
        m = re.search(r"Used (\d+) registers", line)
        if m and fn:
            out.append((instance(fn), int(m.group(1)), spill))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--source", required=True,
                    help="csrc/<source>.cu, e.g. traverse_step")
    ap.add_argument("--variant", nargs="+", action="append", required=True,
                    metavar=("NAME", "CONST=VALUE"))
    ap.add_argument("--kernel", action="append",
                    help="time only this kernel's cases (repeatable; "
                         "default: every kernel the source holds)")
    args = ap.parse_args()
    sys.path.insert(0, str(REPO))
    sys.path.insert(0, str(REPO / "src"))
    import torch
    if not torch.cuda.is_available():
        print("torch_kernel_variants: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import _build
    kernels = {name for name, (src, _, _) in cs.KERNEL_SOURCES.items()
               if src == args.source and (not args.kernel
                                          or name in args.kernel)}
    text = (_build.CSRC / f"{args.source}.cu").read_text()
    out_dir = _build.build_dir().parent / "variants"
    nvcc = _build._nvcc()
    procs = {}
    for name, *sets in args.variant:
        d = out_dir / name
        d.mkdir(parents=True, exist_ok=True)
        (d / f"{args.source}.cu").write_text(variant_source(text, sets))
        procs[name] = subprocess.Popen(
            [nvcc, *_build.FLAGS, "-I", str(_build.CSRC), "-o",
             str(d / f"lib{args.source}.so"), str(d / f"{args.source}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    regs = {}
    for name, proc in procs.items():
        log, _ = proc.communicate(timeout=900)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for variant {name}:\n{log}")
        regs[name] = registers(log)

    g = torch.Generator(device="cuda").manual_seed(1)
    db = torch.nn.functional.normalize(
        torch.randn((cs.N_MAIN, 96), generator=g, device="cuda"), dim=1)
    cases = [c for c in cs.kernel_cases(cs.kernel_inputs(db))
             if c.name in kernels]
    names = list(procs)
    times = {n: {} for n in names}
    for turn, order in enumerate((names, names[::-1])):
        for name in order:
            _build._libs[args.source] = ctypes.CDLL(
                str(out_dir / name / f"lib{args.source}.so"))
            for c in cases:
                key = f"{c.name} {c.shape}"
                if turn == 0:
                    cs.check_case(c)      # raises if it disagrees
                times[name].setdefault(key, []).append(
                    cs.graph_ms(c.kern, c.sets))
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card)
    for name in names:
        print(f"[registers {name}] " + ", ".join(
            f"{fn}: {r}" + (f" (spills {s} B)" if s else "")
            for fn, r, s in regs[name]))
    for key in times[names[0]]:
        print(key + ": " + ", ".join(
            f"{n} {min(times[n][key]):.4f}/{max(times[n][key]):.4f}"
            for n in names))
    (REPO / "chiprun_out").mkdir(exist_ok=True)
    (REPO / "chiprun_out" / "kernel_variants.json").write_text(json.dumps(
        dict(card=card, source=args.source,
             variants={n: dict(sets=s, registers=regs[n], device_ms=times[n])
                       for (n, *s) in args.variant})))
    return 0


if __name__ == "__main__":
    sys.exit(main())
