"""Multi-pod dry-run of the shape layer, the counterpart of the JAX
package's `launch/dryrun.py`.

For every (architecture x input-shape) cell, build the cell
(`launch/specs.py`) against the production meshes

    single-pod : (data=16, model=16)        = 256 ranks
    multi-pod  : (pod=2, data=16, model=16) = 512 ranks

and run its step once on its `meta` args under `mesh_context` (the port's
counterpart of lowering it: every op checks its shapes and dtypes, nothing
is allocated and nothing computed). A step that raises marks the cell
failed. The mesh lives on a `fake` process group of the mesh's size on
this one process (brought up here when none is initialised, and torn down
after the cell), so the collectives of the moe_sm and retr_shard steps run
on meta blocks and nothing leaves the process. The record keeps the
reference's keys: `memory_analysis.argument_bytes` is the per-rank bytes
of every argument leaf (params, optimizer state, batch, cache), summed
from each leaf's `.shard_shape` times its itemsize: computed from shard
shapes, not by a compiler. Keys with no torch counterpart are null:
`output_bytes`, `temp_bytes`, `generated_code_bytes`, `cost_analysis`,
`cost_extrapolated`, `collectives`, `while_trip_counts`. The reference's
`collective_bytes`, `while_trip_counts`, `_lower_metrics` and
`extrapolate_cost` read XLA's cost analysis and HLO text and are not
ported. Artifacts land in experiments/dryrun_torch/<arch>__<shape>__<mesh>
.json.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch gemma-2b \
        --shape train_4k --device cpu
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --both-meshes

The mesh is built on --device (default the card, "cpu" on a host); the
tensors are meta either way.
"""
from __future__ import annotations

import argparse
import contextlib
import json
import math
import time
import traceback
from pathlib import Path

import torch

from repro_torch import configs as cfg_registry
from repro_torch.launch.mesh import make_production_mesh, mesh_context
from repro_torch.launch.specs import build_cell
from repro_torch.train.tree import leaves

ART_DIR = Path(__file__).resolve().parents[3] / "experiments" / "dryrun_torch"

_DTYPE_BYTES = {
    torch.bool: 1, torch.int8: 1, torch.uint8: 1, torch.int16: 2,
    torch.bfloat16: 2, torch.float16: 2, torch.int32: 4, torch.float32: 4,
    torch.int64: 8, torch.float64: 8, torch.complex64: 8,
    torch.complex128: 16,
}


@contextlib.contextmanager
def production_mesh(multi_pod: bool, device: str = "cuda"):
    """The production mesh on `device`, over a `fake` process group of its
    size made here (and destroyed on exit) unless a group is initialised;
    that one must span the mesh."""
    import torch.distributed as dist
    own = not dist.is_initialized()
    if own:
        from torch.testing._internal.distributed.fake_pg import FakeStore
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=512 if multi_pod else 256)
    try:
        yield make_production_mesh(multi_pod=multi_pod, device_type=device)
    finally:
        if own:
            dist.destroy_process_group()


def argument_leaves(cell):
    """(global meta tensor, its NamedSharding) of every argument leaf."""
    return list(zip(leaves(cell.args), leaves(cell.in_shardings)))


def argument_bytes(cell) -> int:
    """Per-rank bytes of every argument leaf, from its shard shape."""
    return sum(math.prod(sh.shard_shape(x.shape)) * _DTYPE_BYTES[x.dtype]
               for x, sh in argument_leaves(cell))


def run_cell(arch: str, shape: str, multi_pod: bool, save: bool = True,
             variant: str = "baseline", device: str = "cuda") -> dict:
    arch = arch.replace("-", "_").replace(".", "_")   # canonical module name
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    with production_mesh(multi_pod, device) as mesh:
        t0 = time.time()
        cell = build_cell(arch, shape, mesh, variant=variant)
        with mesh_context(mesh):
            cell.step_fn(*cell.args)
        dt = time.time() - t0
        n_dev = mesh.size()
        arg_bytes = argument_bytes(cell)
    rec = {
        "arch": arch, "shape": shape, "mesh": mesh_name, "variant": variant,
        "kind": cell.kind, "ok": True, "seconds": round(dt, 1),
        "devices": n_dev,
        "memory_analysis": {
            "argument_bytes": arg_bytes,
            "output_bytes": None, "temp_bytes": None,
            "generated_code_bytes": None,
        },
        "cost_analysis": None,
        "cost_extrapolated": None,
        "collectives": None,
        "while_trip_counts": None,
        "meta": cell.meta,
    }
    if save:
        ART_DIR.mkdir(parents=True, exist_ok=True)
        suffix = "" if variant == "baseline" else f"__{variant}"
        out = ART_DIR / f"{arch}__{shape}__{mesh_name}{suffix}.json"
        out.write_text(json.dumps(rec, indent=1))
    return rec


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", type=str, default=None)
    ap.add_argument("--shape", type=str, default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--skip-existing", action="store_true")
    ap.add_argument("--variant", type=str, default="baseline",
                    help="optimization variant (see launch/specs.VARIANTS)")
    ap.add_argument("--device", type=str, default="cuda",
                    help="the mesh's device type; the tensors are meta")
    args = ap.parse_args(argv)

    cells = (list(cfg_registry.all_cells()) if args.all
             else [(args.arch, args.shape)])
    meshes = [False, True] if args.both_meshes else [args.multi_pod]
    failures = []
    for arch, shape in cells:
        for mp in meshes:
            mesh_name = "pod2x16x16" if mp else "pod16x16"
            fname = ART_DIR / f"{arch}__{shape}__{mesh_name}.json"
            if args.skip_existing and fname.exists() \
                    and json.loads(fname.read_text()).get("ok"):
                print(f"[skip] {arch} {shape} {mesh_name}")
                continue
            try:
                rec = run_cell(arch, shape, mp, variant=args.variant,
                               device=args.device)
                mem = rec["memory_analysis"]
                print(f"[ok]   {arch:24s} {shape:14s} {mesh_name:10s} "
                      f"{rec['seconds']:6.1f}s "
                      f"args={_gb(mem['argument_bytes'])} "
                      f"temp={_gb(mem['temp_bytes'])}", flush=True)
            except Exception as e:
                failures.append((arch, shape, mesh_name, repr(e)))
                traceback.print_exc()
                print(f"[FAIL] {arch} {shape} {mesh_name}: {e}", flush=True)
    if failures:
        print(f"\n{len(failures)} FAILURES:")
        for f in failures:
            print("  ", f)
        return 1
    print("\nall requested dry-run cells ran OK")
    return 0


def _gb(b):
    return "-" if b is None else f"{b/2**30:.2f}G"


if __name__ == "__main__":
    raise SystemExit(main())
