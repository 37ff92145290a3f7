"""The port's lint: AST and text checks over the PyTorch/CUDA port's tree
(the counterpart of the JAX package's `repro.analysis`, DESIGN.md §15).

Seven checks, each a module with `run(tree) -> List[Violation]`:

  kernel_parity   every CUDA kernel wrapper has a plain torch version, an
                  ops.py dispatch entry, a cuda-marked parity test and a
                  phase-2 case in chip_smoke.py; every launcher symbol is
                  an extern "C" definition of its source
  registry        QUANT_KINDS/quant_variants wired through dispatch,
                  save/load, presets and the tuner; no hand quant lists
  dead_knobs      every config and serving knob is read somewhere
  sync_safety     no host sync on a device tensor on the search path
                  but the allowlisted ones
  smem_budget     per-kernel shared memory within a block's and an SM's
                  budget
  docs_xref       DESIGN.md §-citations resolve, sections contiguous
  cost            every kernel has a resolvable closed-form cost model
                  (FLOPs / bytes / dists — DESIGN.md §16)

Scope: src/repro_torch, tests/test_torch_*.py, chip_smoke.py and the CUDA
sources. Pure stdlib — runs without torch or a GPU, and on deliberately
broken fixture trees. CLI: `python -m repro_torch.analysis`.
"""
from pathlib import Path
from typing import List

from repro_torch.analysis import cost, docs, knobs, parity, registry, \
    smem, tracing
from repro_torch.analysis.common import Tree, Violation

CHECKS = {
    parity.CHECK: parity.run,
    registry.CHECK: registry.run,
    knobs.CHECK: knobs.run,
    tracing.CHECK: tracing.run,
    smem.CHECK: smem.run,
    docs.CHECK: docs.run,
    cost.CHECK: cost.run,
}


def default_root() -> Path:
    """The checkout containing this package: .../src/repro_torch/analysis
    -> three parents up."""
    return Path(__file__).resolve().parents[3]


def run_check(name: str, root) -> List[Violation]:
    return CHECKS[name](Tree(root))


def run_all(root) -> List[Violation]:
    tree = Tree(root)
    out: List[Violation] = []
    for fn in CHECKS.values():
        out.extend(fn(tree))
    return out
