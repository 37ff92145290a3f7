"""Check 3 — dead config knobs (the port's counterpart of the JAX
package's `dead_knobs`, DESIGN.md §15).

Every field of the port's config dataclasses (core/types.py) must be read
somewhere in src/repro_torch outside core/types.py and this lint package.
A knob nobody reads is worse than missing: callers set it, tests sweep it,
the smoke reports it — and nothing changes.

Liveness is attribute-read based with property bridging: a field only
read by a property on its own class stays live iff that property (or a
property chain from it) is itself read externally — `max_hops` is live
through `hops_bound`, `pq_bits` through `nbits` -> `ksub`.

The serving-tier knob classes (SERVE_CLASSES: `Request`,
`DegradePolicy`, DESIGN.md §17) are covered under a relaxed rule: a field
is live if read anywhere in src/repro_torch outside the lint package,
including its defining module — policy knobs are legitimately consumed by
the class's own methods, but a field nobody reads at all still fails.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from repro_torch.analysis.common import (PKG, Tree, Violation, class_def,
                                         dataclass_fields, missing_file)

CHECK = "dead_knobs"
TYPES = PKG + "/core/types.py"
CLASSES = ("SearchConfig", "IndexConfig", "QuantConfig", "BuildConfig",
           "IVFConfig")
SERVE_CLASSES = (
    (PKG + "/serve/scheduler.py", ("Request",)),
    (PKG + "/serve/degrade.py", ("DegradePolicy",)),
)
ANALYSIS_PKG = PKG + "/analysis"


def _is_property(fn: ast.FunctionDef) -> bool:
    return any(isinstance(d, ast.Name) and d.id == "property"
               for d in fn.decorator_list)


def _self_reads(fn: ast.FunctionDef) -> Set[str]:
    """Attribute names read off `self` inside a method body."""
    out: Set[str] = set()
    for n in ast.walk(fn):
        if isinstance(n, ast.Attribute) and isinstance(n.ctx, ast.Load) \
                and isinstance(n.value, ast.Name) and n.value.id == "self":
            out.add(n.attr)
    return out


def _attr_reads(tree: Tree, skip_module: Optional[str] = None) -> Set[str]:
    """Every attribute name read (Load context) anywhere in the port's
    package outside the lint package itself and, when given,
    `skip_module`."""
    out: Set[str] = set()
    for rel in tree.iter_py(PKG):
        if rel == skip_module or rel.startswith(ANALYSIS_PKG + "/"):
            continue
        mod = tree.parse(rel)
        if mod is None:
            continue
        for n in ast.walk(mod):
            if isinstance(n, ast.Attribute) and isinstance(n.ctx, ast.Load):
                out.add(n.attr)
    return out


def _serve_violations(tree: Tree) -> List[Violation]:
    """Liveness for the serving knob classes, under the relaxed rule
    (module docstring). Fixture trees without a serving tier are skipped
    silently — absence of the module is not a dead knob."""
    reads: Optional[Set[str]] = None
    violations: List[Violation] = []
    for rel, class_names in SERVE_CLASSES:
        mod = tree.parse(rel)
        if mod is None:
            continue
        if reads is None:
            reads = _attr_reads(tree)
        for cls_name in class_names:
            cls = class_def(mod, cls_name)
            if cls is None:
                violations.append(missing_file(
                    CHECK, rel, f"serving knob class {cls_name} not found"))
                continue
            for name, lineno in dataclass_fields(cls):
                if name not in reads:
                    violations.append(Violation(
                        CHECK, rel, lineno,
                        f"serving knob {cls_name}.{name} is never read "
                        f"anywhere in src/repro_torch (dead knob — set by "
                        f"callers, consulted by nothing)"))
    return violations


def run(tree: Tree) -> List[Violation]:
    types_mod = tree.parse(TYPES)
    if types_mod is None:
        return [missing_file(CHECK, TYPES, "config dataclasses live here")]

    ext = _attr_reads(tree, skip_module=TYPES)
    violations: List[Violation] = []
    for cls_name in CLASSES:
        cls = class_def(types_mod, cls_name)
        if cls is None:
            continue
        fields = dataclass_fields(cls)
        props: Dict[str, Set[str]] = {
            m.name: _self_reads(m) for m in cls.body
            if isinstance(m, ast.FunctionDef) and _is_property(m)}

        # Propagate liveness through property chains to a fixpoint:
        # externally-read names are live; anything a live property reads
        # becomes live too.
        live = {n for n, _ in fields if n in ext} | \
               {p for p in props if p in ext}
        changed = True
        while changed:
            changed = False
            for p, reads in props.items():
                if p in live and not reads.issubset(live):
                    live |= reads
                    changed = True

        for name, lineno in fields:
            if name not in live:
                violations.append(Violation(
                    CHECK, TYPES, lineno,
                    f"config knob {cls_name}.{name} is never read outside "
                    f"its defining module (dead knob — the batch_B bug "
                    f"class)"))
    violations.extend(_serve_violations(tree))
    return violations

