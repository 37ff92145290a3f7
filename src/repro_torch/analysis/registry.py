"""Check 2 — quant-registry exhaustiveness (the port's counterpart of the
JAX package's `registry`, DESIGN.md §15).

`types.QUANT_KINDS` and `quantize.quant_variants` are THE registry of
quantization families. Every kind must be wired through the `KBest`
dispatch (`_get_dist_fn` / `_get_expand_fn`), the format-2 save/load
arrays, a configs/kbest.py preset and the tuner's sweep — and the port's
tests and chip_smoke.py must not hand-enumerate quant lists (the drift
bug class: a new kind lands in the registry but not in the sweeps).

The reference's sweep row is `benchmarks/ablation.py`, which has no port
counterpart; core/tune.py (`tune_quant_kind`, `tune_config`) is the
port's sweep over the registry and is checked in its place.

The per-kind array names are the reference's `KIND_SIDECARS`: format 2
pins them, so the same table holds here. The port keeps them in
core/index.py: `KBest.save` with `_ivf_arrays` writes them and
`KBest.load` with `_from_arrays` reads them (core/persist.py holds the
crash-safe protocol, not the keys). Adding a kind to QUANT_KINDS without
registering its arrays here fails the lint, which is the reminder that
save() and load() need a case.
"""
from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.common import (PKG, SMOKE, Tree, Violation,
                                         assigned_tuple_of_strings,
                                         class_def, keyword_arg, methods_of,
                                         missing_file, referenced_names,
                                         string_constants,
                                         top_level_functions)

CHECK = "registry"
TYPES = PKG + "/core/types.py"
QUANTIZE = PKG + "/core/quantize.py"
INDEX = PKG + "/core/index.py"
PRESETS = PKG + "/configs/kbest.py"
TUNE = PKG + "/core/tune.py"
# the save and load paths of format 2: KBest methods and module helpers
SAVE_PATH = ("save", "_ivf_arrays")
LOAD_PATH = ("load", "_from_arrays")

# kind -> array keys save() must write and load() must read for it.
# "none" persists nothing beyond db/graph. A kind missing from this map
# is itself a violation (forces the sidecar story to be decided with the
# kind, not discovered at load time).
KIND_SIDECARS: Dict[str, Tuple[str, ...]] = {
    "none": (),
    "pq": ("pq_codebooks", "pq_codes", "ivf_codebooks"),
    "pq4": ("pq_codebooks", "pq_codes", "ivf_codebooks"),
    "sq": ("sq_scale", "sq_zero", "sq_codes"),
    "bin": ("bin_rot", "bin_codes", "ivf_bin_rot"),
}

# Hand-list detection: a single list/tuple/set literal whose direct
# elements include >= this many registry names is treated as a
# hand-maintained enumeration. 2-element pairs like ("graph", "pq4")
# parametrize cases legitimately; 3+ is a sweep that must derive from
# quant_variants instead.
HAND_LIST_MIN = 3


def _variants(mod: ast.Module) -> Tuple[Set[str], Set[str], Optional[int]]:
    """(variant_names, kinds_covered, lineno) from quant_variants()'s
    returned dict literal; kinds come from dict(kind="x") / {"kind": "x"}
    values."""
    for n in mod.body:
        if isinstance(n, ast.FunctionDef) and n.name == "quant_variants":
            names: Set[str] = set()
            kinds: Set[str] = set()
            for d in ast.walk(n):
                if not isinstance(d, ast.Dict):
                    continue
                for k, v in zip(d.keys, d.values):
                    if isinstance(k, ast.Constant) and isinstance(k.value, str):
                        if k.value == "kind" and isinstance(v, ast.Constant):
                            kinds.add(v.value)
                        else:
                            names.add(k.value)
            for call in ast.walk(n):
                if isinstance(call, ast.Call):
                    kw = keyword_arg(call, "kind")
                    if isinstance(kw, ast.Constant) and isinstance(kw.value, str):
                        kinds.add(kw.value)
            return names, kinds, n.lineno
    return set(), set(), None


def _path_strings(mod: ast.Module, meths: Dict[str, ast.FunctionDef],
                  names: Tuple[str, ...]) -> Tuple[Set[str], List[str], int]:
    """String constants of a save/load path (KBest methods first, then
    module functions), the names not found and the first one's line."""
    fns = top_level_functions(mod)
    strings: Set[str] = set()
    missing: List[str] = []
    line = 1
    for name in names:
        fn = meths.get(name) or fns.get(name)
        if fn is None:
            missing.append(name)
            continue
        if line == 1:
            line = fn.lineno
        strings |= string_constants(fn)
    return strings, missing, line


def run(tree: Tree) -> List[Violation]:
    violations: List[Violation] = []

    types_mod = tree.parse(TYPES)
    if types_mod is None:
        return [missing_file(CHECK, TYPES, "QUANT_KINDS registry lives here")]
    kinds = assigned_tuple_of_strings(types_mod, "QUANT_KINDS")
    if kinds is None:
        return [Violation(CHECK, TYPES, 1,
                          "QUANT_KINDS tuple-of-strings not found")]

    # --- quant_variants covers every kind, and only registered kinds
    qz_mod = tree.parse(QUANTIZE)
    if qz_mod is None:
        violations.append(missing_file(CHECK, QUANTIZE,
                                       "quant_variants lives here"))
    else:
        names, vkinds, lineno = _variants(qz_mod)
        if lineno is None:
            violations.append(Violation(CHECK, QUANTIZE, 1,
                                        "quant_variants() not found"))
        else:
            for kind in kinds:
                if kind not in vkinds:
                    violations.append(Violation(
                        CHECK, QUANTIZE, lineno,
                        f"quant_variants() has no variant with "
                        f"kind='{kind}' (registry drift)"))
            for kind in sorted(vkinds - set(kinds)):
                violations.append(Violation(
                    CHECK, QUANTIZE, lineno,
                    f"quant_variants() uses kind='{kind}' which is not in "
                    f"types.QUANT_KINDS"))
        ivf_kinds = assigned_tuple_of_strings(qz_mod, "IVF_QUANT_KINDS")
        if ivf_kinds is None:
            violations.append(Violation(
                CHECK, QUANTIZE, 1,
                "IVF_QUANT_KINDS tuple not found (the tuner's IVF sweep "
                "derives from it)"))
        else:
            for kind in ivf_kinds:
                if kind not in kinds:
                    violations.append(Violation(
                        CHECK, QUANTIZE, 1,
                        f"IVF_QUANT_KINDS contains '{kind}' which is not "
                        f"in types.QUANT_KINDS"))

    # --- KBest dispatch handles every kind ("none" dispatches as "full")
    idx_mod = tree.parse(INDEX)
    if idx_mod is None:
        violations.append(missing_file(CHECK, INDEX,
                                       "KBest dispatch lives here"))
    else:
        kbest = class_def(idx_mod, "KBest")
        meths = methods_of(kbest) if kbest else {}
        for meth_name in ("_get_dist_fn", "_get_expand_fn"):
            meth = meths.get(meth_name)
            if meth is None:
                violations.append(Violation(
                    CHECK, INDEX, 1, f"KBest.{meth_name} not found"))
                continue
            strings = string_constants(meth)
            for kind in kinds:
                token = "full" if kind == "none" else kind
                if token not in strings:
                    violations.append(Violation(
                        CHECK, INDEX, meth.lineno,
                        f"KBest.{meth_name} does not handle kind "
                        f"'{kind}' (expected the '{token}' branch)"))
        # --- save/load persist every kind's format-2 arrays
        for what, path in (("save", SAVE_PATH), ("load", LOAD_PATH)):
            strings, missing, line = _path_strings(idx_mod, meths, path)
            for name in missing:
                violations.append(Violation(
                    CHECK, INDEX, 1,
                    f"{name} of the {what} path not found"))
            for kind in kinds:
                if kind not in KIND_SIDECARS:
                    violations.append(Violation(
                        CHECK, INDEX, line,
                        f"kind '{kind}' has no sidecar-array entry in "
                        f"analysis/registry.py KIND_SIDECARS — register "
                        f"its persisted arrays with the kind"))
                    continue
                for token in KIND_SIDECARS[kind]:
                    if token not in strings:
                        violations.append(Violation(
                            CHECK, INDEX, line,
                            f"the {what} path ({', '.join(path)}) does not "
                            f"handle the '{token}' array of kind '{kind}'"))

    # --- configs/kbest.py constructs a preset for every non-none kind
    cfg_mod = tree.parse(PRESETS)
    if cfg_mod is None:
        violations.append(missing_file(CHECK, PRESETS,
                                       "per-kind presets live here"))
    else:
        preset_kinds: Set[str] = set()
        for call in ast.walk(cfg_mod):
            if isinstance(call, ast.Call):
                kw = keyword_arg(call, "kind")
                if isinstance(kw, ast.Constant) and isinstance(kw.value, str):
                    preset_kinds.add(kw.value)
        for kind in kinds:
            if kind != "none" and kind not in preset_kinds:
                violations.append(Violation(
                    CHECK, PRESETS, 1,
                    f"no preset constructs QuantConfig(kind='{kind}')"))

    # --- the tuner's sweeps derive from the registry
    tune_mod = tree.parse(TUNE)
    if tune_mod is None:
        violations.append(missing_file(CHECK, TUNE,
                                       "the quant-kind sweep lives here"))
    else:
        refs = referenced_names(tune_mod)
        for token in ("quant_variants", "QUANT_KINDS", "IVF_QUANT_KINDS"):
            if token not in refs:
                violations.append(Violation(
                    CHECK, TUNE, 1,
                    f"the tuner does not derive its sweep from {token}"))

    # --- no hand-enumerated quant lists in the port's tests or smoke
    match_names = set(kinds) | {"full", "pq8", "pq4+u8lut"} \
        | {"ivf-" + k for k in kinds}
    if qz_mod is not None:
        vnames, _, _ = _variants(qz_mod)
        match_names |= vnames | {"ivf-" + v for v in vnames}
    scan = tree.tests() + ([SMOKE] if tree.exists(SMOKE) else [])
    for rel in scan:
        mod = tree.parse(rel)
        if mod is None:
            continue
        for node in ast.walk(mod):
            if not isinstance(node, (ast.List, ast.Tuple, ast.Set)):
                continue
            hits = [e.value for e in node.elts
                    if isinstance(e, ast.Constant) and
                    isinstance(e.value, str) and e.value in match_names]
            if len(hits) >= HAND_LIST_MIN:
                violations.append(Violation(
                    CHECK, rel, node.lineno,
                    f"hand-enumerated quant list {hits} — derive it from "
                    f"quantize.quant_variants / IVF_QUANT_KINDS so new "
                    f"kinds cannot drift out of the sweep"))
    return violations
