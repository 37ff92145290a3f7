"""Check 1 — kernel / plain version / dispatch / test parity (the port's
counterpart of the JAX package's `kernel_parity`, DESIGN.md §15).

A kernel of the port is a public function of `kernels/*.py` whose body
reaches `_build.function(...)` — the ctypes handle of a hand-written CUDA
launcher, the counterpart of reaching `pallas_call` — directly or through
a helper of the kernel modules (`_launch`, `launch_scan`); the helpers
that other wrappers call are not kernels themselves. Each kernel must come
with:

  - a `<name>_ref` plain torch version in kernels/ref.py;
  - a `<name>` dispatch entry in kernels/ops.py;
  - a `cuda`-marked test in tests/test_torch_*.py that names both (the
    kernel-vs-plain comparison on the card);
  - a `KERNEL_SOURCES` key in chip_smoke.py (its phase-2 case).

And every symbol handed to `_build.function(src, symbol, ...)` must be an
`extern "C"` definition in `kernels/csrc/<src>.cu`: a wrapper whose
launcher is missing fails here, not with an AttributeError on the card.
"""
from __future__ import annotations

import ast
import re
from pathlib import PurePosixPath
from typing import Dict, Iterator, List, Optional, Set, Tuple

from repro_torch.analysis.common import (CSRC_DIR, KERNELS_DIR, SMOKE, Tree,
                                         Violation, assigned_dict_keys,
                                         missing_file, param_names,
                                         referenced_names,
                                         top_level_functions)

CHECK = "kernel_parity"
REF = KERNELS_DIR + "/ref.py"
OPS = KERNELS_DIR + "/ops.py"
NON_KERNEL_FILES = {"__init__.py", "_build.py", "ops.py", "ref.py"}
MODULE_PREFIX = "repro_torch.kernels."

FnKey = Tuple[str, str]          # (module rel path, function name)


def _is_build_function(call: ast.Call) -> bool:
    f = call.func
    return isinstance(f, ast.Attribute) and f.attr == "function" and \
        isinstance(f.value, ast.Name) and f.value.id == "_build"


class _Kernels:
    """The top-level functions of the kernel modules, the calls between
    them (bare names, resolved within the module or through
    `from repro_torch.kernels.<mod> import name`) and which of them reach
    `_build.function`."""

    def __init__(self, tree: Tree) -> None:
        self.fns: Dict[FnKey, ast.FunctionDef] = {}
        imports: Dict[str, Dict[str, str]] = {}
        for rel in tree.iter_py(KERNELS_DIR):
            if PurePosixPath(rel).name in NON_KERNEL_FILES:
                continue
            mod = tree.parse(rel)
            if mod is None:
                continue
            for name, fn in top_level_functions(mod).items():
                self.fns[(rel, name)] = fn
            imports[rel] = {}
            for n in mod.body:
                if isinstance(n, ast.ImportFrom) and n.module and \
                        n.module.startswith(MODULE_PREFIX):
                    src = (f"{KERNELS_DIR}/"
                           f"{n.module[len(MODULE_PREFIX):]}.py")
                    for a in n.names:
                        imports[rel][a.asname or a.name] = src
        self.callees: Dict[FnKey, Set[FnKey]] = {}
        self.sites: Dict[FnKey, List[Tuple[FnKey, ast.Call]]] = {}
        for key, fn in self.fns.items():
            rel = key[0]
            out = set()
            for call in ast.walk(fn):
                if not (isinstance(call, ast.Call)
                        and isinstance(call.func, ast.Name)):
                    continue
                name = call.func.id
                tgt = (rel, name) if (rel, name) in self.fns else \
                    (imports[rel].get(name, ""), name)
                if tgt in self.fns and tgt != key:
                    out.add(tgt)
                    self.sites.setdefault(tgt, []).append((key, call))
            self.callees[key] = out
        self.reach = {k for k, fn in self.fns.items()
                      if any(_is_build_function(c) for c in ast.walk(fn)
                             if isinstance(c, ast.Call))}
        changed = True
        while changed:
            changed = False
            for k, cs in self.callees.items():
                if k not in self.reach and cs & self.reach:
                    self.reach.add(k)
                    changed = True

    def kernels(self) -> List[Tuple[str, str, int]]:
        helpers = {c for k in self.reach for c in self.callees[k]}
        return sorted((rel, name, self.fns[(rel, name)].lineno)
                      for rel, name in self.reach
                      if not name.startswith("_")
                      and (rel, name) not in helpers)

    def _resolve(self, key: FnKey, nodes: Tuple[ast.expr, ...],
                 depth: int = 0) -> Iterator[Tuple[Optional[str], ...]]:
        """The string values the expressions `nodes` take together inside
        function `key`: constants, or parameters resolved at each call
        site (its arguments or their defaults), one tuple per site. None
        where a value cannot be resolved."""
        if all(isinstance(n, ast.Constant) and isinstance(n.value, str)
               for n in nodes):
            yield tuple(n.value for n in nodes)
            return
        fn = self.fns[key]
        params = param_names(fn)
        sites = self.sites.get(key, [])
        if depth > 3 or not sites or not all(
                isinstance(n, ast.Constant) or
                (isinstance(n, ast.Name) and n.id in params) for n in nodes):
            yield (None,) * len(nodes)
            return
        pos = [a.arg for a in fn.args.posonlyargs + fn.args.args]
        defaults = dict(zip(pos[len(pos) - len(fn.args.defaults):],
                            fn.args.defaults))
        defaults.update({a.arg: d for a, d in zip(fn.args.kwonlyargs,
                                                  fn.args.kw_defaults)
                         if d is not None})
        for caller, call in sites:
            args = []
            for n in nodes:
                if isinstance(n, ast.Constant):
                    args.append(n)
                    continue
                arg = next((kw.value for kw in call.keywords
                            if kw.arg == n.id), None)
                if arg is None and n.id in pos and \
                        pos.index(n.id) < len(call.args):
                    arg = call.args[pos.index(n.id)]
                if arg is None:
                    arg = defaults.get(n.id)
                args.append(arg if arg is not None else ast.Name(id=""))
            yield from self._resolve(caller, tuple(args), depth + 1)

    def launcher_symbols(self) -> List[Tuple[str, int, Optional[str],
                                             Optional[str]]]:
        """(module, line, source, symbol) of every `_build.function`
        call, for each pair of values its two first arguments take."""
        out = set()
        for key, fn in self.fns.items():
            for call in ast.walk(fn):
                if not (isinstance(call, ast.Call)
                        and _is_build_function(call)):
                    continue
                if len(call.args) < 2:
                    out.add((key[0], call.lineno, None, None))
                    continue
                for src, sym in self._resolve(key, tuple(call.args[:2])):
                    out.add((key[0], call.lineno, src, sym))
        return sorted(out, key=lambda t: (t[0], t[1], str(t[2]), str(t[3])))


def find_kernels(tree: Tree) -> List[Tuple[str, str, int]]:
    """(module_rel, name, lineno) for every kernel wrapper (module
    docstring)."""
    return _Kernels(tree).kernels()


def extern_c_symbols(text: str) -> Set[str]:
    """Names of the `extern "C"` function definitions in CUDA source."""
    out = set()
    for m in re.finditer(r'extern\s+"C"\s+[^;{(]*?\b(\w+)\s*\(', text):
        rest = text[m.end():]
        depth, i = 1, 0
        while i < len(rest) and depth:
            depth += {"(": 1, ")": -1}.get(rest[i], 0)
            i += 1
        if rest[i:].lstrip().startswith("{"):
            out.add(m.group(1))
    return out


def _is_cuda_marked(dec: ast.expr) -> bool:
    node = dec.func if isinstance(dec, ast.Call) else dec
    return isinstance(node, ast.Attribute) and node.attr == "cuda" and \
        isinstance(node.value, ast.Attribute) and node.value.attr == "mark"


def _cuda_tests(tree: Tree) -> List[Set[str]]:
    """The names each cuda-marked test function of tests/test_torch_*.py
    references (decorators included: a parametrize names its kernels);
    module-level `pytestmark` marks every test of its file."""
    out = []
    for rel in tree.tests():
        mod = tree.parse(rel)
        if mod is None:
            continue
        marked_module = any(
            isinstance(n, ast.Assign)
            and any(isinstance(t, ast.Name) and t.id == "pytestmark"
                    for t in n.targets)
            and any(_is_cuda_marked(e) for e in ast.walk(n.value)
                    if isinstance(e, ast.expr))
            for n in mod.body)
        for n in ast.walk(mod):
            if isinstance(n, ast.FunctionDef) and n.name.startswith("test"):
                if marked_module or any(_is_cuda_marked(d)
                                        for d in n.decorator_list):
                    out.append(referenced_names(n))
    return out


def run(tree: Tree) -> List[Violation]:
    violations: List[Violation] = []
    ks = _Kernels(tree)
    kernels = ks.kernels()

    ref_mod = tree.parse(REF)
    ops_mod = tree.parse(OPS)
    ref_names = set(top_level_functions(ref_mod)) if ref_mod else set()
    ops_names = set(top_level_functions(ops_mod)) if ops_mod else set()
    smoke = tree.parse(SMOKE)
    phase2 = assigned_dict_keys(smoke, "KERNEL_SOURCES") if smoke else None
    if kernels and ref_mod is None:
        violations.append(missing_file(CHECK, REF,
                                       "plain versions live here"))
    if kernels and ops_mod is None:
        violations.append(missing_file(CHECK, OPS,
                                       "dispatch entries live here"))
    if kernels and phase2 is None:
        violations.append(missing_file(
            CHECK, SMOKE, "phase 2's KERNEL_SOURCES dict lives here"))

    tests = _cuda_tests(tree)
    for rel, name, lineno in kernels:
        oracle = name + "_ref"
        if ref_mod is not None and oracle not in ref_names:
            violations.append(Violation(
                CHECK, rel, lineno,
                f"CUDA kernel '{name}' has no plain version '{oracle}' in "
                f"kernels/ref.py"))
        if ops_mod is not None and name not in ops_names:
            violations.append(Violation(
                CHECK, rel, lineno,
                f"CUDA kernel '{name}' has no dispatch entry "
                f"'def {name}' in kernels/ops.py"))
        if not any(name in refs and oracle in refs for refs in tests):
            violations.append(Violation(
                CHECK, rel, lineno,
                f"no cuda-marked test in tests/test_torch_*.py names both "
                f"'{name}' and '{oracle}' (kernel-vs-plain comparison "
                f"missing)"))
        if phase2 is not None and name not in phase2:
            violations.append(Violation(
                CHECK, rel, lineno,
                f"CUDA kernel '{name}' has no KERNEL_SOURCES entry in "
                f"chip_smoke.py (no phase-2 case on the card)"))

    texts: Dict[str, Optional[Set[str]]] = {}
    for rel, line, src, sym in ks.launcher_symbols():
        if src is None or sym is None:
            violations.append(Violation(
                CHECK, rel, line,
                "cannot resolve the source and symbol of this "
                "_build.function call to string constants"))
            continue
        cu = f"{CSRC_DIR}/{src}.cu"
        if cu not in texts:
            text = tree.read(cu)
            texts[cu] = None if text is None else extern_c_symbols(text)
        if texts[cu] is None:
            violations.append(Violation(
                CHECK, rel, line,
                f"_build.function names source '{src}', but {cu} is "
                f"missing"))
        elif sym not in texts[cu]:
            violations.append(Violation(
                CHECK, rel, line,
                f"symbol '{sym}' is no extern \"C\" definition in {cu}"))
    return violations
