"""Shared plumbing of the port's lint (the counterpart of the JAX
package's `repro/analysis/common.py`, DESIGN.md §15).

Everything here is pure `ast` and text over the files of a checkout — the
checks never import the modules they inspect, so the lint runs without
torch or a GPU and on seeded-violation fixture trees that are broken on
purpose.

The scope is the port's own files: `src/repro_torch/**/*.py`,
`tests/test_torch_*.py`, `chip_smoke.py`, and the CUDA sources
`src/repro_torch/kernels/csrc/*.{cu,cuh}`, read as text.
"""
from __future__ import annotations

import ast
import dataclasses
from pathlib import Path
from typing import Dict, Iterator, List, Optional, Set, Tuple

# Directories never scanned: fixture trees hold deliberate violations,
# __pycache__ holds no source.
EXCLUDED_DIRS = {"analysis_fixtures", "__pycache__"}

PKG = "src/repro_torch"
KERNELS_DIR = PKG + "/kernels"
CSRC_DIR = KERNELS_DIR + "/csrc"
SMOKE = "chip_smoke.py"
TESTS_DIR = "tests"
TESTS_GLOB = "test_torch_*.py"


@dataclasses.dataclass(frozen=True)
class Violation:
    """One lint finding, pointing at a repo-relative file:line."""
    check: str
    path: str
    line: int
    message: str

    def __str__(self) -> str:
        return f"{self.path}:{self.line}: [{self.check}] {self.message}"


class Tree:
    """Lazy view of a checkout rooted at a directory holding src/ (and
    usually tests/ and chip_smoke.py). Parsed modules are cached; files
    that are missing or unparsable parse to None — checks that require
    them report that as a violation rather than crashing, which is what
    lets minimal fixture trees fire each check."""

    def __init__(self, root) -> None:
        self.root = Path(root)
        self._cache: Dict[str, Optional[ast.Module]] = {}

    def exists(self, rel: str) -> bool:
        return (self.root / rel).is_file()

    def read(self, rel: str) -> Optional[str]:
        try:
            return (self.root / rel).read_text()
        except (OSError, UnicodeDecodeError):
            return None

    def parse(self, rel: str) -> Optional[ast.Module]:
        if rel not in self._cache:
            src = self.read(rel)
            try:
                self._cache[rel] = (None if src is None else
                                    ast.parse(src, filename=rel))
            except (SyntaxError, ValueError):
                self._cache[rel] = None
        return self._cache[rel]

    def _files(self, sub: str, pattern: str) -> Iterator[str]:
        base = self.root / sub
        if not base.is_dir():
            return
        for p in sorted(base.rglob(pattern)):
            rel = p.relative_to(self.root)
            # exclusion is root-relative: a fixture tree scanned AS the
            # root is fully visible, but fixture trees inside a scanned
            # checkout stay invisible
            if EXCLUDED_DIRS.intersection(rel.parts):
                continue
            yield rel.as_posix()

    def iter_py(self, *subdirs: str) -> Iterator[str]:
        """Repo-relative paths of every .py under the given subtrees,
        sorted, with EXCLUDED_DIRS pruned."""
        for sub in subdirs:
            yield from self._files(sub, "*.py")

    def tests(self) -> List[str]:
        """The port's test files, tests/test_torch_*.py."""
        base = self.root / TESTS_DIR
        if not base.is_dir():
            return []
        return sorted(f"{TESTS_DIR}/{p.name}"
                      for p in base.glob(TESTS_GLOB) if p.is_file())

    def port_py(self) -> List[str]:
        """Every Python file of the port's scope: the package, its tests
        and chip_smoke.py."""
        out = list(self.iter_py(PKG)) + self.tests()
        if self.exists(SMOKE):
            out.append(SMOKE)
        return out

    def csrc(self) -> List[str]:
        """The CUDA sources and headers of the kernels, sorted."""
        return sorted(list(self._files(CSRC_DIR, "*.cu"))
                      + list(self._files(CSRC_DIR, "*.cuh")))


def missing_file(check: str, rel: str, why: str) -> Violation:
    return Violation(check, rel, 1, f"expected file is missing or "
                     f"unparsable ({why})")


# ---------------------------------------------------------------- AST helpers

def top_level_functions(mod: ast.Module) -> Dict[str, ast.FunctionDef]:
    return {n.name: n for n in mod.body if isinstance(n, ast.FunctionDef)}


def class_def(mod: ast.Module, name: str) -> Optional[ast.ClassDef]:
    for n in mod.body:
        if isinstance(n, ast.ClassDef) and n.name == name:
            return n
    return None


def methods_of(cls: ast.ClassDef) -> Dict[str, ast.FunctionDef]:
    return {n.name: n for n in cls.body if isinstance(n, ast.FunctionDef)}


def dataclass_fields(cls: ast.ClassDef) -> List[Tuple[str, int]]:
    """(name, lineno) of annotated fields — how frozen-dataclass configs
    declare their knobs (AnnAssign with a plain Name target)."""
    out = []
    for n in cls.body:
        if isinstance(n, ast.AnnAssign) and isinstance(n.target, ast.Name):
            out.append((n.target.id, n.lineno))
    return out


def referenced_names(node: ast.AST) -> Set[str]:
    """Every Name id, Attribute attr and string constant under `node` —
    the loose 'does this code mention token X' relation used for
    parity-test and registry-usage checks (a parametrized test names its
    kernels as strings)."""
    out: Set[str] = set()
    for n in ast.walk(node):
        if isinstance(n, ast.Name):
            out.add(n.id)
        elif isinstance(n, ast.Attribute):
            out.add(n.attr)
        elif isinstance(n, ast.Constant) and isinstance(n.value, str):
            out.add(n.value)
    return out


def string_constants(node: ast.AST) -> Set[str]:
    return {n.value for n in ast.walk(node)
            if isinstance(n, ast.Constant) and isinstance(n.value, str)}


def calls_to(node: ast.AST, fn_name: str) -> Iterator[ast.Call]:
    """Call sites of `fn_name`, whether spelled bare or as an attribute
    (`_build.function` and `function` both match 'function')."""
    for n in ast.walk(node):
        if isinstance(n, ast.Call):
            f = n.func
            if (isinstance(f, ast.Name) and f.id == fn_name) or \
                    (isinstance(f, ast.Attribute) and f.attr == fn_name):
                yield n


def assigned_tuple_of_strings(mod: ast.Module, var: str
                              ) -> Optional[Tuple[str, ...]]:
    """Value of a module-level `VAR = ("a", "b", ...)` assignment."""
    for n in mod.body:
        if isinstance(n, ast.Assign) and any(
                isinstance(t, ast.Name) and t.id == var for t in n.targets):
            if isinstance(n.value, (ast.Tuple, ast.List)):
                elts = n.value.elts
                if all(isinstance(e, ast.Constant) and
                       isinstance(e.value, str) for e in elts):
                    return tuple(e.value for e in elts)
    return None


def assigned_dict_keys(mod: ast.Module, var: str) -> Optional[Dict[str, int]]:
    """String keys (with their lines) of a module-level `VAR = {...}`."""
    for n in mod.body:
        targets = n.targets if isinstance(n, ast.Assign) else \
            [n.target] if isinstance(n, ast.AnnAssign) else []
        if any(isinstance(t, ast.Name) and t.id == var for t in targets) \
                and isinstance(n.value, ast.Dict):
            return {k.value: k.lineno for k in n.value.keys
                    if isinstance(k, ast.Constant)
                    and isinstance(k.value, str)}
    return None


def keyword_arg(call: ast.Call, name: str) -> Optional[ast.expr]:
    for kw in call.keywords:
        if kw.arg == name:
            return kw.value
    return None


def param_names(fn) -> List[str]:
    a = fn.args
    params = a.posonlyargs + a.args + a.kwonlyargs
    if a.vararg:
        params = params + [a.vararg]
    if a.kwarg:
        params = params + [a.kwarg]
    return [p.arg for p in params]
