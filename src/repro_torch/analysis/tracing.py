"""Check 4 — sync safety (the port's counterpart of the JAX package's
`tracing_safety`, DESIGN.md §15).

On the card the hazard is not a tracer but a host sync on a device
tensor: `bool(t)`, `float(t)`, `int(t)`, `t.item()`, `t.tolist()`,
`t.cpu()`, `t.numpy()`, `torch.nonzero(t)` (its shape depends on the
data), or an `if` / `while` / `assert` / conditional expression on a
tensor. Each one stalls the host until the stream drains, and a stream
that syncs cannot be captured into a CUDA graph.

Scope (the code a search runs, once per query batch or per iteration):
  - the query path: core/search.py, core/queue.py and the search half of
    core/ivf.py (every function but the build's, BUILD_HALF);
  - core/build.py::stable_topk_smallest (the stable top-k of the search's
    probes, merges and re-ranks);
  - the kernel wrappers of kernels/*.py (the dispatch in ops.py and the
    ctypes launchers; not the plain versions in ref.py nor _build.py).

Taint starts at the tensor parameters — those annotated with a tensor or
a tensor-holding state type, and unannotated ones (closures such as a
`dist_fn(queries, nbr_ids)`) — and follows assignments to a fixpoint, as
in the reference. It is cut by the metadata a tensor carries on the host
(`.shape`, `.ndim`, `.dtype`, `.device`, `.is_cuda`, `dim()`,
`is_contiguous()`, `data_ptr()`, ...), by the host fields of the state
types (an IVFState's `nlist`, `max_len`, `packed`, `residual`), by
`len()` and by `is None` comparisons.

Every sync that exists is listed in ALLOWED with one line of reason: the
allowlist is the input to CUDA-graph capture of the search (ROADMAP queue
1 item 2). A new sync fails the lint, and so does an entry that matches
no sync any more. Entries are keyed by (file, function, source of the
sync), not by line, so an edit elsewhere in the file keeps them.

This check lists the syncs statically; at run time the span recorder
(`repro_torch/spans.py`) counts them: each of the two syncs ALLOWED
holds adds one `sync` count where it runs, and no other site does
(`tests/test_torch_spans.py` holds the counts to `SearchStats`).
"""
from __future__ import annotations

import ast
import dataclasses
from pathlib import PurePosixPath
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.common import (KERNELS_DIR, PKG, Tree, Violation,
                                         param_names)

CHECK = "sync_safety"
SEARCH = PKG + "/core/search.py"
QUEUE = PKG + "/core/queue.py"
IVF = PKG + "/core/ivf.py"
BUILD = PKG + "/core/build.py"
# the build half of core/ivf.py, outside the query path
BUILD_HALF = {"auto_nlist", "_assign", "build_ivf"}
NON_WRAPPER_FILES = {"__init__.py", "_build.py", "ref.py"}

# Host metadata of a tensor, and the host fields of the port's state
# types: reading them from a device value yields a host value.
STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "nlist",
                "max_len", "packed", "residual", "m", "ksub"}
STATIC_METHODS = {"dim", "size", "numel", "is_contiguous", "data_ptr",
                  "element_size", "stride", "storage_offset"}
STATIC_CALLS = {"len", "isinstance", "hasattr", "type", "range", "id"}
# Python casts that sync when fed a device tensor.
CAST_CALLS = {"float", "int", "bool"}
# Tensor methods that copy to the host (and so sync).
HOST_METHODS = {"item", "tolist", "cpu", "numpy"}
# Annotations that mark a parameter as device data.
TENSOR_TYPES = {"Tensor", "Queue", "IVFState", "PQState", "SQState",
                "BinState", "SearchStats"}

# (file, function, source of the sync) -> why it stays, for now
ALLOWED: Dict[Tuple[str, str, str], str] = {
    (SEARCH, "search", "bool(active.any())"):
        "the traversal's loop exit: one sync an iteration reads whether "
        "any query is still active",
    (BUILD, "stable_topk_smallest", "torch.nonzero(tied)"):
        "the rows with a tie among the k+1 smallest are redone on "
        "distinct keys; their count sizes that redo",
}


@dataclasses.dataclass(frozen=True)
class Sync:
    """One host sync found in scope."""
    path: str
    line: int
    function: str
    source: str
    kind: str

    @property
    def key(self) -> Tuple[str, str, str]:
        return (self.path, self.function, self.source)


def _is_none_compare(test: ast.expr) -> bool:
    return isinstance(test, ast.Compare) and \
        all(isinstance(op, (ast.Is, ast.IsNot)) for op in test.ops)


def _annotation_names(node: Optional[ast.expr]) -> Set[str]:
    if node is None:
        return set()
    if isinstance(node, ast.Constant) and isinstance(node.value, str):
        try:
            node = ast.parse(node.value, mode="eval").body
        except SyntaxError:
            return set()
    return {n.id if isinstance(n, ast.Name) else n.attr
            for n in ast.walk(node)
            if isinstance(n, (ast.Name, ast.Attribute))}


def _tensor_params(fn) -> Set[str]:
    """Parameters holding device data: annotated with a tensor type, or
    not annotated at all (self and cls aside)."""
    a = fn.args
    out = set()
    for p in a.posonlyargs + a.args + a.kwonlyargs + \
            [x for x in (a.vararg, a.kwarg) if x is not None]:
        if p.arg in ("self", "cls"):
            continue
        if p.annotation is None or \
                _annotation_names(p.annotation) & TENSOR_TYPES:
            out.add(p.arg)
    return out


def _to_host(node: ast.Call) -> bool:
    """A cast or a copy to the host: its result is host data, whatever
    its argument (the call itself is flagged where it syncs)."""
    f = node.func
    return (isinstance(f, ast.Name) and f.id in CAST_CALLS) or \
        (isinstance(f, ast.Attribute) and f.attr in HOST_METHODS)


class _Taint:
    def __init__(self, seed: Set[str]) -> None:
        self.names = set(seed)

    def expr(self, node: ast.expr) -> bool:
        if isinstance(node, ast.Name):
            return node.id in self.names
        if isinstance(node, ast.Constant):
            return False
        if isinstance(node, ast.Attribute):
            if node.attr in STATIC_ATTRS:
                return False
            return self.expr(node.value)
        if isinstance(node, ast.Compare) and _is_none_compare(node):
            return False
        if isinstance(node, ast.Call):
            f = node.func
            if isinstance(f, ast.Name) and f.id in STATIC_CALLS:
                return False
            if isinstance(f, ast.Attribute) and f.attr in STATIC_METHODS:
                return False
            if _to_host(node):
                return False
            parts = [f] + list(node.args) + \
                [kw.value for kw in node.keywords]
            return any(self.expr(p) for p in parts)
        if isinstance(node, (ast.Lambda, ast.FunctionDef)):
            return False
        return any(self.expr(c) for c in ast.iter_child_nodes(node)
                   if isinstance(c, ast.expr))

    def _taint_target(self, target: ast.expr) -> bool:
        changed = False
        for n in ast.walk(target):
            if isinstance(n, ast.Name) and n.id not in self.names:
                self.names.add(n.id)
                changed = True
        return changed

    def propagate(self, fn) -> None:
        """Fixpoint pass: assignments from tainted expressions taint
        their targets, loops over tainted iterables their targets, and
        the tensor parameters of nested functions start tainted."""
        changed = True
        while changed:
            changed = False
            for n in ast.walk(fn):
                if isinstance(n, (ast.FunctionDef, ast.Lambda)) and \
                        n is not fn:
                    seed = (_tensor_params(n) if isinstance(n, ast.FunctionDef)
                            else set(param_names(n)))
                    if not seed <= self.names:
                        self.names |= seed
                        changed = True
                elif isinstance(n, ast.Assign):
                    if self.expr(n.value):
                        for t in n.targets:
                            changed |= self._taint_target(t)
                elif isinstance(n, (ast.AnnAssign, ast.AugAssign,
                                    ast.NamedExpr)):
                    if n.value is not None and self.expr(n.value):
                        changed |= self._taint_target(n.target)
                elif isinstance(n, (ast.For, ast.comprehension)):
                    if self.expr(n.iter):
                        changed |= self._taint_target(n.target)


def _syncs_in(fn: ast.FunctionDef, rel: str) -> List[Sync]:
    taint = _Taint(_tensor_params(fn))
    taint.propagate(fn)
    out = []

    def add(node, kind, src_node):
        out.append(Sync(rel, node.lineno, fn.name, ast.unparse(src_node),
                        kind))

    for n in ast.walk(fn):
        if isinstance(n, (ast.If, ast.While, ast.IfExp, ast.Assert)):
            kind = {"If": "if", "While": "while", "Assert": "assert",
                    "IfExp": "conditional expression"}[type(n).__name__]
            if not _is_none_compare(n.test) and taint.expr(n.test):
                add(n, f"`{kind}` on a tensor", n.test)
        elif isinstance(n, ast.Call):
            f = n.func
            if isinstance(f, ast.Name) and f.id in CAST_CALLS:
                if n.args and taint.expr(n.args[0]):
                    add(n, f"`{f.id}()` of a tensor", n)
            elif isinstance(f, ast.Attribute) and f.attr in HOST_METHODS:
                if taint.expr(f.value):
                    add(n, f"`.{f.attr}()` of a tensor", n)
            elif isinstance(f, ast.Attribute) and f.attr == "nonzero":
                target = f.value if not (isinstance(f.value, ast.Name)
                                         and f.value.id == "torch") \
                    else (n.args[0] if n.args else None)
                if target is not None and taint.expr(target):
                    add(n, "`nonzero` (a data-dependent shape)", n)
    return out


def _scope(tree: Tree) -> List[Tuple[str, ast.FunctionDef]]:
    """(file, top-level function) pairs the check scans."""
    out = []
    files = [SEARCH, QUEUE, IVF, BUILD] + [
        rel for rel in tree.iter_py(KERNELS_DIR)
        if PurePosixPath(rel).name not in NON_WRAPPER_FILES]
    for rel in files:
        mod = tree.parse(rel)
        if mod is None:
            continue
        for fn in mod.body:
            if not isinstance(fn, ast.FunctionDef):
                continue
            if rel == IVF and fn.name in BUILD_HALF:
                continue
            if rel == BUILD and fn.name != "stable_topk_smallest":
                continue
            out.append((rel, fn))
    return out


def syncs(tree: Tree) -> List[Sync]:
    """Every host sync in scope, allowlisted or not, in file order."""
    out = []
    for rel, fn in _scope(tree):
        out.extend(_syncs_in(fn, rel))
    return sorted(set(out), key=lambda s: (s.path, s.line, s.source))


def run(tree: Tree) -> List[Violation]:
    violations: List[Violation] = []
    found = syncs(tree)
    for s in found:
        if s.key not in ALLOWED:
            violations.append(Violation(
                CHECK, s.path, s.line,
                f"host sync: {s.kind} in '{s.function}' "
                f"(`{s.source}`) — it stalls the stream and blocks CUDA-"
                f"graph capture; remove it or list it in "
                f"analysis/tracing.py ALLOWED with its reason"))
    keys = {s.key for s in found}
    for key in ALLOWED:
        if tree.exists(key[0]) and key not in keys:
            violations.append(Violation(
                CHECK, key[0], 1,
                f"ALLOWED entry ({key[1]}: `{key[2]}`) matches no sync any "
                f"more — remove it from analysis/tracing.py"))
    return violations


def report(tree: Tree) -> str:
    """The --report table: every allowlisted sync with its line."""
    rows = ["allowlisted host syncs (the input to CUDA-graph capture):"]
    for s in syncs(tree):
        if s.key in ALLOWED:
            rows.append(f"  {s.path}:{s.line} {s.function}: `{s.source}` "
                        f"— {ALLOWED[s.key]}")
    return "\n".join(rows)
