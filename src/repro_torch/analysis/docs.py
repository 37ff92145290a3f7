"""Check 6 — DESIGN.md cross-reference integrity over the port's files (the
counterpart of the JAX package's `docs_xref`).

Every `DESIGN.md §N` citation in the port's scope — src/repro_torch,
tests/test_torch_*.py, chip_smoke.py and the CUDA sources — must resolve
to a real `## §N` section header, and the numbered sections themselves
must be contiguous from §1, so a renumbered section makes every stale
citation fail instead of silently pointing at the wrong design note. A
raw text scan: citations live in comments and docstrings.
"""
from __future__ import annotations

import re
from typing import List, Optional, Set

from repro_torch.analysis.common import Tree, Violation, missing_file

CHECK = "docs_xref"
DESIGN = "DESIGN.md"

CITATION = re.compile(r"DESIGN\.md §(\d+)")
HEADER = re.compile(r"^## §(\d+)")


def sections_of(tree: Tree) -> Optional[Set[int]]:
    """Numbered `## §N` headers of DESIGN.md; None when the file is
    missing."""
    text = tree.read(DESIGN)
    if text is None:
        return None
    return {int(m.group(1)) for line in text.splitlines()
            for m in [HEADER.match(line)] if m}


def run(tree: Tree) -> List[Violation]:
    secs = sections_of(tree)
    if secs is None:
        return [missing_file(CHECK, DESIGN, "section headers live here")]
    violations: List[Violation] = []
    if not secs:
        violations.append(Violation(
            CHECK, DESIGN, 1, "no numbered `## §N` sections found"))
    elif secs != set(range(1, max(secs) + 1)):
        missing = sorted(set(range(1, max(secs) + 1)) - secs)
        violations.append(Violation(
            CHECK, DESIGN, 1,
            f"numbered sections must be contiguous from §1: "
            f"§{', §'.join(str(s) for s in missing)} missing "
            f"(present: {sorted(secs)})"))

    for rel in tree.port_py() + tree.csrc():
        src = tree.read(rel)
        if src is None:
            continue
        for lineno, line in enumerate(src.splitlines(), start=1):
            for n in CITATION.findall(line):
                if int(n) not in secs:
                    violations.append(Violation(
                        CHECK, rel, lineno,
                        f"citation 'DESIGN.md §{n}' does not resolve to "
                        f"any `## §{n}` header"))
    return violations
