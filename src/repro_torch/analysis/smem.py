"""Check 5 — shared-memory budget of every CUDA kernel (the port's
counterpart of the JAX package's `vmem_budget`, DESIGN.md §15).

Per `__global__` function of kernels/csrc/*.cu, the shared memory one
block holds is its static `__shared__` arrays (their dimensions evaluated
from the file's `constexpr` constants and those of the headers it
includes) plus the dynamic bytes its launcher asks for. The dynamic bytes
are not in the kernel: DYNAMIC below writes each launcher's formula over
the shapes of WORST and TUNED, as vmem.DIMS binds the reference's
BlockSpec shapes.
A kernel that declares `extern __shared__` memory without a DYNAMIC entry
is a violation: the estimate would be vacuous.

Two budgets of the H100 (sm_90):
  - per block, 227 KiB (the opt-in maximum), at WORST: the largest shapes
    the launchers accept (MAX_C = 4096 candidates, d = 1024, tables of
    m = 64 x K = 256, lists of 4,096 slots); past it a launch fails;
  - per SM, 228 KiB: the `__launch_bounds__` minimum of resident blocks,
    each with the 1 KiB the runtime reserves a block, at TUNED: the
    shapes phase 2 of chip_smoke.py times and the launch bounds were
    chosen at (Deep1M: d = 96, C = 96, PQ m = 16 x K = 256, lists of
    2,176 slots). Past it the register cap that the minimum buys is
    spent for blocks that can never be resident.
Where launch bounds name a template's members (`Rows::kMinBlocks`),
MIN_BLOCKS gives the largest value over the kernel's instantiations.

`static_bytes` is also what chip_smoke.py holds against the `bytes smem`
that ptxas prints for each instantiation: the estimate must not be lower.
"""
from __future__ import annotations

import dataclasses
import re
from pathlib import PurePosixPath
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis.common import CSRC_DIR, Tree, Violation

CHECK = "smem_budget"
BLOCK_BUDGET = 227 * 1024
SM_BUDGET = 228 * 1024
RESERVED_PER_BLOCK = 1024

# the largest shapes the launchers accept (per-block budget)
WORST: Dict[str, int] = {
    "d": 1024, "nw": 32, "m": 64, "K": 256, "C": 4096, "L": 4096,
    "max_len": 4096, "P2": 4096,
}
# phase 2's main-path shapes at Deep1M (per-SM budget)
TUNED: Dict[str, int] = {
    "d": 96, "nw": 3, "m": 16, "K": 256, "C": 96, "L": 768,
    "max_len": 2176, "P2": 128,
}

# (source, kernel) -> the launcher's dynamic bytes, the largest over the
# kernel's instantiations
DYNAMIC: Dict[Tuple[str, str], str] = {
    # As and Bs double-buffered at the widest chunk (stride_of), norms
    ("batch_dist", "batch_dist_kernel"):
        "(2 * (kTile + kTileN) * (kMaxChunk + (8 if (kMaxChunk >> 2) & 1 "
        "else 4)) + kTile + kTileN) * 4",
    # query words, V positions, warp sums, a byte per (warp, value); the
    # 16-bit slot cache; the L staged pairs (bin_ivf_scan_u32)
    ("bin_ivf_scan", "bin_scan_kernel"):
        "align16((nw + 32 * nw + 2 + kWarps + 1) * 4 + kWarps * (32 * nw "
        "+ 2)) + align16(max_len * 2) + L * 8",
    # the fast path (smem_bytes(true, kFastL, m * K, max_len)); the
    # general path with cached keys is smaller at L <= kFastL
    ("ivf_scan", "scan_kernel"):
        "(kFastL + kCandCap + 2) * 8 + (kFastHist + kThreads + kWarps + 8 "
        "+ m * K + max_len) * 4",
    # SQ's 3 * d staged floats (the widest functor), C distances and ids,
    # the bitonic pairs above kWarpSortC
    ("traverse_step", "expand_kernel"):
        "(align4(3 * d) + 2 * C) * 4 + (P2 * 8 if C > kWarpSortC else 0)",
    # PQ4's m x 16 table a warp, only where it fits the default 48 KiB
    ("traverse_step", "warp_step_kernel"):
        "min(kStepWarps * m * 16 * 4, kDefaultSmem)",
    # a tile of queue ids and the row's C ids, for each of kRowWarps rows
    # where a warp takes a row (C <= 32), else for the block's one row
    ("beam_filter", "filter_kernel"):
        "(kRowWarps if C <= 32 else 1) * (min(align4(L), kTileL) "
        "+ align4(C)) * 4",
}
MIN_BLOCKS: Dict[Tuple[str, str], str] = {
    ("gather_dist", "gather_kernel"): "max(kF32MinBlocks, kSqMinBlocks)",
    ("traverse_step", "expand_kernel"):
        "max(kGroupMinBlocks, kPqMinBlocks, kThreadMinBlocks)",
}

TYPE_BYTES = {"char": 1, "unsigned char": 1, "uint8_t": 1, "int8_t": 1,
              "short": 2, "unsigned short": 2, "__half": 2, "half": 2,
              "uint16_t": 2, "int": 4, "unsigned": 4, "unsigned int": 4,
              "float": 4, "int32_t": 4, "uint32_t": 4, "u32": 4,
              "double": 8, "long long": 8, "u64": 8, "uint64_t": 8,
              "int64_t": 8, "float2": 8, "int2": 8, "uint2": 8,
              "float4": 16, "int4": 16, "uint4": 16}
HELPERS = {"align16": lambda n: (int(n) + 15) & ~15,
           "align4": lambda n: (int(n) + 3) & ~3, "min": min, "max": max}


@dataclasses.dataclass
class KernelSmem:
    """The shared memory of one __global__ function."""
    source: str            # csrc/<source>.cu
    name: str
    line: int
    static_bytes: int
    dynamic: Optional[str]     # DYNAMIC's formula, None when it has none
    uses_dynamic: bool         # declares extern __shared__ memory
    min_blocks: int
    worst_bytes: int           # static + dynamic at WORST
    tuned_bytes: int           # static + dynamic at TUNED
    notes: List[str]

    @property
    def sm_bytes(self) -> int:
        return self.min_blocks * (self.tuned_bytes + RESERVED_PER_BLOCK)


def _c_to_py(expr: str) -> str:
    expr = re.sub(r"\b(0x[0-9a-fA-F]+|\d+)(?:[uU]?[lL]{0,2}|[lL]{1,2}[uU]?)\b",
                  r"\1", expr)
    expr = re.sub(r"static_cast<[^>]*>", "", expr)
    expr = re.sub(r"sizeof\(float\)|sizeof\(int\)", "4", expr)
    return expr.replace("/", "//")


def _eval(expr: str, ns: Dict[str, object]) -> Optional[int]:
    try:
        return int(eval(compile(expr, "<smem>", "eval"),
                        {"__builtins__": {}}, dict(ns)))
    except Exception:
        return None


def constants(text: str, ns: Optional[Dict[str, int]] = None
              ) -> Dict[str, int]:
    """The integer `constexpr` constants declared at the start of a line
    (namespace scope) that evaluate, in order."""
    ns = dict(ns or {})
    for m in re.finditer(r"^constexpr\s+[\w\s]+?\s+(\w+\s*=[^;]*);", text,
                         re.M):
        if "(" in m.group(0).split("=")[0]:
            continue                     # a constexpr function
        for part in re.split(r",(?![^(]*\))", m.group(1)):
            name, _, expr = part.partition("=")
            if "?" in expr:
                continue
            val = _eval(_c_to_py(expr.strip()), ns)
            if val is not None:
                ns[name.strip()] = val
    return ns


def _balanced(text: str, start: int, open_c: str, close_c: str) -> int:
    """Index just past the bracket that closes the one at `start`."""
    depth = 0
    for i in range(start, len(text)):
        if text[i] == open_c:
            depth += 1
        elif text[i] == close_c:
            depth -= 1
            if depth == 0:
                return i + 1
    return len(text)


def globals_of(text: str) -> List[Tuple[str, int, Optional[str], str]]:
    """(name, line, launch-bounds arguments or None, body) of every
    __global__ function in CUDA source."""
    out = []
    for m in re.finditer(r"__global__\s+void\s+", text):
        i = m.end()
        bounds = None
        if text.startswith("__launch_bounds__", i):
            j = text.index("(", i)
            end = _balanced(text, j, "(", ")")
            bounds = text[j + 1:end - 1]
            i = end
        nm = re.match(r"\s*(\w+)\s*\(", text[i:])
        if nm is None:
            continue
        params_at = i + nm.end() - 1
        body_at = text.index("{", _balanced(text, params_at, "(", ")"))
        body = text[body_at:_balanced(text, body_at, "{", "}")]
        out.append((nm.group(1), text.count("\n", 0, m.start()) + 1,
                    bounds, body))
    return out


def _static_bytes(body: str, ns: Dict[str, int], notes: List[str]) -> int:
    total = 0
    for m in re.finditer(r"(?<!extern )__shared__\s+(?:__align__\(\d+\)\s+)?"
                         r"([\w ]+?)\s+(\w+)((?:\s*\[[^\]]+\])+)\s*;", body):
        ctype = " ".join(m.group(1).replace("const", "").split())
        size = TYPE_BYTES.get(ctype)
        if size is None:
            notes.append(f"unknown shared type '{ctype}' of {m.group(2)}")
            continue
        n = 1
        for dim in re.findall(r"\[([^\]]+)\]", m.group(3)):
            val = _eval(_c_to_py(dim), ns)
            if val is None:
                notes.append(f"unresolved dim '{dim}' of {m.group(2)}")
                break
            n *= val
        total += size * n
    return total


def estimate(tree: Tree) -> List[KernelSmem]:
    out: List[KernelSmem] = []
    headers: Dict[str, Dict[str, int]] = {}
    for rel in tree.csrc():
        if rel.endswith(".cuh"):
            headers[PurePosixPath(rel).name] = constants(tree.read(rel) or "")
    for rel in tree.csrc():
        if not rel.endswith(".cu"):
            continue
        text = tree.read(rel) or ""
        ns: Dict[str, int] = {}
        for inc in re.findall(r'#include\s+"([^"]+)"', text):
            ns.update(headers.get(inc, {}))
        ns = constants(text, ns)
        source = PurePosixPath(rel).stem
        for name, line, bounds, body in globals_of(text):
            notes: List[str] = []
            static = _static_bytes(body, ns, notes)
            uses_dyn = re.search(r"extern\s+__shared__", body) is not None
            dyn = DYNAMIC.get((source, name))
            mb_expr = MIN_BLOCKS.get((source, name))
            if mb_expr is None:
                args = [] if bounds is None else \
                    re.split(r",(?![^(]*\))", bounds)
                mb_expr = args[1] if len(args) > 1 else "1"
            min_blocks = _eval(_c_to_py(mb_expr.strip()), {**ns, **HELPERS})
            if min_blocks is None:
                notes.append(f"unresolved minimum blocks '{mb_expr}'")
                min_blocks = 1
            sized = {}
            for label, dims in (("worst", WORST), ("tuned", TUNED)):
                extra = 0
                if dyn is not None:
                    extra = _eval(dyn, {**ns, **dims, **HELPERS})
                    if extra is None:
                        notes.append(f"unresolved dynamic bytes '{dyn}'")
                        extra = 0
                sized[label] = static + extra
            out.append(KernelSmem(source, name, line, static, dyn, uses_dyn,
                                  min_blocks, sized["worst"], sized["tuned"],
                                  notes))
    return out


def run(tree: Tree) -> List[Violation]:
    violations: List[Violation] = []
    for k in estimate(tree):
        path = f"{CSRC_DIR}/{k.source}.cu"
        for note in k.notes:
            violations.append(Violation(
                CHECK, path, k.line,
                f"kernel '{k.name}': {note} — the estimate would be "
                f"vacuous"))
        if k.uses_dynamic and k.dynamic is None:
            violations.append(Violation(
                CHECK, path, k.line,
                f"kernel '{k.name}' declares extern __shared__ memory but "
                f"analysis/smem.py DYNAMIC has no formula for its "
                f"launcher's bytes"))
        if k.worst_bytes > BLOCK_BUDGET:
            violations.append(Violation(
                CHECK, path, k.line,
                f"kernel '{k.name}' takes {k.worst_bytes / 1024:.1f} KiB of "
                f"shared memory a block at the largest shapes "
                f"({k.static_bytes} static), over the "
                f"{BLOCK_BUDGET // 1024} KiB a block may opt into"))
        if k.sm_bytes > SM_BUDGET:
            violations.append(Violation(
                CHECK, path, k.line,
                f"kernel '{k.name}': its __launch_bounds__ minimum of "
                f"{k.min_blocks} blocks x ({k.tuned_bytes / 1024:.1f} KiB + "
                f"1 KiB reserved) = {k.sm_bytes / 1024:.1f} KiB exceeds the "
                f"{SM_BUDGET // 1024} KiB of an SM at phase 2's shapes"))
    return violations


def report(tree: Tree) -> str:
    """The --report table: per-kernel shared memory and budgets."""
    rows = [f"{'source':<14} {'kernel':<18} {'static':>7} {'worst KiB':>10} "
            f"{'tuned KiB':>10} {'min blk':>7} {'SM KiB':>7}  notes"]
    for k in estimate(tree):
        rows.append(
            f"{k.source:<14} {k.name:<18} {k.static_bytes:>7} "
            f"{k.worst_bytes / 1024:>10.1f} {k.tuned_bytes / 1024:>10.1f} "
            f"{k.min_blocks:>7} {k.sm_bytes / 1024:>7.1f}  "
            f"{'; '.join(k.notes)}")
    rows.append(f"budgets: {BLOCK_BUDGET // 1024} KiB a block at the "
                f"largest shapes, {SM_BUDGET // 1024} KiB an SM at phase "
                f"2's (min blocks x (bytes + 1 KiB))")
    return "\n".join(rows)
