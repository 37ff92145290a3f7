"""Check 7 and the query cost model: the port's counterpart of the JAX
package's `repro/analysis/cost.py` (DESIGN.md §16).

The query half: closed-form FLOPs, bytes and distance counts per kernel
call (`KERNEL_COSTS`), composed into the cost of one search batch

  graph:  seed-dist cost + ceil(hops/W) x fused-expand cost + rerank
  ivf:    coarse probe (Q x nlist) + nprobe x padded list scan + rerank

and `predict_service_s`, the prior of the serving tier's latency model
(`serve.degrade.LatencyModel`), of `configs.kbest.degrade_ladder` and the
price `core/tune.py` orders its candidates by.

Every number here is the reference's, and none is a figure of the H100:
the roofline constants are a Kunpeng 920 socket's, the widths are padded to
the TPU's LANE of 128, and the ADC kernels are priced as the reference's
one-hot MXU matmuls. The prior only ORDERS configs and buckets — the
latency model calibrates its scale against measured dispatches on the
card — so with the same numbers the admission decisions, degrade ladders
and the tuner's pruning equal the reference's.

The check half (`run`, `cost_model`, `report`): every kernel that
parity.find_kernels discovers has a KERNEL_COSTS (or, for the port's own
kernels, PORT_KERNEL_COSTS) entry whose expressions resolve under
`bindings` to positive numbers, and no entry is stale. The
reference's AST grid extraction (the pallas_call `grid=` and its BlockSpec
DMA bound) has no counterpart: the port's launch geometry lives in the
C++ launchers, and a block's shared memory is smem_budget's.

Pure stdlib: the model never imports the code it prices.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis.common import Tree, Violation
from repro_torch.analysis.parity import find_kernels

# Roofline constants for the paper's target part (Kunpeng 920-class
# socket: 48 cores x 2.6 GHz x 2 NEON pipes x 4 f32 lanes ~ 1 Tf32/s;
# 8-channel DDR4-2933 ~ 190 GB/s), the reference's. Only ORDERING between
# configs is asserted anywhere (the JAX package's roofline --smoke
# Spearman), never absolute time; they are no figure of the H100.
PEAK_FLOPS = 1.0e12
MEM_BW = 190e9

# Traversal-length heuristic: lockstep best-first converges after ~1.1*L
# expansions with early termination (BENCH_traverse.json: 71 iterations
# at L=64, W=1) and runs meaningfully longer without it.
HOPS_PER_L_ET = 1.15
HOPS_PER_L_NO_ET = 1.75
# Fraction of gathered neighbors surviving dedupe/visited masks — only
# used for EXPECTED traversal cost, never for the exact n_dist checks.
TRAVERSAL_YIELD = 0.8

LANE = 128


@dataclasses.dataclass(frozen=True)
class Workload:
    """The knob vector every closed-form expression is evaluated at.
    Mirrors IndexConfig/SearchConfig without importing them (the module
    stays stdlib-only); build one from live configs with
    `workload_from`."""

    n: int = 50_000          # corpus size
    d: int = 128             # vector dim (pre lane-padding)
    Q: int = 8               # queries per batch
    k: int = 10              # results returned
    L: int = 192             # candidate queue / scan depth
    M: int = 32              # graph out-degree
    W: int = 4               # beam width
    m: int = 16              # PQ subspaces
    kind: str = "pq"         # quant kind (types.QUANT_KINDS)
    index_type: str = "graph"
    nprobe: int = 32
    nlist: int = 0           # 0 => round(sqrt(n)) like IVFConfig
    list_pad: int = 128
    n_entries: int = 8
    rescore_factor: int = 32
    rerank: int = 0          # explicit exact-rerank depth (0 => derived)
    early_term: bool = True


DEFAULT_WORKLOAD = Workload()


def workload_from(config, search=None, n: int = 0, Q: int = 1) -> Workload:
    """Duck-typed bridge from a live IndexConfig (+ optional SearchConfig
    override): core/ imports nothing from here and vice versa."""
    s = search if search is not None else config.search
    return Workload(
        n=n or DEFAULT_WORKLOAD.n, d=config.dim, Q=Q, k=s.k, L=s.L,
        M=config.build.M, W=s.beam_width, m=config.quant.pq_m,
        kind=config.quant.kind, index_type=config.index_type,
        nprobe=s.nprobe, nlist=config.ivf.nlist,
        list_pad=config.ivf.list_pad, n_entries=s.n_entries,
        rescore_factor=s.rescore_factor, rerank=config.quant.rerank,
        early_term=s.early_term)


# ------------------------------------------------------- symbol bindings

def _auto_nlist(n: int) -> int:
    return max(2, min(n, int(round(math.sqrt(n)))))


def _pad_to(x: int, mult: int) -> int:
    return max(1, -(-x // mult)) * mult


def _lg(x) -> float:
    return max(1.0, math.log2(max(float(x), 2.0)))


def bindings(w: Workload, **over) -> Dict[str, object]:
    """Evaluation namespace for KERNEL_COSTS expressions AND for the
    AST-extracted grid/BlockSpec dims (superset of vmem.DIMS names).
    `over` pins call-site-specific symbols (C for a rerank of r
    candidates, P/max_len from a real built index, ...)."""
    nlist = w.nlist if w.nlist > 0 else _auto_nlist(w.n)
    nlist = min(nlist, w.n)
    fill = w.n / nlist
    ns: Dict[str, object] = {
        "n": w.n, "d": w.d, "D": _pad_to(w.d, LANE), "Q": w.Q, "k": w.k,
        "L": w.L, "T": w.L, "M": w.M, "W": w.W, "n_beam": w.W,
        "C": w.W * w.M, "m": w.m, "K": 256, "K4": 16, "mh": 32,
        "nw": -(-w.d // 32), "tq": 128, "tb": 128, "B": 4096,
        "nlist": nlist, "fill": fill,
        "max_len": _pad_to(int(math.ceil(fill)), w.list_pad),
        "P": min(w.nprobe, nlist),
        "lg": _lg,
    }
    ns.update(over)
    return ns


def _eval_expr(expr: str, ns: Dict[str, object]) -> float:
    val = eval(compile(expr, "<cost>", "eval"), {"__builtins__": {}}, ns)
    return float(val)


# --------------------------------------------- closed-form kernel models

@dataclasses.dataclass(frozen=True)
class KernelCost:
    """Per-CALL closed forms (DESIGN.md §16 derives each family)."""
    flops: str       # arithmetic executed (padded lanes included)
    hbm_bytes: str   # dtype-aware bytes moved HBM<->VMEM
    cands: str       # distance evaluations the call contributes to n_dist
    note: str = ""


# The merge term of the fused traversal kernels: a bitonic-style sort of
# the (queue + candidates) region costs ~x*lg(x)^2 compare-exchanges.
_SORT = "(L + C) * lg(L + C)**2"
# The per-list partial top-L of the IVF scans.
_TOPL = "max_len * lg(L)"

KERNEL_COSTS: Dict[str, KernelCost] = {
    # -- plain distance kernels ------------------------------------------
    "batch_dist": KernelCost(
        flops="3.0*Q*B*D",
        hbm_bytes="4.0*(Q*B*D/tb + Q*B*D/tq + Q*B)",
        cands="Q*B",
        note="tiled (tq x tb) matmul lift; both operands re-stream per tile"),
    "gather_dist": KernelCost(
        flops="3.0*Q*C*D",
        hbm_bytes="4.0*(Q*C*D + Q*D + 2.0*Q*C)",
        cands="Q*C",
        note="one gathered f32 row DMA per candidate dominates"),
    "sq_gather_dist": KernelCost(
        flops="5.0*Q*C*D",
        hbm_bytes="1.0*Q*C*D + 4.0*(Q*D + 2.0*D + 2.0*Q*C)",
        cands="Q*C",
        note="u8 rows: 4x less traffic than gather_dist, +2 dequant ops/dim"),
    "bin_dist": KernelCost(
        flops="4.0*Q*C*nw",
        hbm_bytes="4.0*(Q*C*nw + Q*nw + 2.0*Q*C)",
        cands="Q*C",
        note="XOR + SWAR popcount per u32 word; nw = ceil(d/32) words"),
    # -- ADC kernels (gather-as-matmul: m*K MACs per code, DESIGN.md §13) -
    "pq_adc": KernelCost(
        flops="3.0*Q*C*m*K",
        hbm_bytes="1.0*Q*C*m + 4.0*(Q*m*K + 2.0*Q*C)",
        cands="Q*C",
        note="one-hot MXU expansion: K=256 MACs per code, not a table read"),
    "pq4_adc": KernelCost(
        flops="3.0*Q*C*m*K4",
        hbm_bytes="0.5*Q*C*m + 4.0*(Q*m*K4 + 2.0*Q*C)",
        cands="Q*C",
        note="K=16 one-hot + nibble-packed codes: 16x fewer MACs than pq8"),
    # -- fused beam-expansion kernels (gather+dist+merge, DESIGN.md §2) ---
    "fused_expand": KernelCost(
        flops="Q*(3.0*C*D + %s)" % _SORT,
        hbm_bytes="4.0*Q*(C*D + D + 4.0*(L + C))",
        cands="Q*C"),
    "fused_expand_sq": KernelCost(
        flops="Q*(5.0*C*D + %s)" % _SORT,
        hbm_bytes="Q*(1.0*C*D + 4.0*D + 16.0*(L + C))",
        cands="Q*C"),
    "fused_expand_pq": KernelCost(
        flops="Q*(3.0*C*m*K + %s)" % _SORT,
        hbm_bytes="Q*(1.0*C*m + 4.0*m*K + 16.0*(L + C))",
        cands="Q*C"),
    "fused_expand_pq4": KernelCost(
        flops="Q*(3.0*C*m*K4 + %s)" % _SORT,
        hbm_bytes="Q*(0.5*C*m + 4.0*m*K4 + 16.0*(L + C))",
        cands="Q*C"),
    "fused_expand_bin": KernelCost(
        flops="Q*(4.0*C*nw + %s)" % _SORT,
        hbm_bytes="Q*(4.0*C*nw + 4.0*nw + 16.0*(L + C))",
        cands="Q*C"),
    # -- IVF padded-list scans (DESIGN.md §4) -----------------------------
    "ivf_scan": KernelCost(
        flops="Q*P*(3.0*max_len*m*K + %s)" % _TOPL,
        hbm_bytes="Q*P*(1.0*max_len*m + 4.0*max_len + 4.0*m*K + 8.0*L)",
        cands="Q*P*max_len",
        note="scans PADDED lists; n_dist counts only the valid entries"),
    "pq4_ivf_scan": KernelCost(
        flops="Q*P*(3.0*max_len*m*K4 + %s)" % _TOPL,
        hbm_bytes="Q*P*(0.5*max_len*m + 4.0*max_len + 4.0*m*K4 + 8.0*L)",
        cands="Q*P*max_len"),
    "bin_ivf_scan": KernelCost(
        flops="Q*P*(4.0*max_len*nw + %s)" % _TOPL,
        hbm_bytes="Q*P*(4.0*max_len*nw + 4.0*max_len + 8.0*L) + 4.0*Q*nw",
        cands="Q*P*max_len"),
}

# The port's own kernels: no Pallas kernel of the reference computes them
# (it runs the same stage as plain jnp ops), so they have no entry in the
# reference's table, which KERNEL_COSTS mirrors, and no term in the
# composition below; the check covers them all the same.
PORT_KERNEL_COSTS: Dict[str, KernelCost] = {
    # the traversal's candidate filter, once an iteration
    "beam_filter": KernelCost(
        flops="Q*(C*(C - 1)/2.0 + C*L)",
        hbm_bytes="4.0*Q*(W + C + L + C + 1)",
        cands="0",
        note="id compares: earlier positions, then the queue"),
}
_ALL_COSTS = {**KERNEL_COSTS, **PORT_KERNEL_COSTS}


def kernel_cost(name: str, w: Workload, **over) -> Tuple[float, float, float]:
    """(flops, hbm_bytes, cands) for one call of `name` under `w`, with
    `over` pinning call-site symbols (e.g. C=rerank_depth)."""
    kc = _ALL_COSTS[name]
    ns = bindings(w, **over)
    return (_eval_expr(kc.flops, ns), _eval_expr(kc.hbm_bytes, ns),
            _eval_expr(kc.cands, ns))


# ------------------------------------------------- per-query composition

def wide_L(w: Workload) -> int:
    """The widened queue the quantized first pass actually runs with
    (core/index.py _widen/_widen_bin)."""
    if w.kind == "none":
        return w.L
    if w.kind == "bin":
        return max(w.L, w.rescore_factor * w.k)
    return max(w.L, 4 * w.k)


def graph_rerank_depth(w: Workload) -> int:
    """Exact-rerank distances per query on the graph path, assuming the
    widened queue fills (it does beyond toy corpora; the roofline lane's
    rerank-delta check validates saturation)."""
    if w.kind == "none":
        return 0
    wl = wide_L(w)
    if w.kind == "bin":
        r = w.rerank if w.rerank > 0 else w.rescore_factor * w.k
    else:
        r = w.rerank if w.rerank > 0 else min(4 * w.k, wl)
    return min(max(r, w.k), wl)


def ivf_geometry(w: Workload, nlist: int = 0, max_len: int = 0
                 ) -> Tuple[int, float, int, int, int, int]:
    """(nlist, fill, max_len, P, Lp, cand_width) — pass the REAL nlist /
    max_len of a built index for exact arithmetic; defaults assume
    balanced lists."""
    nl = nlist or min(w.nlist if w.nlist > 0 else _auto_nlist(w.n), w.n)
    fill = w.n / nl
    ml = max_len or _pad_to(int(math.ceil(fill)), w.list_pad)
    P = min(w.nprobe, nl)
    wl = wide_L(w)
    Lp = min(wl, ml)
    return nl, fill, ml, P, Lp, min(wl, P * Lp)


def ivf_rerank_depth(w: Workload, nlist: int = 0, max_len: int = 0) -> int:
    """rr resolved the way core/index.py does for the IVF path (bin uses
    the explicit rescore_factor*k overfetch, others default to the whole
    candidate queue)."""
    _, _, _, _, _, width = ivf_geometry(w, nlist, max_len)
    if w.kind == "bin" and w.rerank == 0:
        r = w.rescore_factor * w.k
    else:
        r = w.rerank if w.rerank > 0 else width
    return min(max(r, w.k), width)


def ivf_n_dist_exact(w: Workload, scanned: int, nlist: int = 0,
                     max_len: int = 0) -> int:
    """EXACT per-query SearchStats.n_dist for the IVF path: valid codes
    scanned across the probed lists + the exact-rerank term, where the
    rerank only counts candidates that exist (min with `scanned` and the
    merged queue width).  `scanned` comes from the built index + probe
    assignment (ivf.scanned_counts), NOT from search stats — the check
    in the JAX package's benchmarks/roofline.py is non-circular."""
    _, _, _, _, _, width = ivf_geometry(w, nlist, max_len)
    r = ivf_rerank_depth(w, nlist, max_len)
    return int(scanned) + min(r, width, int(scanned))


def est_hops(w: Workload) -> int:
    """Expected traversal expansions (nodes popped) per query — the
    calibratable heuristic behind EXPECTED cost; exact checks never use
    it."""
    per_l = HOPS_PER_L_ET if w.early_term else HOPS_PER_L_NO_ET
    return max(1, int(round(per_l * wide_L(w))))


_GRAPH_DIST_KERNEL = {"none": "gather_dist", "sq": "sq_gather_dist",
                      "pq": "pq_adc", "pq4": "pq4_adc", "bin": "bin_dist"}
_GRAPH_EXPAND_KERNEL = {"none": "fused_expand", "sq": "fused_expand_sq",
                        "pq": "fused_expand_pq", "pq4": "fused_expand_pq4",
                        "bin": "fused_expand_bin"}
_IVF_SCAN_KERNEL = {"pq": "ivf_scan", "pq4": "pq4_ivf_scan",
                    "bin": "bin_ivf_scan", "none": "ivf_scan",
                    "sq": "ivf_scan"}


@dataclasses.dataclass(frozen=True)
class QueryCost:
    """Composed cost of one search batch (w.Q queries)."""
    Q: int
    flops: float
    hbm_bytes: float
    n_dist: float                 # expected distance evals PER QUERY
    breakdown: Tuple[Tuple[str, float, float, float], ...]
    # (kernel, calls, flops, bytes) per stage

    @property
    def t_compute(self) -> float:
        return self.flops / PEAK_FLOPS

    @property
    def t_memory(self) -> float:
        return self.hbm_bytes / MEM_BW

    @property
    def seconds(self) -> float:
        return max(self.t_compute, self.t_memory)

    @property
    def dominant(self) -> str:
        return "compute" if self.t_compute >= self.t_memory else "memory"

    @property
    def us_per_query(self) -> float:
        return self.seconds / max(self.Q, 1) * 1e6


def graph_search_cost(w: Workload, hops: Optional[int] = None) -> QueryCost:
    """seed dists + ceil(hops/W) fused-expand iterations + exact rerank."""
    h = hops if hops is not None else est_hops(w)
    iters = max(1, -(-h // max(w.W, 1)))
    wl = wide_L(w)
    parts: List[Tuple[str, float, float, float]] = []

    seed_k = _GRAPH_DIST_KERNEL[w.kind]
    f, b, _ = kernel_cost(seed_k, w, C=max(w.n_entries, 1), L=wl)
    parts.append((seed_k + ":seed", 1, f, b))

    exp_k = _GRAPH_EXPAND_KERNEL[w.kind]
    f, b, _ = kernel_cost(exp_k, w, C=w.W * w.M, L=wl)
    parts.append((exp_k, iters, f * iters, b * iters))

    r = graph_rerank_depth(w)
    if r:
        f, b, _ = kernel_cost("gather_dist", w, C=r)
        parts.append(("gather_dist:rerank", 1, f, b))

    n_dist = (w.n_entries + h * w.M * TRAVERSAL_YIELD + r)
    return QueryCost(w.Q, sum(p[2] for p in parts), sum(p[3] for p in parts),
                     n_dist, tuple(parts))


def ivf_search_cost(w: Workload, nlist: int = 0, max_len: int = 0
                    ) -> QueryCost:
    """coarse probe (Q x nlist batch_dist) + padded list scan + rerank."""
    nl, fill, ml, P, Lp, width = ivf_geometry(w, nlist, max_len)
    parts: List[Tuple[str, float, float, float]] = []

    f, b, _ = kernel_cost("batch_dist", w, B=max(nl, 1))
    parts.append(("batch_dist:probe", 1, f, b))

    scan_k = _IVF_SCAN_KERNEL[w.kind]
    f, b, _ = kernel_cost(scan_k, w, P=P, max_len=ml, L=Lp, nlist=nl)
    parts.append((scan_k, 1, f, b))

    r = ivf_rerank_depth(w, nlist, max_len)
    f, b, _ = kernel_cost("gather_dist", w, C=r)
    parts.append(("gather_dist:rerank", 1, f, b))

    exp_scanned = P * fill
    n_dist = exp_scanned + min(r, width, exp_scanned)
    return QueryCost(w.Q, sum(p[2] for p in parts), sum(p[3] for p in parts),
                     n_dist, tuple(parts))


def search_cost(w: Workload, **kw) -> QueryCost:
    return (ivf_search_cost(w, **kw) if w.index_type == "ivf"
            else graph_search_cost(w, **kw))


def predict_service_s(config, search=None, Q: int = 1, n: int = 0) -> float:
    """Latency-predictor hook for the serving tier (DESIGN.md §17):
    predicted seconds for ONE dispatched batch of Q queries under
    (config, search). Absolute scale assumes the Kunpeng roofline
    constants; serve.degrade.LatencyModel multiplies in an EWMA-calibrated
    measured/predicted ratio, so only the RELATIVE ordering across
    (SearchConfig, bucket) keys is load-bearing here — the ordering the
    reference's roofline bench validates (Spearman rho vs live runs)."""
    return search_cost(workload_from(config, search, n=n, Q=Q)).seconds


# --------------------------------------------------------- check + report

CHECK = "cost"
COST_FILE = "src/repro_torch/analysis/cost.py"


@dataclasses.dataclass
class CostEstimate:
    """Per-kernel row of the cost report."""
    name: str
    path: str
    line: int
    flops: float           # closed-form, per call at the bound workload
    hbm_bytes: float
    cands: float
    notes: List[str]

    @property
    def intensity(self) -> float:
        return self.flops / self.hbm_bytes if self.hbm_bytes else 0.0


def estimate(tree: Tree, w: Workload = DEFAULT_WORKLOAD
             ) -> List[CostEstimate]:
    """One row per discovered kernel; never raises — unresolvable pieces
    land in .notes (run() promotes them to violations)."""
    out: List[CostEstimate] = []
    for rel, name, lineno in find_kernels(tree):
        notes: List[str] = []
        flops = hbm = cands = 0.0
        if name in _ALL_COSTS:
            try:
                flops, hbm, cands = kernel_cost(name, w)
            except Exception as e:
                notes.append(f"formula failed: {e!r}")
        else:
            notes.append("no closed-form cost formula in KERNEL_COSTS")
        out.append(CostEstimate(name, rel, lineno, flops, hbm, cands, notes))
    return out


def run(tree: Tree) -> List[Violation]:
    violations: List[Violation] = []
    found = set()
    for est in estimate(tree):
        found.add(est.name)
        for note in est.notes:
            violations.append(Violation(
                CHECK, est.path, est.line,
                f"kernel '{est.name}' has no resolvable closed-form cost "
                f"({note}) — add a KERNEL_COSTS entry / fix the symbols "
                f"so the model covers the whole kernel surface"))
        if not est.notes and (est.flops <= 0 or est.hbm_bytes <= 0
                              or est.cands < 0):
            violations.append(Violation(
                CHECK, est.path, est.line,
                f"kernel '{est.name}' cost evaluates non-positive "
                f"(flops={est.flops}, bytes={est.hbm_bytes})"))
    # stale registry entries — only meaningful when the tree carries the
    # real kernel surface (fixture trees hold a single alien kernel)
    if found & set(_ALL_COSTS):
        for name in sorted(set(_ALL_COSTS) - found):
            violations.append(Violation(
                CHECK, COST_FILE, 1,
                f"KERNEL_COSTS entry '{name}' matches no discovered "
                f"kernel (stale formula)"))
    return violations


_QUERY_ROWS = (("graph", "none"), ("graph", "sq"), ("graph", "pq"),
               ("graph", "pq4"), ("graph", "bin"),
               ("ivf", "pq"), ("ivf", "pq4"), ("ivf", "bin"))


def _query_table(w: Workload) -> List[dict]:
    rows = []
    for index_type, kind in _QUERY_ROWS:
        wk = dataclasses.replace(w, index_type=index_type, kind=kind)
        qc = search_cost(wk)
        rows.append({"config": f"{index_type}/{kind}",
                     "n_dist": qc.n_dist,
                     "flops": qc.flops, "hbm_bytes": qc.hbm_bytes,
                     "t_compute": qc.t_compute, "t_memory": qc.t_memory,
                     "dominant": qc.dominant,
                     "us_per_query": qc.us_per_query})
    return rows


def cost_model(tree: Tree, w: Workload = DEFAULT_WORKLOAD) -> dict:
    """Machine-readable model dump (--json)."""
    return {
        "workload": dataclasses.asdict(w),
        "constants": {"peak_flops": PEAK_FLOPS, "mem_bw": MEM_BW},
        "kernels": [dataclasses.asdict(e) for e in estimate(tree, w)],
        "queries": _query_table(w),
    }


def report(tree: Tree, w: Workload = DEFAULT_WORKLOAD) -> str:
    """--report table: per-kernel closed forms + per-query composition
    (the reference's Kunpeng constants; no figure of the H100)."""
    rows = [f"{'kernel':<18} {'GFLOP/call':>11} {'MB/call':>9} "
            f"{'F/B':>6}  notes"]
    for e in estimate(tree, w):
        rows.append(f"{e.name:<18} {e.flops / 1e9:>11.3f} "
                    f"{e.hbm_bytes / 1e6:>9.2f} {e.intensity:>6.1f}  "
                    f"{'; '.join(e.notes)}")
    rows.append("")
    rows.append(f"per-query composition at n={w.n} d={w.d} L={w.L} "
                f"W={w.W} nprobe={w.nprobe} (Q={w.Q}):")
    rows.append(f"{'config':<12} {'n_dist':>8} {'GFLOP':>8} {'MB':>8} "
                f"{'us/q':>8}  bound")
    for r in _query_table(w):
        rows.append(f"{r['config']:<12} {r['n_dist']:>8.0f} "
                    f"{r['flops'] / 1e9:>8.3f} "
                    f"{r['hbm_bytes'] / 1e6:>8.2f} "
                    f"{r['us_per_query']:>8.1f}  {r['dominant']}")
    return "\n".join(rows)
