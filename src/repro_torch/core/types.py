"""Shared dataclasses for the KBest core library.

A copy of the JAX package's `repro/core/types.py` (stdlib only): the two
packages share configs field for field, so an index saved by one loads in
the other. All configs are plain frozen dataclasses so they hash (usable
as cache keys) and serialize trivially into checkpoint metadata.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

# Distance metrics. "l2" is squared Euclidean (monotone in true L2, the
# standard ANNS convention), "ip" is negative inner product, "cosine" is
# negative cosine similarity (vectors are L2-normalized at add() time and the
# metric degenerates to "ip").
METRICS = ("l2", "ip", "cosine")

# Edge-selection rules supported by the refinement pipeline (paper §3.2).
SELECT_RULES = ("none", "hnsw", "alpha", "ssg")

# Index families behind the KBest facade (DESIGN.md §3 graph, §4 ivf).
INDEX_TYPES = ("graph", "ivf")

# Quantization kinds accepted by QuantConfig — THE single registry
# (DESIGN.md §13/§14). Sweeps (core/tune.py, benchmarks/ablation.py)
# enumerate quantize.quant_variants(), which is asserted against this
# tuple in tests, so a new kind lands in every sweep automatically.
QUANT_KINDS = ("none", "pq", "pq4", "sq", "bin")


@dataclasses.dataclass(frozen=True)
class BuildConfig:
    """Index-construction parameters (paper: Add / build phase)."""

    M: int = 32                  # fixed out-degree of the CSR graph
    knn_k: int = 48              # size of the initial kNN neighborhood
    builder: str = "auto"        # "brute" | "nn_descent" | "auto"
    nn_descent_rounds: int = 6   # NN-descent iterations
    nn_descent_sample: int = 12  # neighbors-of-neighbors sampled per round
    select_rule: str = "alpha"   # edge selection rule (SELECT_RULES)
    alpha: float = 1.2           # Vamana/NSG pruning slack
    ssg_angle_deg: float = 60.0  # SSG minimum pairwise edge angle
    refine_iters: int = 1        # F: 2-hop iterative refinement rounds (A1)
    refine_cands: int = 96       # candidate pool cap per node during refine
    search_passes: int = 1       # search-based refinement passes (A1 phase 2)
    search_L: int = 48           # queue size of the build-time searches
    reorder: str = "mst"         # "none" | "mst" (Algorithm 2) | "cm"
    seed: int = 0

    def __post_init__(self):
        assert self.select_rule in SELECT_RULES, self.select_rule
        assert self.builder in ("brute", "nn_descent", "auto"), self.builder
        assert self.M >= 2 and self.knn_k >= self.M


@dataclasses.dataclass(frozen=True)
class SearchConfig:
    """Query-time parameters (paper: Search phase, Algorithm 1 + Eq. 3)."""

    L: int = 64                  # candidate queue size (a.k.a. efSearch)
    k: int = 10                  # results returned
    max_hops: int = 0            # 0 => derived (4*L) safety bound
    # --- early termination (Eq. 3) ---
    early_term: bool = True
    et_t_frac: float = 0.6       # threshold position t as a fraction of L
    et_patience: int = 16        # tau_max: consecutive beyond-t insertions
    # --- batched traversal ---
    visited_mode: str = "queue"  # "queue" (in-queue dedupe) | "bitmap" (exact)
    dist_impl: str = "ref"       # "ref" | "kernel" — distance backend
    beam_width: int = 1          # W: expansions per lockstep iteration (§2)
    batch_B: int = 0             # distance-batch chunk: the W*M candidate
                                 # axis is split into batch_B-sized dist
                                 # calls; 0 => one (Q, W*M) call (see §2)
    n_entries: int = 8           # entry points: medoid + (n-1) strided seeds
    # --- two-stage rescore (kind="bin" only, DESIGN.md §14) ---
    rescore_factor: int = 8      # overfetch rescore_factor*k Hamming
                                 # candidates, then exact re-rank; other
                                 # quant kinds use QuantConfig.rerank
    # --- IVF-only (ignored by the graph index, DESIGN.md §4) ---
    nprobe: int = 8              # probed clusters per query

    def __post_init__(self):
        assert self.k <= self.L, (self.k, self.L)
        assert self.visited_mode in ("queue", "bitmap")
        assert 0.0 < self.et_t_frac <= 1.0
        assert self.nprobe >= 1
        assert self.rescore_factor >= 1, self.rescore_factor
        # the beam picks W unvisited queue slots per step — more than L
        # slots can never exist, so a wider beam is a config error
        assert 1 <= self.beam_width <= self.L, (self.beam_width, self.L)
        assert self.batch_B >= 0, self.batch_B

    @property
    def hops_bound(self) -> int:
        return self.max_hops if self.max_hops > 0 else 4 * self.L


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Vector quantization (paper §3.2, A4).

    kind (QUANT_KINDS): "none" | "pq" (8-bit, 256-centroid sub-codebooks)
    | "pq4" (4-bit fast-scan: 16-centroid sub-codebooks, two codes packed
    per byte, LUT small enough to stay VMEM/register resident — DESIGN.md
    §13) | "sq" (int8 per-dimension affine) | "bin" (1-bit random-rotation
    sign codec, u32-packed, XOR+popcount Hamming first pass + exact
    rescore — DESIGN.md §14; overfetch via SearchConfig.rescore_factor).
    """

    kind: str = "none"
    pq_m: int = 8                # number of PQ subspaces
    pq_bits: int = 8             # bits per code for kind="pq" (256 centroids)
    pq4_lut_u8: bool = False     # fast-scan style per-query u8 LUT requant
    kmeans_iters: int = 10
    rerank: int = 0              # exact re-rank depth (0 => 4*k at search)
    seed: int = 0

    def __post_init__(self):
        assert self.kind in QUANT_KINDS, self.kind
        if self.kind == "pq4":
            # nbits is authoritative (4); tolerate an explicit pq_bits=4 or
            # the untouched default 8 rather than crash on the natural call
            # QuantConfig(kind="pq4", pq_bits=4)
            assert self.pq_bits in (4, 8), \
                f"pq4 codes are 4-bit (pq_bits ignored), got {self.pq_bits}"
            assert self.pq_m % 2 == 0, \
                f"pq4 packs two codes per byte: pq_m must be even, got {self.pq_m}"
        else:
            assert self.pq_bits == 8, "kind='pq' is 8-bit; use kind='pq4' for 4"

    @property
    def nbits(self) -> int:
        """Bits per PQ code (4 for the fast-scan family, else pq_bits)."""
        return 4 if self.kind == "pq4" else self.pq_bits

    @property
    def ksub(self) -> int:
        """Centroids per sub-codebook (16 for pq4, 256 for pq)."""
        return 1 << self.nbits


@dataclasses.dataclass(frozen=True)
class IVFConfig:
    """IVF coarse-partitioning parameters (DESIGN.md §4).

    The fine (PQ) stage reuses QuantConfig (pq_m / kmeans_iters / rerank) so
    the same codebook knobs drive both graph-PQ and IVF-PQ.
    """

    nlist: int = 0               # coarse clusters; 0 => round(sqrt(n))
    kmeans_iters: int = 10       # Lloyd iterations of the coarse quantizer
    residual: bool = True        # encode x - centroid (True) or raw x
    list_pad: int = 128          # pad inverted-list length to this multiple
                                 # (lane width: the H3 alignment analogue)
    seed: int = 0

    def __post_init__(self):
        assert self.nlist >= 0 and self.list_pad >= 1


@dataclasses.dataclass(frozen=True)
class IndexConfig:
    """Top-level config handed to KBest(config) (paper Table 2).

    n_shards > 1 selects the sharded composition (core/sharded.py:
    ShardedKBest — DESIGN.md §12): the corpus is split into n_shards
    contiguous row ranges, each built as an independent single-shard index
    of this same config, searched shard-locally and merged. Plain KBest
    requires n_shards == 1.
    """

    dim: int
    metric: str = "l2"
    index_type: str = "graph"    # INDEX_TYPES: "graph" | "ivf"
    n_shards: int = 1            # flat mesh shape of the sharded composition
    build: BuildConfig = dataclasses.field(default_factory=BuildConfig)
    search: SearchConfig = dataclasses.field(default_factory=SearchConfig)
    quant: QuantConfig = dataclasses.field(default_factory=QuantConfig)
    ivf: IVFConfig = dataclasses.field(default_factory=IVFConfig)

    def __post_init__(self):
        assert self.metric in METRICS, self.metric
        assert self.index_type in INDEX_TYPES, self.index_type
        assert self.n_shards >= 1, self.n_shards
