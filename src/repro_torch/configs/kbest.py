"""The paper's own system configs for the graph index: recommended KBest
parameters per evaluation dataset (paper Table 3/4).

A copy of the graph presets of the JAX package's `repro/configs/kbest.py`
(`index_config`, `beam_index_config`, `sq_index_config`, `smoke_config`),
with the same values, so a preset names the same index in both packages.

    from repro_torch.configs import kbest
    cfg = kbest.beam_index_config("deep_like")
"""
import dataclasses

from repro_torch.core.types import (BuildConfig, IndexConfig, QuantConfig,
                                    SearchConfig)

SHAPES = ("glove_like", "deep_like", "t2i_like", "bigann_like")

# (dim, metric, build, search) tuned on the synthetic analogues to reach
# recall@10 >= 0.95 (the JAX package's benchmarks/qps_recall.py)
_CONFIGS = {
    "glove_like": dict(
        dim=100, metric="ip",
        build=BuildConfig(M=32, knn_k=48, select_rule="alpha", alpha=1.2,
                          search_passes=2, refine_iters=2, refine_cands=96,
                          reorder="mst"),
        search=SearchConfig(L=128, k=10, early_term=True, et_patience=32)),
    "deep_like": dict(
        dim=96, metric="ip",
        build=BuildConfig(M=24, knn_k=32, select_rule="alpha", alpha=1.2,
                          search_passes=1, refine_iters=1, refine_cands=64,
                          reorder="mst"),
        search=SearchConfig(L=64, k=10, early_term=True, et_patience=16)),
    "t2i_like": dict(
        dim=200, metric="ip",
        build=BuildConfig(M=32, knn_k=48, select_rule="alpha", alpha=1.2,
                          search_passes=2, refine_iters=1, refine_cands=96,
                          reorder="mst"),
        search=SearchConfig(L=128, k=10, early_term=True, et_patience=32)),
    "bigann_like": dict(
        dim=128, metric="l2",
        build=BuildConfig(M=32, knn_k=48, select_rule="alpha", alpha=1.2,
                          search_passes=2, refine_iters=1, refine_cands=96,
                          reorder="mst"),
        search=SearchConfig(L=192, k=10, early_term=True, et_patience=48)),
}

# Beam widths per dataset (DESIGN.md §2): W=1 is classic best-first.
_BEAM_W = {"glove_like": 4, "deep_like": 4, "t2i_like": 4, "bigann_like": 4}


def index_config(dataset: str) -> IndexConfig:
    return IndexConfig(**_CONFIGS[dataset])


def beam_index_config(dataset: str, beam_width: int = 0) -> IndexConfig:
    """Graph preset searched with beam-parallel traversal: top-W unvisited
    candidates expand per lockstep iteration. beam_width=0 takes the
    per-dataset tuned width."""
    cfg = index_config(dataset)
    w = beam_width if beam_width > 0 else _BEAM_W[dataset]
    return dataclasses.replace(
        cfg, search=dataclasses.replace(cfg.search, beam_width=w))


def sq_index_config(dataset: str) -> IndexConfig:
    """Graph preset with the int8 scalar quantizer: per-dim affine u8
    codes traversed directly (gather+dequant fused in the kernel path),
    exact re-rank of the default 4*k overfetch. SQ is nearly
    recall-transparent at 4x-smaller codes, so the tuned graph knobs carry
    over unchanged."""
    return dataclasses.replace(index_config(dataset),
                               quant=QuantConfig(kind="sq"))


def smoke_config() -> IndexConfig:
    return IndexConfig(
        dim=32, metric="l2",
        build=BuildConfig(M=8, knn_k=12, refine_iters=1, refine_cands=24,
                          reorder="mst"),
        search=SearchConfig(L=16, k=5))
