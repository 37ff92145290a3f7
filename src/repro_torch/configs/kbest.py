"""The paper's own system configs for the graph and IVF indexes:
recommended KBest parameters per evaluation dataset (paper Table 3/4).

A copy of the index presets of the JAX package's `repro/configs/kbest.py`
(graph: `index_config`, `beam_index_config`, `sq_index_config`,
`bin_index_config`, `smoke_config`; IVF: `ivf_index_config`,
`ivf_pq4_index_config`, `ivf_bin_index_config`, `ivf_smoke_config`; the
sharded presets of DESIGN.md §12, `full_config`, the tuner's `tune_grid`
and the serving tier's `degrade_ladder`), with the same values, so a
preset names the same index in both packages.

    from repro_torch.configs import kbest
    cfg = kbest.beam_index_config("deep_like")
    cfg = kbest.sharded_index_config("deep_like", 2)  # core.sharded.ShardedKBest
"""
import dataclasses

from repro_torch.core.types import (BuildConfig, IndexConfig, IVFConfig,
                                    QuantConfig, SearchConfig)

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


# IVF-PQ presets: pq_m divides dim; nprobe and L tuned for the re-ranked
# pipeline (the whole candidate queue is re-ranked)
_IVF_CONFIGS = {
    "glove_like": dict(dim=100, metric="ip", pq_m=20, nprobe=32, L=192),
    "deep_like": dict(dim=96, metric="ip", pq_m=16, nprobe=24, L=128),
    "t2i_like": dict(dim=200, metric="ip", pq_m=20, nprobe=32, L=192),
    "bigann_like": dict(dim=128, metric="l2", pq_m=16, nprobe=32, L=192),
}

# pq4 presets (the reference's DESIGN.md §13): 4-bit codes are coarser per
# subspace, so these spend some of the halved bytes on more subspaces and
# widen the re-ranked queue and the probe count
_IVF_PQ4_CONFIGS = {
    "glove_like": dict(dim=100, metric="ip", pq_m=20, nprobe=48, L=256),
    "deep_like": dict(dim=96, metric="ip", pq_m=32, nprobe=32, L=192),
    "t2i_like": dict(dim=200, metric="ip", pq_m=40, nprobe=48, L=256),
    "bigann_like": dict(dim=128, metric="l2", pq_m=32, nprobe=48, L=384),
}

# bin presets (the reference's DESIGN.md §14): the 1-bit Hamming first
# pass needs a wider queue and a deep exact rescore to hold recall at codes
# 32x smaller than f32 — (L, rescore_factor) on the graph side, (nprobe,
# ivf_L, ivf_rescore_factor) on the IVF side, whose flat scan keeps no
# traversal queue and so overfetches much deeper
_BIN_CONFIGS = {
    "glove_like": dict(L=320, rescore_factor=32,
                       nprobe=96, ivf_L=768, ivf_rescore_factor=64),
    "deep_like": dict(L=320, rescore_factor=32,
                      nprobe=96, ivf_L=768, ivf_rescore_factor=64),
    "t2i_like": dict(L=320, rescore_factor=32,
                     nprobe=96, ivf_L=768, ivf_rescore_factor=64),
    "bigann_like": dict(L=384, rescore_factor=32,
                        nprobe=96, ivf_L=768, ivf_rescore_factor=64),
}


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


def bin_index_config(dataset: str) -> IndexConfig:
    """Graph preset with the 1-bit sign codec: Hamming traversal over
    packed sign words, then the exact rescore of the rescore_factor * k
    overfetch."""
    cfg = index_config(dataset)
    b = _BIN_CONFIGS[dataset]
    return dataclasses.replace(
        cfg, quant=QuantConfig(kind="bin"),
        search=dataclasses.replace(cfg.search, L=b["L"],
                                   rescore_factor=b["rescore_factor"]))


def smoke_config() -> IndexConfig:
    return IndexConfig(
        dim=32, metric="l2",
        build=BuildConfig(M=8, knn_k=12, refine_iters=1, refine_cands=24,
                          reorder="mst"),
        search=SearchConfig(L=16, k=5))


def ivf_index_config(dataset: str) -> IndexConfig:
    """IVF preset with 8-bit residual PQ codes."""
    c = _IVF_CONFIGS[dataset]
    return IndexConfig(
        dim=c["dim"], metric=c["metric"], index_type="ivf",
        ivf=IVFConfig(nlist=0, kmeans_iters=10),
        quant=QuantConfig(kind="pq", pq_m=c["pq_m"], kmeans_iters=8),
        search=SearchConfig(L=c["L"], k=10, nprobe=c["nprobe"]))


def ivf_pq4_index_config(dataset: str) -> IndexConfig:
    """IVF preset with 4-bit fast-scan codes (half ivf_index_config's bytes
    at equal m; these double m where dim allows)."""
    c = _IVF_PQ4_CONFIGS[dataset]
    return IndexConfig(
        dim=c["dim"], metric=c["metric"], index_type="ivf",
        ivf=IVFConfig(nlist=0, kmeans_iters=10),
        quant=QuantConfig(kind="pq4", pq_m=c["pq_m"], kmeans_iters=10),
        search=SearchConfig(L=c["L"], k=10, nprobe=c["nprobe"]))


def ivf_bin_index_config(dataset: str) -> IndexConfig:
    """IVF preset with the 1-bit sign codec: Hamming list scans (no table
    stage), then the exact rescore of the rescore_factor * k overfetch."""
    c = _IVF_CONFIGS[dataset]
    b = _BIN_CONFIGS[dataset]
    return IndexConfig(
        dim=c["dim"], metric=c["metric"], index_type="ivf",
        ivf=IVFConfig(nlist=0, kmeans_iters=10),
        quant=QuantConfig(kind="bin"),
        search=SearchConfig(L=b["ivf_L"], k=10, nprobe=b["nprobe"],
                            rescore_factor=b["ivf_rescore_factor"]))


def ivf_smoke_config() -> IndexConfig:
    return IndexConfig(
        dim=32, metric="l2", index_type="ivf",
        ivf=IVFConfig(nlist=8, kmeans_iters=4, list_pad=8),
        quant=QuantConfig(kind="pq", pq_m=8, kmeans_iters=3),
        search=SearchConfig(L=16, k=5, nprobe=4))


def sharded_index_config(dataset: str, n_shards: int = 2) -> IndexConfig:
    """Graph preset over n_shards shards (DESIGN.md §12). Each shard runs
    the full traversal at the preset's L, so the merged recall only goes
    up."""
    return dataclasses.replace(index_config(dataset), n_shards=n_shards)


def sharded_ivf_index_config(dataset: str, n_shards: int = 2) -> IndexConfig:
    """IVF-PQ preset over n_shards shards: every shard trains its own
    coarse centroids (nlist=0: sqrt of its rows) and probes nprobe of
    them."""
    return dataclasses.replace(ivf_index_config(dataset), n_shards=n_shards)


def sharded_ivf_pq4_index_config(dataset: str,
                                 n_shards: int = 2) -> IndexConfig:
    """4-bit fast-scan IVF preset over n_shards shards."""
    return dataclasses.replace(ivf_pq4_index_config(dataset),
                               n_shards=n_shards)


def sharded_bin_index_config(dataset: str, n_shards: int = 2) -> IndexConfig:
    """1-bit sign-codec graph preset over n_shards shards."""
    return dataclasses.replace(bin_index_config(dataset), n_shards=n_shards)


def sharded_smoke_config(n_shards: int = 2) -> IndexConfig:
    """Tiny sharded graph config for quick tests."""
    return dataclasses.replace(smoke_config(), n_shards=n_shards)


def full_config(dataset: str = "bigann_like") -> IndexConfig:
    return index_config(dataset)


def tune_grid(index_type: str) -> dict:
    """Search-knob grid core/tune.py::tune_config sweeps (DESIGN.md §16),
    the reference's. Quant kinds are not enumerated here: the tuner takes
    them from the registry (types.QUANT_KINDS /
    quantize.IVF_QUANT_KINDS). rescore_factor only fans out for
    kind="bin", the only kind that reads it."""
    if index_type == "ivf":
        return {"L": (32, 64, 128, 256), "nprobe": (4, 8, 16, 32, 64),
                "rescore_factor": (8, 32)}
    return {"L": (32, 64, 128, 256), "beam_width": (1, 4),
            "rescore_factor": (8, 32)}


def degrade_ladder(cfg: IndexConfig, n_rungs: int = 4) -> tuple:
    """The serving tier's shed valve (DESIGN.md §17): rung 0 is the
    config's own SearchConfig; each further rung halves L (down to k and
    beam_width), nprobe and rescore_factor. A candidate that does not
    STRICTLY lower the predicted cost (`analysis.cost.predict_service_s`)
    is skipped, so the ladder falls in cost by construction and every rung
    is a valid standalone SearchConfig."""
    from repro_torch.analysis.cost import predict_service_s
    s = cfg.search
    ladder = [s]
    last_cost = predict_service_s(cfg, s)
    while len(ladder) < n_rungs:
        cand = dataclasses.replace(
            s,
            L=max(s.k, s.beam_width, s.L // 2),
            nprobe=max(1, s.nprobe // 2),
            rescore_factor=max(1, s.rescore_factor // 2))
        if cand == s:
            break                        # every knob is at its floor
        s = cand
        c = predict_service_s(cfg, s)
        if c < last_cost * 0.999:
            ladder.append(s)
            last_cost = c
    return tuple(ladder)
