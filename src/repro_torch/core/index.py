"""KBest — the user-facing API (paper §4, Table 2), both index families.

    index = KBest(config)              # on the card; device="cpu" for tests
    index.add(x)                       # index construction (build pipeline)
    d, i = index.search(q, k)          # query processing
    index.save(path) / KBest.load(path)

The counterpart of the JAX package's `repro/core/index.py`, with every
`QuantConfig.kind` of each family (DESIGN.md §3, §4, §13, §14).

`index_type="graph"`: kNN graph (brute / NN-descent) -> edge selection ->
search-based and 2-hop refinement (A1) -> reverse-edge fill ->
connectivity repair -> MST reordering (A2) -> medoid entry point -> the
quantizer's training and codes over the reordered rows (A4) for "sq",
"pq", "pq4" or "bin"; search runs the batched traversal of core.search
with early termination (A3), and a quantized first pass is re-ranked with
exact distances (bin: its rescore_factor * k overfetch).

`index_type="ivf"`: coarse k-means -> residual PQ, PQ4 or raw-vector bin
codes -> padded inverted lists (core/ivf.py); search probes the nprobe
nearest lists, scans them with a per-list top-L (the list-scan kernels)
and re-ranks the whole merged candidate queue exactly (bin: its
rescore_factor * k overfetch; `QuantConfig.rerank` when set). Padded
lanes of `search_padded` compute and are then masked.

Saves are the reference's format 2, readable by either package.
"""
from __future__ import annotations

import dataclasses
import json
import time
import warnings
from pathlib import Path
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.core import build as build_mod
from repro_torch.core import ivf as ivf_mod
from repro_torch.core import persist
from repro_torch.core import quantize as qz
from repro_torch.core import reorder as reorder_mod
from repro_torch.core import search as search_mod
from repro_torch.core.distance import normalize
from repro_torch.core.refine import _chunk_dists, _sync, refine_graph
from repro_torch.core.types import IndexConfig, SearchConfig

# the quantizer state a format-2 save holds beside db, graph and order
QUANT_ARRAYS = ("pq_codebooks", "pq_codes", "sq_scale", "sq_zero", "sq_codes",
                "bin_rot", "bin_codes")
# the IVF state a format-2 save holds beside db
IVF_ARRAYS = ("ivf_centroids", "ivf_list_ids", "ivf_list_codes",
              "ivf_codebooks", "ivf_bin_rot")


def resolve_device(device=None) -> torch.device:
    """None means the card; without CUDA that raises — pass device="cpu"
    to run on the host."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError("KBest runs on a CUDA device by default and "
                               "none is available; pass device='cpu' to "
                               "run on the host")
        return torch.device("cuda")
    return torch.device(device)


class KBest:
    def __init__(self, config: IndexConfig, device=None,
                 node_chunk: Optional[int] = None):
        self.config = config
        self.device = resolve_device(device)
        # rows per build-time chunk; results do not depend on it
        self.node_chunk = node_chunk or (
            16384 if self.device.type == "cuda" else 512)
        self.db: Optional[torch.Tensor] = None       # (n, d) f32
        self.graph: Optional[torch.Tensor] = None    # (n, M) int32
        self.entry: int = 0
        self.order: Optional[np.ndarray] = None      # new->old id map
        self._order_t: Optional[torch.Tensor] = None
        self.build_times: Dict[str, float] = {}      # seconds per stage
        # quantization state
        self.pq: Optional[qz.PQState] = None
        self.pq_codes: Optional[torch.Tensor] = None  # (n, m) u8; pq4 (n, m/2)
        self.sq: Optional[qz.SQState] = None
        self.sq_codes: Optional[torch.Tensor] = None  # (n, d) u8
        self.bin: Optional[qz.BinState] = None
        self.bin_codes: Optional[torch.Tensor] = None  # (n, ceil(d/32)) i32
        self.ivf: Optional[ivf_mod.IVFState] = None
        self._fns = {}

    @property
    def _metric(self) -> str:
        return "ip" if self.config.metric == "cosine" else self.config.metric

    # ------------------------------------------------------------------ add
    def add(self, x, init_ids: Optional[torch.Tensor] = None,
            timings: Optional[dict] = None) -> "KBest":
        """Build the index over x (n, d). `init_ids` (n, knn_k) optionally
        replaces the NN-descent random start (build.random_init_ids);
        `timings`, when given, receives each stage's seconds as it ends
        (it becomes `build_times`). An IVF config builds core/ivf.py's
        lists instead of a graph."""
        cfg = self.config
        assert cfg.n_shards == 1, \
            "config.n_shards > 1 is the sharded composition — build it " \
            "with repro_torch.core.sharded.ShardedKBest, not KBest"
        b = cfg.build
        dev = self.device
        times = self.build_times = {} if timings is None else timings
        t0 = time.perf_counter()

        def lap(name):
            nonlocal t0
            _sync(dev)
            t = time.perf_counter()
            times[name] = times.get(name, 0.0) + (t - t0)
            t0 = t

        x = torch.as_tensor(np.asarray(x, dtype=np.float32), device=dev)
        assert x.ndim == 2 and x.shape[1] == cfg.dim, tuple(x.shape)
        if cfg.metric == "cosine":
            x = normalize(x)
        metric = self._metric
        lap("upload")
        if cfg.index_type == "ivf":
            self.db = x.contiguous()
            self.ivf = ivf_mod.build_ivf(self.db, cfg.ivf, cfg.quant,
                                         timings=times)
            self._fns = {}
            return self

        knn_ids, knn_dists = build_mod.build_knn(
            x, b.knn_k, metric, builder=b.builder,
            rounds=b.nn_descent_rounds, sample=b.nn_descent_sample,
            seed=b.seed, init_ids=init_ids, row_chunk=self.node_chunk)
        lap("knn")
        entry = build_mod.medoid(x, metric)
        lap("medoid")
        graph = refine_graph(
            x, knn_ids, knn_dists, M=b.M, rule=b.select_rule, metric=metric,
            alpha=b.alpha, ssg_angle_deg=b.ssg_angle_deg,
            iters=b.refine_iters, cand_cap=b.refine_cands,
            entry=entry, search_L=b.search_L, search_passes=b.search_passes,
            node_chunk=self.node_chunk, timings=times)
        del knn_ids, knn_dists
        t0 = time.perf_counter()

        order = None
        if b.reorder != "none":
            g_t = torch.as_tensor(graph, device=dev)
            weights = _edge_weights(x, g_t, metric, self.node_chunk)
            del g_t
            lap("edge_weights")
            if b.reorder == "mst":
                order = reorder_mod.mst_reorder(graph, weights, entry)
            elif b.reorder == "cm":
                order = reorder_mod.cuthill_mckee(graph, entry)
            else:
                raise ValueError(b.reorder)
            lap("reorder")
            new_of_old = np.empty(len(order), dtype=np.int64)
            new_of_old[order] = np.arange(len(order))
            order_t = torch.as_tensor(order, device=dev)
            x = x[order_t]
            g = graph[order]
            graph = np.where(g >= 0, new_of_old[np.maximum(g, 0)],
                             -1).astype(np.int32)
            entry = int(new_of_old[entry])
            lap("apply_order")

        self._set_state(x, torch.as_tensor(graph, device=dev), entry, order)
        lap("upload_graph")
        if cfg.quant.kind != "none":
            self._train_quant(self.db)
            lap("train_quant")
        return self

    def _train_quant(self, x: torch.Tensor) -> None:
        """Train + encode the configured quantizer over the stored
        (reordered) db; also attaches a different quantizer to an
        already-built graph."""
        q = self.config.quant
        if q.kind == "pq":
            self.pq = qz.pq_train(x, q)
            self.pq_codes = qz.pq_encode(self.pq.codebooks, x)
        elif q.kind == "pq4":
            self.pq = qz.pq_train(x, q)                    # (m, 16, ds)
            self.pq_codes = qz.pq4_encode(self.pq.codebooks, x)
        elif q.kind == "sq":
            self.sq = qz.sq_train(x)
            self.sq_codes = qz.sq_encode(self.sq, x)
        elif q.kind == "bin":
            self.bin = qz.bin_train(x, q)
            self.bin_codes = qz.bin_encode(self.bin, x)
        self._fns = {}

    def _set_state(self, db, graph, entry, order) -> None:
        self.db = db.contiguous()
        self.graph = graph.to(torch.int32).contiguous()
        self.entry = int(entry)
        self.order = None if order is None else np.asarray(order)
        self._order_t = (None if order is None else
                         torch.as_tensor(self.order, dtype=torch.int32,
                                         device=self.device))
        self._fns = {}

    # --------------------------------------------------------------- search
    def search(self, queries, k: Optional[int] = None,
               search_cfg: Optional[SearchConfig] = None,
               with_stats: bool = False):
        """Top-k search. queries: (Q, d). Returns (dists, ids[, stats]) as
        tensors on the index's device."""
        assert self.db is not None, "call add() first"
        scfg = self._resolve_cfg(k, search_cfg)
        dists, ids, stats = self._search_impl(
            prep_queries(self.config, queries, self.device), scfg,
            valid_mask=None)
        return (dists, ids, stats) if with_stats else (dists, ids)

    def search_padded(self, queries, valid_mask, k: Optional[int] = None,
                      search_cfg: Optional[SearchConfig] = None,
                      with_stats: bool = False):
        """Shape-stable search over a padded batch: rows with
        valid_mask[i] False come back as (+inf, -1) with zeroed stats and
        start inactive in the traversal; valid rows equal an unpadded
        `search` of the same queries."""
        assert self.db is not None, "call add() first"
        scfg = self._resolve_cfg(k, search_cfg)
        vm = torch.as_tensor(np.asarray(valid_mask, dtype=bool),
                             device=self.device)
        dists, ids, stats = self._search_impl(
            prep_queries(self.config, queries, self.device), scfg,
            valid_mask=vm)
        dists, ids, stats = mask_padded_lanes(vm, dists, ids, stats)
        return (dists, ids, stats) if with_stats else (dists, ids)

    def _resolve_cfg(self, k: Optional[int],
                     search_cfg: Optional[SearchConfig]) -> SearchConfig:
        """The concrete SearchConfig of a call (the serving engine's
        cache-key component)."""
        return resolve_search_cfg(self.config, k, search_cfg)

    def _search_impl(self, q: torch.Tensor, scfg: SearchConfig,
                     valid_mask: Optional[torch.Tensor]):
        """Shared body of search/search_padded. Returns (dists, ids,
        stats)."""
        if self.ivf is not None:
            return self._search_ivf(q, scfg)
        n = self.db.shape[0]
        entry_ids = self._entry_ids(scfg.n_entries, n)
        kind = self.config.quant.kind
        if kind == "none":
            dists, ids, stats = search_mod.search(
                self.graph, q, entry_ids,
                dist_fn=self._get_dist_fn("full", scfg.dist_impl), cfg=scfg,
                n_total=n, valid_mask=valid_mask,
                expand_fn=self._get_expand_fn("full", scfg))
        else:
            # quantized first pass over the whole widened queue, then the
            # exact re-rank (bin: of its rescore_factor * k overfetch)
            wide = _widen_bin(scfg) if kind == "bin" else _widen(scfg)
            _, ids, stats = search_mod.search(
                self.graph, self._operand(q), entry_ids,
                dist_fn=self._get_dist_fn(kind, scfg.dist_impl), cfg=wide,
                n_total=n, valid_mask=valid_mask,
                expand_fn=self._get_expand_fn(kind, wide))
            rerank = self.config.quant.rerank
            if kind == "bin" and rerank == 0:
                rerank = scfg.rescore_factor * scfg.k
            dists, ids, n_exact = self._rerank(q, ids, scfg.k, rerank,
                                               scfg.dist_impl)
            # n_dist counts the exact re-rank distances too, as the
            # reference does for every quantized family
            stats = stats._replace(n_dist=stats.n_dist + n_exact)
        # translate internal (post-reorder) ids back to the user's add() ids
        if self._order_t is not None:
            ids = torch.where(ids >= 0,
                              self._order_t[torch.clamp(ids, min=0).long()],
                              torch.full_like(ids, -1))
        return dists, ids, stats

    def _search_ivf(self, q: torch.Tensor, scfg: SearchConfig):
        """The IVF body: probe, scan and merge the widened queue, then
        re-rank all of it exactly (bin: its rescore_factor * k overfetch;
        quant.rerank when set). n_dist counts the codes scanned plus the
        exact distances; n_hops is the lists probed."""
        quant = self.config.quant
        wide = _widen_bin(scfg) if quant.kind == "bin" else _widen(scfg)
        _, cand, probes = ivf_mod.search_ivf(
            self.ivf, q, scfg.nprobe, wide.L, self._metric,
            impl=scfg.dist_impl,
            lut_u8=quant.kind == "pq4" and quant.pq4_lut_u8)
        if quant.kind == "bin" and quant.rerank == 0:
            rerank = scfg.rescore_factor * scfg.k
        else:
            rerank = quant.rerank if quant.rerank > 0 else cand.shape[1]
        dists, ids, n_exact = self._rerank(q, cand, scfg.k, rerank,
                                           scfg.dist_impl)
        Q, dev = q.shape[0], q.device
        stats = search_mod.SearchStats(
            n_hops=torch.full((Q,), min(scfg.nprobe, self.ivf.nlist),
                              dtype=torch.int32, device=dev),
            n_dist=ivf_mod.scanned_counts(self.ivf, probes) + n_exact,
            early_terminated=torch.zeros((Q,), dtype=torch.bool, device=dev),
            iters=torch.zeros((), dtype=torch.int32, device=dev))
        return dists, ids, stats

    def _operand(self, q: torch.Tensor) -> torch.Tensor:
        """What the quantized first pass walks with: per-query tables for
        PQ and PQ4, sign codes for bin, the queries themselves for SQ."""
        quant = self.config.quant
        if quant.kind == "pq":
            return qz.pq_query_tables(self.pq.codebooks, q, self._metric)
        if quant.kind == "pq4":
            return qz.pq4_query_tables(self.pq.codebooks, q, self._metric,
                                       lut_u8=quant.pq4_lut_u8)
        if quant.kind == "bin":
            return qz.bin_query_codes(self.bin, q)
        return q

    def _entry_ids(self, n_entries: int, n: int) -> torch.Tensor:
        """Medoid + evenly-spaced deterministic seeds; all distinct."""
        e = max(1, min(n_entries, n))
        if e == 1:
            return torch.tensor([self.entry % n], dtype=torch.int32)
        off = np.round(np.linspace(1, n - 1, e - 1)).astype(np.int64)
        ids = (self.entry + np.concatenate([[0], off])) % n
        return torch.as_tensor(ids, dtype=torch.int32)

    def _get_dist_fn(self, kind: str, impl: str):
        """The distance over `kind` ("full" or a quantized kind): the
        first pass's, and "full" for the exact re-rank."""
        key = (kind, impl)
        if key not in self._fns:
            metric = self._metric
            if kind == "full":
                fn = search_mod.make_dist_fn(self.db, metric, impl)
            elif kind == "pq":
                fn = qz.pq_make_dist_fn(self.pq_codes, self.pq.m, impl)
            elif kind == "pq4":
                fn = qz.pq4_make_dist_fn(self.pq_codes, self.pq.m, impl)
            elif kind == "sq":
                fn = qz.sq_make_dist_fn(self.sq_codes, self.sq, metric, impl)
            elif kind == "bin":
                fn = qz.bin_make_dist_fn(self.bin_codes, impl)
            else:
                raise ValueError(kind)
            self._fns[key] = fn
        return self._fns[key]

    def _get_expand_fn(self, kind: str, scfg: SearchConfig):
        """The fused gather+distance+sort step over `kind`, engaged only
        for kernel-impl beam searches without batch_B chunking (W=1 keeps
        the gather-then-merge path, as in the reference)."""
        if scfg.dist_impl != "kernel" or scfg.beam_width <= 1 \
                or scfg.batch_B != 0:
            return None
        L, W = scfg.L, scfg.beam_width
        key = (kind, "expand", L, W)
        if key not in self._fns:
            from repro_torch.kernels import ops as kops
            metric = self._metric
            if kind == "full":
                fn = search_mod.make_expand_fn(self.db, metric, L=L, n_beam=W)
            elif kind in ("pq", "pq4"):
                m, K, codes = self.pq.m, self.pq.ksub, self.pq_codes
                fe = kops.fused_expand_pq4 if kind == "pq4" else \
                    kops.fused_expand_pq

                def fn(tables, nbr_ids):
                    return fe(tables.reshape(tables.shape[0], m, K), codes,
                              nbr_ids, L=L, n_beam=W)
            elif kind == "sq":
                codes, sq = self.sq_codes, self.sq

                def fn(queries, nbr_ids):
                    return kops.fused_expand_sq(
                        queries, codes, sq.scale, sq.zero, nbr_ids,
                        metric=metric, L=L, n_beam=W)
            elif kind == "bin":
                codes = self.bin_codes

                def fn(qcodes, nbr_ids):
                    return kops.fused_expand_bin(qcodes, codes, nbr_ids, L=L,
                                                 n_beam=W)
            else:
                raise ValueError(kind)
            self._fns[key] = fn
        return self._fns[key]

    def _rerank(self, q: torch.Tensor, ids: torch.Tensor, k: int,
                rerank: int, impl: str = "ref"):
        """Exact re-rank of the first pass's top candidates (gather_dist
        when impl is "kernel", a plain gather otherwise). Returns (dists
        (Q, k), ids (Q, k), n_exact (Q,) int32: the exact distances
        computed). The top-k breaks ties toward the lower position, as
        the reference's lax.top_k does."""
        r = rerank if rerank > 0 else min(4 * k, ids.shape[1])
        r = min(max(r, k), ids.shape[1])   # never fewer candidates than k
        cand = ids[:, :r].contiguous()
        d = self._get_dist_fn("full", impl)(q, cand)
        d = torch.where(cand >= 0, d, torch.full_like(d, float("inf")))
        dists, pos = build_mod.stable_topk_smallest(d, k)
        n_exact = torch.sum(cand >= 0, dim=1).to(torch.int32)
        return dists, torch.gather(cand, 1, pos), n_exact

    # ------------------------------------------------------------ save/load
    def save(self, path: str, _label: str = "index") -> None:
        """Crash-safe format-2 save (DESIGN.md §17), the reference's files:
        the .npz is written atomically, then the JSON sidecar carrying a
        crc32 per array commits it."""
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        arrs = {"db": self.db.cpu().numpy()}
        if self.graph is not None:
            arrs["graph"] = self.graph.cpu().numpy()
        if self.ivf is not None:
            arrs.update(_ivf_arrays(self.ivf))
        if self.order is not None:
            arrs["order"] = np.asarray(self.order)
        if self.pq is not None:
            arrs["pq_codebooks"] = self.pq.codebooks.cpu().numpy()
            arrs["pq_codes"] = self.pq_codes.cpu().numpy()
        if self.sq is not None:
            arrs["sq_scale"] = self.sq.scale.cpu().numpy()
            arrs["sq_zero"] = self.sq.zero.cpu().numpy()
            arrs["sq_codes"] = self.sq_codes.cpu().numpy()
        if self.bin is not None:
            arrs["bin_rot"] = self.bin.rot.cpu().numpy()
            # the reference's dtype: the same bits as uint32 words
            arrs["bin_codes"] = self.bin_codes.cpu().numpy().view(np.uint32)
        sums = persist.save_arrays(_npz_path(p), arrs, f"{_label}.arrays")
        meta = {"entry": self.entry,
                "config": dataclasses.asdict(self.config),
                "format": 2,
                "checksums": sums}
        persist.atomic_write(_meta_path(p), json.dumps(meta).encode(),
                             f"{_label}.meta")

    @classmethod
    def load(cls, path: str, device=None) -> "KBest":
        """Load with validation: a torn or mismatched save raises
        persist.IndexCorruptError, never a silently wrong index."""
        p = Path(path)
        mp = _meta_path(p)
        if not mp.exists() and p.with_suffix(".json").exists():
            mp = p.with_suffix(".json")     # pre-fix saves (load-compat)
        try:
            meta = json.loads(mp.read_text())
        except FileNotFoundError:
            raise
        except Exception as e:              # torn/garbage sidecar bytes
            raise persist.IndexCorruptError(
                f"unreadable index sidecar at {mp}: {e!r}") from e
        z = persist.load_arrays(_npz_path(p), meta.get("checksums"))
        return _from_arrays(z, int(meta["entry"]),
                            _config_from_dict(meta["config"]), device)


def _ivf_arrays(ivf: ivf_mod.IVFState) -> dict:
    """The IVF state as the reference saves it (bin list words as its
    uint32)."""
    codes = ivf.list_codes.cpu().numpy()
    arrs = {"ivf_centroids": ivf.centroids.cpu().numpy(),
            "ivf_list_ids": ivf.list_ids.cpu().numpy(),
            "ivf_list_codes": (codes.view(np.uint32) if ivf.bin is not None
                               else codes)}
    if ivf.pq is not None:
        arrs["ivf_codebooks"] = ivf.pq.codebooks.cpu().numpy()
    if ivf.bin is not None:
        arrs["ivf_bin_rot"] = ivf.bin.rot.cpu().numpy()
    return arrs


def _from_arrays(arrays: dict, entry: int, config: IndexConfig,
                 device) -> KBest:
    idx = KBest(config, device=device)
    extra = sorted(set(arrays) - {"db", "graph", "order", *QUANT_ARRAYS,
                                  *IVF_ARRAYS})
    if extra:
        raise ValueError(f"unknown index arrays {extra}")

    def put(name, dtype):
        return torch.as_tensor(np.array(arrays[name], dtype=dtype),
                               device=idx.device)

    def put_words(name):
        """uint32 sign words on disk as their int32 bit-views."""
        return torch.as_tensor(
            np.array(arrays[name], dtype=np.uint32).view(np.int32),
            device=idx.device)

    def pq_state(name):
        books = put(name, np.float32)
        return qz.PQState(books, books.shape[0], books.shape[2])

    if "graph" in arrays:
        idx._set_state(put("db", np.float32), put("graph", np.int32), entry,
                       arrays.get("order"))
    else:
        idx.db = put("db", np.float32).contiguous()
    if "ivf_centroids" in arrays:
        binned = "ivf_bin_rot" in arrays
        idx.ivf = ivf_mod.IVFState(
            centroids=put("ivf_centroids", np.float32),
            list_ids=put("ivf_list_ids", np.int32),
            list_codes=(put_words("ivf_list_codes") if binned
                        else put("ivf_list_codes", np.uint8)),
            pq=pq_state("ivf_codebooks") if "ivf_codebooks" in arrays
            else None,
            residual=config.ivf.residual, packed=config.quant.kind == "pq4",
            bin=qz.BinState(put("ivf_bin_rot", np.float32)) if binned
            else None)
    if "pq_codebooks" in arrays:
        idx.pq = pq_state("pq_codebooks")
        idx.pq_codes = put("pq_codes", np.uint8)
    if "sq_scale" in arrays:
        idx.sq = qz.SQState(put("sq_scale", np.float32),
                            put("sq_zero", np.float32))
        idx.sq_codes = put("sq_codes", np.uint8)
    if "bin_rot" in arrays:
        idx.bin = qz.BinState(put("bin_rot", np.float32))
        idx.bin_codes = put_words("bin_codes")
    return idx


def resolve_search_cfg(config: IndexConfig, k: Optional[int],
                       search_cfg: Optional[SearchConfig]) -> SearchConfig:
    """Fold a per-call k override into a concrete SearchConfig (k > L
    widens the queue to fit)."""
    scfg = search_cfg or config.search
    if k is not None and k != scfg.k:
        scfg = dataclasses.replace(scfg, k=k, L=max(scfg.L, k))
    return scfg


def prep_queries(config: IndexConfig, queries, device) -> torch.Tensor:
    """Query-side add()-time preprocessing: f32 cast + cosine normalize."""
    q = torch.as_tensor(queries, dtype=torch.float32, device=device)
    if config.metric == "cosine":
        q = normalize(q)
    return q.contiguous()


def mask_padded_lanes(vm: torch.Tensor, dists: torch.Tensor,
                      ids: torch.Tensor, stats):
    """The search_padded output contract: invalid lanes come back as
    (+inf, -1) with zeroed stats. `stats` may be None."""
    dists = torch.where(vm[:, None], dists, torch.full_like(dists, float("inf")))
    ids = torch.where(vm[:, None], ids, torch.full_like(ids, -1))
    if stats is not None:
        zero = torch.zeros_like(stats.n_hops)
        stats = search_mod.SearchStats(
            n_hops=torch.where(vm, stats.n_hops, zero),
            n_dist=torch.where(vm, stats.n_dist, zero),
            early_terminated=stats.early_terminated & vm,
            iters=stats.iters)
    return dists, ids, stats


def _widen(scfg: SearchConfig) -> SearchConfig:
    """Quantized first passes return their whole (wide) queue, so the
    exact re-rank has at least 4k candidates to work with."""
    want = max(scfg.L, 4 * scfg.k)
    return dataclasses.replace(scfg, L=want, k=want)


def _widen_bin(scfg: SearchConfig) -> SearchConfig:
    """The bin first pass: the Hamming queue must hold the
    rescore_factor * k overfetch that the exact re-rank picks from. While
    rescore_factor * k <= L the traversal is the same for every factor
    and a deeper factor re-ranks a longer prefix of one ranking."""
    want = max(scfg.L, scfg.rescore_factor * scfg.k)
    return dataclasses.replace(scfg, L=want, k=want)


def _edge_weights(db: torch.Tensor, graph: torch.Tensor, metric: str,
                  chunk: int) -> np.ndarray:
    """Per-edge distances for the MST (non-finite -> 0), (n, M) numpy."""
    n = graph.shape[0]
    rows = torch.arange(n, dtype=torch.int32, device=db.device)
    out = [_chunk_dists(db, rows[s:s + chunk], graph[s:s + chunk], metric)
           for s in range(0, n, chunk)]
    w = torch.cat(out, dim=0)
    return torch.where(torch.isfinite(w), w, torch.zeros_like(w)).cpu().numpy()


def _meta_path(p: Path) -> Path:
    """Metadata sidecar: the FULL array-file name + ".json"."""
    return p.with_name(p.name + ".json")


def _npz_path(p: Path) -> Path:
    """The array file np.savez would have produced for `p`."""
    return p if p.suffix == ".npz" else Path(str(p) + ".npz")


def _known_fields(cls, d: dict) -> dict:
    """Drop keys this version's dataclass doesn't know, with a warning (a
    forward-compat load that loses knobs should be observable)."""
    names = {f.name for f in dataclasses.fields(cls)}
    dropped = sorted(set(d) - names)
    if dropped:
        warnings.warn(
            f"index metadata has {cls.__name__} keys {dropped} unknown to "
            f"this version — loading without them (their saved values are "
            f"discarded)", stacklevel=2)
    return {k: v for k, v in d.items() if k in names}


def _config_from_dict(d: dict) -> IndexConfig:
    from repro_torch.core.types import BuildConfig, IVFConfig, QuantConfig
    return IndexConfig(
        dim=d["dim"], metric=d["metric"],
        index_type=d.get("index_type", "graph"),
        n_shards=d.get("n_shards", 1),
        build=BuildConfig(**_known_fields(BuildConfig, d["build"])),
        search=SearchConfig(**_known_fields(SearchConfig, d["search"])),
        quant=QuantConfig(**_known_fields(QuantConfig, d["quant"])),
        ivf=IVFConfig(**_known_fields(IVFConfig, d.get("ivf", {}))),
    )
