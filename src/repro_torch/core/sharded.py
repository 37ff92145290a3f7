"""ShardedKBest — a shard-per-device composition of KBest indexes
(DESIGN.md §12), the counterpart of the JAX package's
`repro/core/sharded.py`.

    index = ShardedKBest(config, n_shards=2)   # on the card; device="cpu"
    index.add(x)                               # P independent builds
    d, i = index.search(q, k)                  # global top-k, global ids
    index.save(path) / ShardedKBest.load(path)

The corpus is split into P contiguous row ranges (`shard_bounds`: the first
n % P shards take one extra row). Each shard is an INDEPENDENT one-shard
KBest — its own graph and entry point or its own coarse centroids and
lists, its own codebooks — so no edge or list crosses shards. A query runs
the whole shard-local pipeline on every shard (the quantized first pass
and the shard-local exact re-rank included); shard s adds `offsets[s]` to
its ids, and the per-shard exact top-k are merged into the global top-k.

The merge is a stable ascending top-k over the (Q, P*k) concatenation whose
ties go to the lower column (`build.stable_topk_smallest`), the order the
reference's `lax.top_k(-d, k)` gives; `+inf` / `-1` slots (padded lanes,
shards with fewer than k hits) sort last in column order. With one shard
the merge is skipped, so P = 1 is bit-identical to KBest by construction.

Merged stats: `n_hops` and `n_dist` are summed per query (the work across
all shards), `early_terminated` is ANDed (a lane counts as early-terminated
only when every shard's traversal fired), `iters` is the max (the critical
path). All reduce to the one-index stats at P = 1.

`ShardedKBest` runs its shards one after another on one device. The
reference's `shard_map` lowering of the full-precision graph path is
`build_sharded_search` / `make_sharded_arrays` below, over a device mesh
(`launch/mesh.py`) with one shard a rank: each rank searches its own block
and the per-shard top-k are all-gathered over the flattened mesh and
merged the same way.

Persistence is the reference's: each shard through `KBest.save` as
`<path>.shard<s>`, then the `<path>.sharded.json` manifest (n_shards,
offsets, the config, format 2 and a crc32 of every shard's sidecar),
written last as the commit point, so either package loads the other's
saves and a partial save raises `persist.IndexCorruptError`.
"""
from __future__ import annotations

import dataclasses
import functools
import json
import math
from pathlib import Path
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from repro_torch.core import persist
from repro_torch.core import search as search_mod
from repro_torch.core.build import stable_topk_smallest
from repro_torch.core.index import (KBest, _config_from_dict, _meta_path,
                                    mask_padded_lanes, prep_queries,
                                    resolve_device, resolve_search_cfg)
from repro_torch.core.types import IndexConfig, SearchConfig
from repro_torch.launch.mesh import gather_stack, mesh_device, mesh_flat


def shard_bounds(n: int, n_shards: int) -> np.ndarray:
    """(P+1,) row offsets of the contiguous split; the first n % P shards
    take one extra row, so any n >= P splits without padding."""
    assert n >= n_shards >= 1, (n, n_shards)
    base, rem = divmod(n, n_shards)
    sizes = np.full(n_shards, base, np.int64)
    sizes[:rem] += 1
    return np.concatenate([[0], np.cumsum(sizes)])


def merge_stats(per_shard: Sequence[search_mod.SearchStats]
                ) -> search_mod.SearchStats:
    """Fold per-shard stats into one SearchStats (module docstring;
    the identity for one shard)."""
    return search_mod.SearchStats(
        n_hops=functools.reduce(torch.add, [s.n_hops for s in per_shard]),
        n_dist=functools.reduce(torch.add, [s.n_dist for s in per_shard]),
        early_terminated=functools.reduce(
            torch.logical_and, [s.early_terminated for s in per_shard]),
        iters=functools.reduce(torch.maximum, [s.iters for s in per_shard]),
    )


class ShardedKBest:
    """KBest's surface over P independent per-shard indexes (add / search /
    search_padded / save / load and the `_resolve_cfg` hook the serving
    engine keys on), so `SearchEngine` serves it unchanged."""

    def __init__(self, config: IndexConfig, n_shards: Optional[int] = None,
                 device=None):
        if n_shards is not None and n_shards != config.n_shards:
            config = dataclasses.replace(config, n_shards=n_shards)
        self.config = config
        self.device = resolve_device(device)
        self.shards: List[KBest] = []
        self.offsets: Optional[np.ndarray] = None   # (P+1,) global rows

    @property
    def n_shards(self) -> int:
        return self.config.n_shards

    @property
    def mesh_shape(self) -> Tuple[int, ...]:
        """The flat "shards" view (the engine's cache-key component)."""
        return (self.config.n_shards,)

    @property
    def db(self) -> Optional[torch.Tensor]:
        """Shard 0's vectors: not None once built (the engine's built-index
        check and query width)."""
        return self.shards[0].db if self.shards else None

    @property
    def n_total(self) -> int:
        return int(self.offsets[-1]) if self.offsets is not None else 0

    def add(self, x) -> "ShardedKBest":
        """Split the rows into n_shards contiguous ranges and build each as
        an independent one-shard KBest; each shard's stage seconds stay in
        its `build_times`."""
        x = np.asarray(x, dtype=np.float32)
        assert x.ndim == 2 and x.shape[1] == self.config.dim, x.shape
        self.offsets = shard_bounds(x.shape[0], self.config.n_shards)
        shard_cfg = dataclasses.replace(self.config, n_shards=1)
        self.shards = [
            KBest(shard_cfg, device=self.device).add(
                x[self.offsets[s]:self.offsets[s + 1]])
            for s in range(self.config.n_shards)]
        return self

    def search(self, queries, k: Optional[int] = None,
               search_cfg: Optional[SearchConfig] = None,
               with_stats: bool = False):
        """Global top-k over every shard, KBest.search's signature and
        returns; ids are rows of the add() matrix."""
        assert self.shards, "call add() first"
        scfg = self._resolve_cfg(k, search_cfg)
        dists, ids, stats = self._search_impl(
            prep_queries(self.config, queries, self.device), scfg,
            valid_mask=None)
        return (dists, ids, stats) if with_stats else (dists, ids)

    def search_padded(self, queries, valid_mask, k: Optional[int] = None,
                      search_cfg: Optional[SearchConfig] = None,
                      with_stats: bool = False):
        """KBest.search_padded over the shards: padded lanes start inactive
        in every shard and come back as (+inf, -1) with zeroed stats."""
        assert self.shards, "call add() first"
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
        return resolve_search_cfg(self.config, k, search_cfg)

    def _search_impl(self, q: torch.Tensor, scfg: SearchConfig,
                     valid_mask: Optional[torch.Tensor]):
        """Shard-local searches -> global ids -> the stable cross-shard
        top-k. Returns (dists, ids, merged stats)."""
        per_d, per_i, per_s = [], [], []
        for s, shard in enumerate(self.shards):
            d, i, st = shard._search_impl(q, scfg, valid_mask=valid_mask)
            off = int(self.offsets[s])
            per_d.append(d)
            per_i.append(torch.where(i >= 0, i + off, torch.full_like(i, -1)))
            per_s.append(st)
        if len(self.shards) == 1:
            # the merge of one shard's sorted top-k is the identity
            return per_d[0], per_i[0], merge_stats(per_s)
        all_d = torch.cat(per_d, dim=1)                  # (Q, P*k)
        all_i = torch.cat(per_i, dim=1)
        dists, pos = stable_topk_smallest(all_d, scfg.k)
        return dists, torch.gather(all_i, 1, pos), merge_stats(per_s)

    # ------------------------------------------------------------ save/load
    @staticmethod
    def _shard_path(path: str, s: int) -> str:
        return f"{path}.shard{s}"

    def save(self, path: str) -> None:
        """Each shard's crash-safe KBest.save, then the manifest LAST as the
        commit point (DESIGN.md §17); it holds a crc32 of every shard's
        sidecar, so shards of another save generation under it are a
        detectable partial save."""
        assert self.shards, "call add() first"
        p = Path(path)
        p.parent.mkdir(parents=True, exist_ok=True)
        for s, shard in enumerate(self.shards):
            shard.save(self._shard_path(path, s), _label=f"shard{s}")
        shard_meta_crc = {
            str(s): persist.file_crc32(
                _meta_path(Path(self._shard_path(path, s))))
            for s in range(len(self.shards))}
        meta = {"n_shards": self.config.n_shards,
                "offsets": np.asarray(self.offsets).tolist(),
                "config": dataclasses.asdict(self.config),
                "format": 2,
                "shard_meta_crc": shard_meta_crc}
        persist.atomic_write(Path(str(p) + ".sharded.json"),
                             json.dumps(meta).encode(), "manifest")

    @classmethod
    def load(cls, path: str, device=None) -> "ShardedKBest":
        """Manifest first: an unreadable manifest, a missing shard sidecar
        or a sidecar whose crc32 disagrees with the manifest raises
        persist.IndexCorruptError instead of assembling shards of
        different save generations."""
        mp = Path(str(path) + ".sharded.json")
        try:
            meta = json.loads(mp.read_text())
        except FileNotFoundError:
            raise
        except Exception as e:
            raise persist.IndexCorruptError(
                f"unreadable sharded manifest at {mp}: {e!r}") from e
        crcs = meta.get("shard_meta_crc")   # absent on pre-§17 manifests
        if crcs is not None:
            for s in range(meta["n_shards"]):
                sp = _meta_path(Path(cls._shard_path(path, s)))
                try:
                    got = persist.file_crc32(sp)
                except FileNotFoundError as e:
                    raise persist.IndexCorruptError(
                        f"manifest names shard {s} but its sidecar {sp} "
                        f"is missing (partial sharded save)") from e
                if got != int(crcs[str(s)]):
                    raise persist.IndexCorruptError(
                        f"shard {s} sidecar {sp} does not match the "
                        f"manifest (crc32 {got} != {crcs[str(s)]}): "
                        f"partial sharded save")
        idx = cls(_config_from_dict(meta["config"]),
                  n_shards=meta["n_shards"], device=device)
        idx.offsets = np.asarray(meta["offsets"], dtype=np.int64)
        idx.shards = [KBest.load(cls._shard_path(path, s), device=idx.device)
                      for s in range(meta["n_shards"])]
        return idx


def pad_to_shard_boundary(db: np.ndarray, graph: np.ndarray, n_shards: int
                          ) -> Tuple[np.ndarray, np.ndarray, int]:
    """Pad (db, graph) rows up to n_local * P with sentinel rows (a zero
    vector, an all -1 graph row), the equal-block layout of a device mesh:
    shard s owns rows [s*n_local, (s+1)*n_local) with n_local = ceil(n/P),
    every shard full but the last. Data split another way (shard_bounds
    puts the remainder on the FIRST shards) must be laid out in n_local
    blocks first. A sentinel is unreachable: no real row's edges and no
    entry point name it. Returns (db_padded, graph_padded, n_local)."""
    db = np.asarray(db)
    graph = np.asarray(graph)
    n = db.shape[0]
    assert graph.shape[0] == n, (db.shape, graph.shape)
    n_local = -(-n // n_shards)
    pad = n_local * n_shards - n
    if pad:
        db = np.concatenate(
            [db, np.zeros((pad, db.shape[1]), db.dtype)], axis=0)
        graph = np.concatenate(
            [graph, np.full((pad, graph.shape[1]), -1, graph.dtype)], axis=0)
    return db, graph, n_local


# --------------------------------------------------------------------------
# The device-mesh lowering of the sharded full-precision graph path: one
# shard a rank, the same local search + all-gather + global top-k merge as
# ShardedKBest.
# --------------------------------------------------------------------------
def mesh_size(mesh) -> int:
    return math.prod(mesh.shape)


def build_sharded_search(mesh, cfg: SearchConfig, metric: str, n_local: int):
    """Returns fn(db, graph, entries, queries) -> (dists, ids), run by every
    rank of the mesh on its own blocks (`make_sharded_arrays`):

    db:      (n_local, d) this rank's rows of the (P*n_local, d) corpus
    graph:   (n_local, M) its graph rows, *local* ids in [0, n_local)
    entries: (1,) int32 its entry point (a local id)
    queries: (Q, d) the same on every rank
    Output:  (Q, k) the global top-k, the same on every rank; ids are rows
             of the concatenated blocks (shard s's local id + s*n_local).

    The rank's shard index is its row-major linear index over the mesh's
    axes. Each rank runs `search` on `make_dist_fn(db, metric,
    cfg.dist_impl)` (the gather_dist kernel for "kernel" on the card);
    the merge is a stable ascending top-k over the shard-major
    concatenation, ties to the lower position as `lax.top_k` breaks them.
    """
    flat = mesh_flat(mesh)
    off = flat.index * n_local

    def fn(db, graph, entries, queries):
        dist_fn = search_mod.make_dist_fn(db, metric, cfg.dist_impl)
        dists, ids, _ = search_mod.search(graph, queries, entries,
                                          dist_fn=dist_fn, cfg=cfg,
                                          n_total=n_local)
        gids = torch.where(ids >= 0, ids + off, torch.full_like(ids, -1))
        Q, k = dists.shape
        all_d = gather_stack(dists, flat).permute(1, 0, 2).reshape(Q, -1)
        all_i = gather_stack(gids, flat).permute(1, 0, 2).reshape(Q, -1)
        vals, pos = stable_topk_smallest(all_d, k)
        return vals, torch.gather(all_i, 1, pos)

    return fn


def make_sharded_arrays(mesh, db, graph, entries, queries):
    """This rank's blocks for build_sharded_search, on the mesh's device,
    from the global host arrays: db (n, d), graph (n, M) with local ids,
    entries (P,) one local entry point a shard, queries (Q, d).

    An uneven corpus (n % P != 0) is padded to the shard boundary with
    sentinel rows first (pad_to_shard_boundary, whose tail-short layout
    contract applies). The real rows of the block are checked to
    round-trip exactly, as the reference checks its placement; that
    cannot catch data laid out against the contract."""
    flat = mesh_flat(mesh)
    dev = mesh_device(mesh)
    db = np.asarray(db)
    graph = np.asarray(graph)
    entries = np.asarray(entries)
    assert entries.shape[0] == flat.size, \
        f"need one entry point per shard: {entries.shape[0]} != {flat.size}"
    n = db.shape[0]
    db_p, graph_p, n_local = pad_to_shard_boundary(db, graph, flat.size)
    lo = flat.index * n_local
    out = (torch.as_tensor(db_p[lo:lo + n_local], device=dev),
           torch.as_tensor(graph_p[lo:lo + n_local], dtype=torch.int32,
                           device=dev),
           torch.as_tensor(entries[flat.index:flat.index + 1],
                           dtype=torch.int32, device=dev),
           torch.as_tensor(queries, dtype=torch.float32, device=dev))
    real = max(0, min(n, lo + n_local) - lo)
    assert np.array_equal(out[0][:real].cpu().numpy(), db[lo:lo + real]), \
        "db round-trip"
    assert np.array_equal(out[1][:real].cpu().numpy(),
                          graph[lo:lo + real]), "graph round-trip"
    return out
