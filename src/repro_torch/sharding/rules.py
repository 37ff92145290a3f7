"""Logical-axis -> mesh-axis sharding rules, the counterpart of the JAX
package's `sharding/rules.py` (DESIGN.md §6).

Parallelism plan over the production mesh (pod?, data, model):

  DP  : batch dims over ("pod", "data")      (pod folds into DP)
  TP  : d_ff / head-flat / vocab over "model" (Megatron column/row split)
  EP  : MoE expert dim over "data"            (all-to-all at dispatch)
  SP  : decode KV-cache sequence over "model" (flash-decoding style)
  ZeRO-1: optimizer moments additionally sharded over DP axes on the
          largest still-replicated divisible dim.

Every rule degrades gracefully: a dim that the mesh axes do not divide
stays replicated (never an error).

A mesh is the port's `DeviceMesh` (`launch/mesh.py`); the rules read only
its `mesh_dim_names` and axis sizes. A spec is a tuple with one entry per
dim: an axis name, a tuple of axis names (the dim split over all of them,
the first the major one, as `PartitionSpec` reads it), or None. The
reference's distinctions are kept: `lm_batch_spec` gives the tuple
`dp_axes(mesh)`, and `zero1_state_spec` a bare name when one DP axis is
left. `NamedSharding` holds a mesh and a spec, and gives the DTensor
placements and the per-rank shape of a global shape.

Specs are produced from parameter-tree paths (`a/b/c`, as `_path_str`
writes them), so the models stay mesh-agnostic; the tree functions walk
the port's nested dicts in `train/tree.py`'s order.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

from repro_torch.train.tree import path_key, tree_map_with_path


def axis_sizes(mesh) -> dict:
    """{axis name: size} of a mesh."""
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def entry_axes(part) -> Tuple[str, ...]:
    """The axis names of one spec entry (None: none), major first."""
    if part is None:
        return ()
    return part if isinstance(part, tuple) else (part,)


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec on a mesh, the counterpart of `jax.sharding.NamedSharding`.
    A spec shorter than the array's rank leaves the trailing dims
    replicated."""
    mesh: object
    spec: tuple

    def shard_shape(self, global_shape) -> Tuple[int, ...]:
        """Each rank's block of an array of `global_shape`: every dim
        divided by the product of its axes' sizes (they must divide it)."""
        sizes = axis_sizes(self.mesh)
        out = []
        for dim, n in enumerate(global_shape):
            part = self.spec[dim] if dim < len(self.spec) else None
            div = math.prod(sizes[a] for a in entry_axes(part))
            if n % div:
                raise ValueError(f"dim {dim} of {tuple(global_shape)} does "
                                 f"not split over {part!r} ({div} ranks)")
            out.append(n // div)
        return tuple(out)

    def placements(self) -> list:
        """DTensor placements, one a mesh dim: `Shard(d)` on every mesh
        dim that array dim d is split over, else `Replicate()`. A dim
        split over several axes gets one `Shard(d)` per axis, in mesh
        order, which is JAX's major-to-minor order; a tuple out of mesh
        order has no such layout and raises, as does an axis used
        twice."""
        from torch.distributed.tensor import Replicate, Shard
        names = list(self.mesh.mesh_dim_names)
        out = [Replicate()] * len(names)
        for dim, part in enumerate(self.spec):
            idx = [names.index(a) for a in entry_axes(part)]
            if idx != sorted(idx):
                raise ValueError(f"axes {part!r} of dim {dim} are not in "
                                 f"mesh order {tuple(names)}")
            for j in idx:
                if isinstance(out[j], Shard):
                    raise ValueError(f"axis {names[j]!r} shards two dims "
                                     f"of {self.spec!r}")
                out[j] = Shard(dim)
        return out


def dp_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in mesh.mesh_dim_names if a in ("pod", "data"))


def _fits(shape, dim: int, mesh, axes) -> bool:
    sizes = axis_sizes(mesh)
    return shape[dim] % math.prod(sizes[a] for a in entry_axes(axes)) == 0


def _spec(shape, assignment: dict, mesh) -> tuple:
    """assignment: {dim_index: axis or tuple-of-axes}; drops non-divisible."""
    parts = [None] * len(shape)
    for dim, ax in assignment.items():
        if ax is not None and _fits(shape, dim, mesh, ax):
            parts[dim] = ax
    return tuple(parts)


_path_str = path_key          # a tree path as "a/b/c"


# ---------------------------------------------------------------- LM -------
def lm_param_spec(path: str, shape, mesh, moe_d_sharded: bool = False
                  ) -> tuple:
    """moe_d_sharded: the shard_map MoE layout — w_in/w_gate sharded on d
    (contraction) instead of f; w_out stays f-sharded (see
    layers/moe.moe_ffn_shardmap and local_moe_params)."""
    mdl = "model"
    if path.endswith(("embed",)):                            # unembed too
        return _spec(shape, {0: mdl}, mesh)                  # (V, d)
    if path.endswith("unembed"):
        return _spec(shape, {1: mdl}, mesh)                  # (d, V)
    if "moe" in path:
        if "shared" in path:
            if path.endswith(("shared_w_in", "shared_w_gate")):
                return _spec(shape, {2: mdl}, mesh)          # (L, d, fs)
            if path.endswith("shared_w_out"):
                return _spec(shape, {1: mdl}, mesh)          # (L, fs, d)
            return _spec(shape, {}, mesh)
        # stacked (L, E, ...) expert weights: EP over data, TP over model
        if path.endswith(("w_in", "w_gate")):
            dim = 2 if moe_d_sharded else 3                  # (L, E, d, f)
            return _spec(shape, {1: "data", dim: mdl}, mesh)
        if path.endswith("w_out"):
            return _spec(shape, {1: "data", 2: mdl}, mesh)   # (L, E, f, d)
        return _spec(shape, {}, mesh)                        # router, biases
    if path.endswith(("wq", "wk", "wv")):
        return _spec(shape, {2: mdl}, mesh)                  # (L, d, H*hd)
    if path.endswith("wo"):
        return _spec(shape, {1: mdl}, mesh)                  # (L, H*hd, d)
    if path.endswith(("w_in", "w_gate")):
        return _spec(shape, {2: mdl}, mesh)                  # (L, d, f)
    if path.endswith("w_out"):
        return _spec(shape, {1: mdl}, mesh)                  # (L, f, d)
    return _spec(shape, {}, mesh)                            # norms, biases


def lm_batch_spec(shape, mesh) -> tuple:
    return _spec(shape, {0: dp_axes(mesh)}, mesh)


def lm_cache_shardings(cache_tree, mesh) -> dict:
    """KV cache (L, B, T, Hkv, hd): batch over DP + sequence over model
    (flash-decoding style SP). When B doesn't divide the DP axes (long_500k
    has B=1), the sequence dim absorbs ALL axes instead — 524288 % 512 == 0.
    len (B,): DP."""
    dp = dp_axes(mesh)
    all_axes = dp + ("model",)

    def spec(path, leaf):
        ps = _path_str(path)
        if ps.endswith("len"):
            return NamedSharding(mesh, _spec(leaf.shape, {0: dp}, mesh))
        if _fits(leaf.shape, 1, mesh, dp):
            return NamedSharding(
                mesh, _spec(leaf.shape, {1: dp, 2: "model"}, mesh))
        return NamedSharding(mesh, _spec(leaf.shape, {2: all_axes}, mesh))

    return tree_map_with_path(spec, cache_tree)


# ------------------------------------------------------------- recsys ------
def recsys_param_spec(path: str, shape, mesh) -> tuple:
    mdl = "model"
    if path.endswith("tables"):
        return _spec(shape, {1: mdl}, mesh)                  # (F, V, D)
    if path.endswith("linear") and len(shape) == 2:
        return _spec(shape, {1: mdl}, mesh)                  # (F, V)
    if path.endswith(("item_emb",)):
        return _spec(shape, {0: mdl}, mesh)                  # (V, Dm)
    if path.endswith("w") and len(shape) == 2:
        return _spec(shape, {1: mdl}, mesh)                  # MLP columns
    return _spec(shape, {}, mesh)


def recsys_batch_spec(shape, mesh) -> tuple:
    return _spec(shape, {0: dp_axes(mesh)}, mesh)


# -------------------------------------------------------------- dimenet ----
def dimenet_param_spec(path: str, shape, mesh) -> tuple:
    # parameters are tiny; data parallelism over edges instead
    return _spec(shape, {}, mesh)


def dimenet_batch_spec(path: str, shape, mesh,
                       shard_all_axes: bool = False) -> tuple:
    """Node/edge/triplet arrays row-sharded over DP; with shard_all_axes
    rows spread over EVERY mesh axis (16x less resident bytes per device
    on ogb_products' 495M-triplet arrays)."""
    axes = dp_axes(mesh) + ("model",) if shard_all_axes else dp_axes(mesh)
    return _spec(shape, {0: axes}, mesh)


# ---------------------------------------------------------------- trees ----
def tree_param_shardings(params_or_shapes, mesh, family: str,
                         moe_d_sharded: bool = False):
    fn = {"lm": lm_param_spec, "recsys": recsys_param_spec,
          "gnn": dimenet_param_spec}[family]

    def spec(path, leaf):
        if family == "lm":
            return NamedSharding(mesh, fn(_path_str(path), leaf.shape, mesh,
                                          moe_d_sharded))
        return NamedSharding(mesh, fn(_path_str(path), leaf.shape, mesh))

    return tree_map_with_path(spec, params_or_shapes)


def tree_batch_shardings(batch, mesh, family: str,
                         gnn_shard_all: bool = False):
    def spec(path, leaf):
        if family == "gnn":
            return NamedSharding(
                mesh, dimenet_batch_spec(_path_str(path), leaf.shape, mesh,
                                         gnn_shard_all))
        if family == "recsys":
            return NamedSharding(mesh, recsys_batch_spec(leaf.shape, mesh))
        return NamedSharding(mesh, lm_batch_spec(leaf.shape, mesh))

    return tree_map_with_path(spec, batch)


def zero1_state_spec(param_spec: tuple, shape, mesh) -> tuple:
    """Optimizer-moment sharding: param spec + DP over the largest
    still-replicated divisible dim (ZeRO-1). Mesh axes already consumed by
    the param spec (e.g. EP over "data" for expert weights) are excluded."""
    parts = list(param_spec) + [None] * (len(shape) - len(param_spec))
    used = set()
    for p in parts:
        used.update(entry_axes(p))
    dp = tuple(a for a in dp_axes(mesh) if a not in used)
    if not dp:
        return tuple(parts)
    sizes = axis_sizes(mesh)
    dp_size = math.prod(sizes[a] for a in dp)
    best, best_dim = 0, -1
    for i, (p, s) in enumerate(zip(parts, shape)):
        if p is None and s % dp_size == 0 and s > best:
            best, best_dim = s, i
    if best_dim >= 0:
        parts[best_dim] = dp if len(dp) > 1 else dp[0]
    return tuple(parts)
