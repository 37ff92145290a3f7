"""Per-(arch x shape) cell builders of the shape layer, the counterpart of
the JAX package's `launch/specs.py`.

For each of the 40 assigned cells this module produces:
  step_fn      the cell's step (train step / prefill / decode / serve /
               retrieval, per the shape's kind) on the port's tensors,
  args         `meta` tensors for every input: shape and dtype, no storage
               (the reference's `ShapeDtypeStruct`s),
  in_shardings the matching `NamedSharding`s of sharding/rules.py,
  meta         the model-flops accounting inputs, the reference's
               arithmetic expression for expression.

launch/dryrun.py runs each step once on its meta args over the production
meshes. Parameters come from each model's `param_spec` (no draw: meta
tensors have no generator), optimizer states from `opt_init` on them, the
KV cache from `init_cache(..., device="meta")`. Optimizer choice: AdamW
for the dense models, Adafactor for the MoE giants (factored second
moment).

Every step runs on the global args on one process, except under two
variants, whose steps run one rank's blocks and so need the mesh's
process group (dryrun brings up a `fake` one); moe_sm's also needs the
caller's `mesh_context(mesh)`, as the reference's shard_map reads the
ambient mesh that its dry-run sets:
  * moe_sm, train: the rank's token rows (the batch's sharding) and its
    expert blocks (`local_moe_params`, views of the global weights, so the
    gradients and the update keep the global shapes) through
    `moe_ffn_shardmap`; the data-parallel gradient reduction is not
    modelled. Prefill runs `moe_ffn`, as the reference's does; decode
    fails, as the reference's decode cells fail under moe_sm;
  * retr_shard: `serve_retrieval_shardmap`, which scores the rank's rows
    of the candidate table (its sharding's shard rows over "model").
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, NamedTuple, Tuple

import torch

from repro_torch import configs as cfg_registry
from repro_torch.layers.params import Leaf
from repro_torch.sharding import rules
from repro_torch.sharding.rules import NamedSharding
from repro_torch.train.loop import train_step
from repro_torch.train.optimizer import OptConfig, opt_init
from repro_torch.train.tree import tree_map, tree_map_with_path

F32, BF16, I32 = torch.float32, torch.bfloat16, torch.int32


class Cell(NamedTuple):
    arch: str
    shape: str
    kind: str                    # train | prefill | decode | serve | retrieval
    step_fn: Callable
    args: Tuple                  # trees of meta tensors
    in_shardings: Tuple
    meta: Dict[str, Any]         # model-flops accounting inputs etc.


def _sds(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _meta_params(spec):
    """A model's `param_spec` as meta tensors."""
    return tree_map(lambda s: _sds(s.shape, s.dtype), spec,
                    is_leaf=lambda x: isinstance(x, Leaf))


def _train_step(loss_fn: Callable, opt_cfg: OptConfig) -> Callable:
    """(params, opt_state, batch) -> (new params, new state, loss): the
    Trainer's step."""
    def step(params, opt_state, batch):
        new_p, new_s, metrics = train_step(loss_fn, opt_cfg, params,
                                           opt_state, batch)
        return new_p, new_s, metrics["loss"]
    return step


def _rank_block(x: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """This rank's block of a global tensor under `sharding`: on each dim,
    the rank's linear index over the dim's axes (the first the major one)
    times the block's extent."""
    mesh = sharding.mesh
    coord = dict(zip(mesh.mesh_dim_names, mesh.get_coordinate()))
    sizes = rules.axis_sizes(mesh)
    block = sharding.shard_shape(x.shape)
    for dim, part in enumerate(sharding.spec):
        idx = 0
        for a in rules.entry_axes(part):
            idx = idx * sizes[a] + coord[a]
        x = x.narrow(dim, idx * block[dim], block[dim])
    return x


# =========================================================== LM cells ======
LM_SHAPE_PARAMS = {
    "train_4k": dict(seq=4096, batch=256, kind="train"),
    "prefill_32k": dict(seq=32768, batch=32, kind="prefill"),
    "decode_32k": dict(seq=32768, batch=128, kind="decode"),
    "long_500k": dict(seq=524288, batch=1, kind="decode"),
}


def _lm_param_count(cfg) -> float:
    """Total and active parameter counts (for MODEL_FLOPS = 6*N*D)."""
    d, hd = cfg.d_model, cfg.hd
    attn = d * (cfg.n_heads * hd) + 2 * d * (cfg.n_kv_heads * hd) \
        + (cfg.n_heads * hd) * d
    if cfg.moe is not None:
        m = cfg.moe
        per_exp = (3 if m.gated else 2) * d * m.d_ff_expert
        moe_total = m.n_experts * per_exp
        moe_active = m.top_k * per_exp
        shared = m.n_shared_experts * per_exp
        total = cfg.n_layers * (attn + moe_total + shared)
        active = cfg.n_layers * (attn + moe_active + shared)
    else:
        mlp = (3 if cfg.gated_mlp else 2) * d * cfg.d_ff
        total = cfg.n_layers * (attn + mlp)
        active = total
    emb = cfg.vocab * d * (1 if cfg.tie_embeddings else 2)
    return total + emb, active + emb


def _lm_cell(arch: str, shape: str, mesh, depth=None, unroll=False,
             opts=None) -> Cell:
    from repro_torch.layers.moe import local_moe_params
    from repro_torch.models import transformer as T

    opts = opts or {}
    mod = cfg_registry.get(arch)
    cfg = mod.full_config()
    if depth is not None or unroll:
        cfg = dataclasses.replace(
            cfg, n_layers=depth or cfg.n_layers, unroll_layers=unroll)
    dp = rules.dp_axes(mesh)
    sizes = rules.axis_sizes(mesh)
    moe_d_sharded = False
    if opts.get("moe_sm") and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, ep_axis="data", tp_axis="model", token_axes=dp,
            use_shardmap=True, ep_size=sizes["data"],
            tp_size=sizes["model"]))
        moe_d_sharded = True
    elif opts.get("moe_ep") and cfg.moe is not None:
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe, ep_axis="data", tp_axis="model", token_axes=dp))
    if opts.get("lm_loss"):
        cfg = dataclasses.replace(cfg, loss_vocab_axis="model",
                                  loss_batch_axes=dp,
                                  loss_vocab_shards=sizes["model"])
    if opts.get("remat_dots"):
        cfg = dataclasses.replace(cfg, remat_policy=opts["remat_dots"]
                                  if isinstance(opts["remat_dots"], str)
                                  else "dots")
    sp = LM_SHAPE_PARAMS[shape]
    B, S = sp["batch"], sp["seq"]
    kind = sp["kind"]

    params_s = _meta_params(T.param_spec(cfg))
    p_sh = rules.tree_param_shardings(params_s, mesh, "lm",
                                      moe_d_sharded=moe_d_sharded)
    n_total, n_active = _lm_param_count(cfg)
    opt_cfg = OptConfig(kind="adafactor" if cfg.moe is not None else "adamw")

    if kind == "train":
        opt_s = opt_init(params_s, opt_cfg)
        o_sh = _opt_shardings(opt_s, p_sh, mesh)
        batch = {"tokens": _sds((B, S + 1), I32)}
        b_sh = rules.tree_batch_shardings(batch, mesh, "lm")

        def loss(params, batch):
            if not moe_d_sharded:
                return T.loss_fn(params, batch, cfg)
            layers = dict(params["layers"], moe=local_moe_params(
                params["layers"]["moe"], cfg.moe))
            return T.loss_fn(dict(params, layers=layers),
                             tree_map(_rank_block, batch, b_sh), cfg)

        return Cell(arch, shape, kind, _train_step(loss, opt_cfg),
                    (params_s, opt_s, batch), (p_sh, o_sh, b_sh),
                    dict(model_flops=6.0 * n_active * B * S, tokens=B * S,
                         n_total=n_total, n_active=n_active))

    if kind == "prefill":
        tokens = _sds((B, S), I32)
        t_sh = rules.tree_batch_shardings(tokens, mesh, "lm")

        def step(params, tokens):
            return T.prefill(params, tokens, cfg)

        return Cell(arch, shape, kind, step, (params_s, tokens),
                    (p_sh, t_sh),
                    dict(model_flops=2.0 * n_active * B * S, tokens=B * S,
                         n_total=n_total, n_active=n_active))

    # decode
    cache_s = T.init_cache(cfg, B, S, device="meta")
    c_sh = rules.lm_cache_shardings(cache_s, mesh)
    tokens = _sds((B, 1), I32)
    t_sh = rules.tree_batch_shardings(tokens, mesh, "lm")

    def step(params, cache, tokens):
        return T.decode_step(params, cache, tokens, cfg)

    # decode flops: 2*N_active per token + cache read bytes dominate
    return Cell(arch, shape, "decode", step, (params_s, cache_s, tokens),
                (p_sh, c_sh, t_sh),
                dict(model_flops=2.0 * n_active * B, tokens=B,
                     n_total=n_total, n_active=n_active,
                     cache_bytes=2 * cfg.n_layers * B * S
                     * cfg.n_kv_heads * cfg.hd * 2))


def _opt_shardings(opt_s, p_sh, mesh):
    """ZeRO-1 shardings for optimizer moments: param spec (rank-adapted for
    Adafactor's factored vr/vc) + DP over the largest replicated dim.
    Moment trees have the param tree as a prefix."""
    def fill(ps, subtree):
        pspec = list(ps.spec)

        def leaf(path, x):
            key = str(path[-1]) if path else ""
            r = len(x.shape)
            parts = pspec + [None] * (r + 1 - len(pspec))
            if key == "vr":          # param.shape[:-1] -> drop last spec dim
                spec = tuple(parts[:r])
            elif key == "vc":        # param.shape[:-2] + (param.shape[-1],)
                spec = tuple(parts[:r - 1] + [parts[r]])
            else:                    # v / m: same shape as param
                spec = tuple(parts[:r])
            return NamedSharding(mesh, rules.zero1_state_spec(spec, x.shape,
                                                              mesh))

        return tree_map_with_path(leaf, subtree)

    out = {}
    for k, v in opt_s.items():
        if k == "count":
            out[k] = NamedSharding(mesh, ())
        elif k in ("m", "v"):
            out[k] = tree_map(fill, p_sh, v)
        else:
            out[k] = _replicated(v, mesh)
    return out


def _replicated(tree, mesh):
    return tree_map(lambda _: NamedSharding(mesh, ()), tree)


# ========================================================== GNN cells ======
def _gnn_cell(arch: str, shape: str, mesh, depth=None, unroll=False,
              opts=None) -> Cell:
    from repro_torch.configs.dimenet import SHAPE_PARAMS, TRIPLET_CAP
    from repro_torch.models import dimenet as D

    opts = opts or {}
    mod = cfg_registry.get(arch)
    cfg = mod.full_config(shape)
    if depth is not None or unroll:
        cfg = dataclasses.replace(
            cfg, n_blocks=depth or cfg.n_blocks, unroll_blocks=unroll)
    if opts.get("gnn_remat"):
        cfg = dataclasses.replace(cfg, remat=True)
    sp = SHAPE_PARAMS[shape]

    if shape == "minibatch_lg":
        b = sp["batch_nodes"]
        f1, f2 = sp["fanouts"]
        N = b + b * f1 + b * f1 * f2
        E = b * f1 + b * f1 * f2
    elif shape == "molecule":
        N = sp["n_nodes"] * sp["batch"]
        E = sp["n_edges"] * sp["batch"]
    else:
        N, E = sp["n_nodes"], sp["n_edges"]
    T_ = E * TRIPLET_CAP
    n_graphs = sp.get("batch", 1)

    batch = {
        "feats": _sds((N, sp["d_feat"]), F32),
        "pos": _sds((N, 3), F32),
        "edge_src": _sds((E,), I32), "edge_dst": _sds((E,), I32),
        "trip_kj": _sds((T_,), I32), "trip_ji": _sds((T_,), I32),
    }
    if cfg.task == "graph_reg":
        batch["node_graph"] = _sds((N,), I32)
        batch["targets"] = _sds((n_graphs,), F32)
    else:
        batch["labels"] = _sds((N,), I32)

    params_s = _meta_params(D.param_spec(cfg))
    p_sh = rules.tree_param_shardings(params_s, mesh, "gnn")
    b_sh = rules.tree_batch_shardings(
        batch, mesh, "gnn", gnn_shard_all=bool(opts.get("gnn_shard_all")))
    opt_cfg = OptConfig(kind="adamw")
    opt_s = opt_init(params_s, opt_cfg)
    o_sh = _replicated(opt_s, mesh)
    step = _train_step(
        functools.partial(D.loss_fn, cfg=cfg, n_graphs=n_graphs), opt_cfg)

    # message-passing flops: per block, triplet gather T*nb + edge GEMMs
    H = cfg.d_hidden
    mf = cfg.n_blocks * (2.0 * E * H * H * 4 + 2.0 * T_ * cfg.n_bilinear) \
        + 2.0 * N * sp["d_feat"] * H
    return Cell(arch, shape, "train", step, (params_s, opt_s, batch),
                (p_sh, o_sh, b_sh), dict(model_flops=mf, tokens=N))


# ======================================================= recsys cells ======
RECSYS_SHAPE_PARAMS = {
    "train_batch": dict(batch=65536, kind="train"),
    "serve_p99": dict(batch=512, kind="serve"),
    "serve_bulk": dict(batch=262144, kind="serve"),
    "retrieval_cand": dict(batch=1, n_candidates=1_000_000, kind="retrieval"),
}


def _recsys_batch_specs(cfg, B: int, kind: str) -> dict:
    if cfg.kind in ("fm", "deepfm"):
        b = {"sparse_ids": _sds((B, cfg.n_sparse), I32)}
        if kind == "train":
            b["label"] = _sds((B,), F32)
    elif cfg.kind == "bst":
        b = {"hist": _sds((B, cfg.seq_len), I32),
             "target": _sds((B,), I32)}
        if kind == "train":
            b["label"] = _sds((B,), F32)
    else:  # bert4rec
        b = {"seq": _sds((B, cfg.seq_len), I32)}
        if kind == "train":
            b["labels"] = _sds((B, cfg.seq_len), I32)
        elif kind == "serve":
            b["cand"] = _sds((B,), I32)
    return b


def _recsys_flops(cfg, B: int) -> float:
    if cfg.kind in ("fm", "deepfm"):
        f = 2.0 * B * cfg.n_sparse * cfg.embed_dim
        if cfg.kind == "deepfm":
            dims = (cfg.n_sparse * cfg.embed_dim,) + tuple(cfg.mlp_dims) + (1,)
            f += 2.0 * B * sum(a * b for a, b in zip(dims, dims[1:]))
        return f
    S, Dm = (cfg.seq_len + (1 if cfg.kind == "bst" else 0)), cfg.d_model
    per_block = 2.0 * S * (4 * Dm * Dm) + 2.0 * S * S * Dm * 2 \
        + 2.0 * S * (8 * Dm * Dm)
    f = B * cfg.n_blocks * per_block
    if cfg.kind == "bst":
        dims = (S * Dm,) + tuple(cfg.mlp_dims) + (1,)
        f += 2.0 * B * sum(a * b for a, b in zip(dims, dims[1:]))
    return f


def _recsys_cell(arch: str, shape: str, mesh, depth=None, unroll=False,
                 opts=None) -> Cell:
    from repro_torch.models import recsys as R

    opts = opts or {}
    mod = cfg_registry.get(arch)
    cfg = mod.full_config()
    if depth is not None or unroll:
        cfg = dataclasses.replace(
            cfg, n_blocks=depth or cfg.n_blocks, unroll_blocks=unroll)
    if opts.get("masked_loss") and cfg.kind == "bert4rec":
        cfg = dataclasses.replace(cfg, masked_positions=40)
    sp = RECSYS_SHAPE_PARAMS[shape]
    B, kind = sp["batch"], sp["kind"]

    params_s = _meta_params(R.param_spec(cfg))
    p_sh = rules.tree_param_shardings(params_s, mesh, "recsys")
    batch = _recsys_batch_specs(cfg, B, kind)
    b_sh = rules.tree_batch_shardings(batch, mesh, "recsys")

    if kind == "train":
        opt_cfg = OptConfig(kind="adamw")
        opt_s = opt_init(params_s, opt_cfg)
        o_sh = _opt_shardings(opt_s, p_sh, mesh)
        step = _train_step(functools.partial(R.loss_fn, cfg=cfg), opt_cfg)
        return Cell(arch, shape, kind, step, (params_s, opt_s, batch),
                    (p_sh, o_sh, b_sh),
                    dict(model_flops=3.0 * _recsys_flops(cfg, B), tokens=B))

    if kind == "serve":
        def step(params, batch):
            return R.serve_step(params, batch, cfg)

        return Cell(arch, shape, kind, step, (params_s, batch), (p_sh, b_sh),
                    dict(model_flops=_recsys_flops(cfg, B), tokens=B))

    # retrieval: the paper's vector-search workload, exact 1-to-B path, on
    # the plain distances (a kernel cannot run on meta tensors)
    n_cand = sp["n_candidates"]

    if opts.get("retrieval_sharded"):
        def step(params, batch):
            return R.serve_retrieval_shardmap(params, batch, cfg, mesh,
                                              k=100)
    else:
        def step(params, batch):
            return R.serve_retrieval(params, batch, cfg, k=100)

    D_ = cfg.embed_dim if cfg.kind in ("fm", "deepfm") else cfg.d_model
    return Cell(arch, shape, kind, step, (params_s, batch), (p_sh, b_sh),
                dict(model_flops=_recsys_flops(cfg, B)
                     + 2.0 * B * n_cand * D_, tokens=B,
                     n_candidates=n_cand))


# ================================================================ facade ===
# Named optimization variants. "baseline" is the paper-faithful
# configuration; each variant toggles one change.
VARIANTS = {
    "baseline": {},
    "moe_ep": {"moe_ep": True},
    "lm_loss": {"lm_loss": True},
    "lm_opt": {"moe_ep": True, "lm_loss": True, "remat_dots": True},
    "lm_opt_nb": {"moe_ep": True, "lm_loss": True, "remat_dots": "dots_nb"},
    "moe_sm": {"moe_sm": True, "lm_loss": True},
    "moe_sm_dots": {"moe_sm": True, "lm_loss": True, "remat_dots": True},
    "gnn_mem": {"gnn_remat": True, "gnn_shard_all": True},
    "gnn_remat": {"gnn_remat": True},
    "retr_shard": {"retrieval_sharded": True},
    "masked_loss": {"masked_loss": True},
    "opt": {"moe_ep": True, "lm_loss": True, "gnn_remat": True,
            "gnn_shard_all": True, "retrieval_sharded": True,
            "masked_loss": True},
}


def build_cell(arch: str, shape: str, mesh, depth=None,
               unroll: bool = False, variant: str = "baseline") -> Cell:
    """depth/unroll: the reference's cost-extrapolation variants (1- and
    2-layer unrolled lowerings); here depth cuts the layers the step runs
    and unroll changes nothing (the port always runs one Python loop)."""
    opts = VARIANTS[variant]
    mod = cfg_registry.get(arch)
    fam = mod.FAMILY
    assert shape in mod.SHAPES, (arch, shape, mod.SHAPES)
    if fam == "lm":
        return _lm_cell(arch, shape, mesh, depth, unroll, opts)
    if fam == "gnn":
        return _gnn_cell(arch, shape, mesh, depth, unroll, opts)
    return _recsys_cell(arch, shape, mesh, depth, unroll, opts)


def cell_depth(arch: str) -> int:
    """The layer-loop trip count of the arch's full config (1 = no loop)."""
    mod = cfg_registry.get(arch)
    if mod.FAMILY == "lm":
        return mod.full_config().n_layers
    if mod.FAMILY == "gnn":
        return mod.full_config("full_graph_sm").n_blocks
    cfg = mod.full_config()
    return getattr(cfg, "n_blocks", 1) if cfg.kind in ("bst", "bert4rec") else 1
