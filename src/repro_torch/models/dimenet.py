"""DimeNet (arXiv:2003.03123), directional message passing, the counterpart
of the JAX package's `models/dimenet.py`.

Messages live on edges, and the interaction term couples message m_kj
into m_ji through an angular basis over the triplet (k->j->i). The message
passing runs on explicit index arrays; each of the reference's
`jax.ops.segment_sum` is an `index_add` onto a zero tensor:

  edges:    edge_src[e] = j, edge_dst[e] = i  (message j -> i)
  triplets: trip_kj[t], trip_ji[t] index into the edge list

The basis is the reference's simplification: cos(m*theta) x Gaussian-RBF(d)
in place of the 2-D spherical-Bessel basis, and the DimeNet++-style
down-projection to n_bilinear channels (arXiv:2011.14115). Positions of
non-geometric graphs are a precomputed (N, 3) input. Tasks: "node_clf"
(citation/products) or "graph_reg" (molecule batches).

Parameters are a nested dict keyed as the reference's pytree (`blocks/*`
stacked `(n_blocks, ...)`); `params_from_numpy` carries the reference's
weights across. The blocks run in a Python loop (the reference's
`lax.scan`; `unroll_blocks`, its cost-analysis switch, gives the same
loop); `remat` checkpoints each block.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch
import torch.nn.functional as F
from torch.utils import checkpoint as ckpt

from repro_torch.layers import params as P
from repro_torch.layers.params import Leaf


@dataclasses.dataclass(frozen=True)
class DimeNetConfig:
    name: str = "dimenet"
    n_blocks: int = 6
    d_hidden: int = 128
    n_bilinear: int = 8
    n_spherical: int = 7
    n_radial: int = 6
    d_feat: int = 128
    n_out: int = 16              # classes (node_clf) or 1 (graph_reg)
    cutoff: float = 5.0
    task: str = "node_clf"       # "node_clf" | "graph_reg"
    dtype: str = "float32"
    unroll_blocks: bool = False  # the reference's cost-analysis switch
    remat: bool = False          # checkpoint each block: the (T, nb)
                                 # triplet intermediates of every block
                                 # otherwise live until backward

    @property
    def param_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


# ---------------------------------------------------------------- params ---
def param_spec(cfg: DimeNetConfig) -> dict:
    """The reference's `init_params` structure as `Leaf` specs, each
    weight drawn at its (per-block) fan-in."""
    dt, H, R, nb = cfg.param_dtype, cfg.d_hidden, cfg.n_radial, cfg.n_blocks
    SB = cfg.n_spherical * cfg.n_radial

    def dense(shape, lead=()):
        return Leaf(lead + shape, dt, 1.0 / math.sqrt(shape[0]))

    blocks = {name: dense(shape, (nb,)) for name, shape in (
        ("w_msg", (H, H)), ("w_kj_down", (H, cfg.n_bilinear)),
        ("w_sbf", (SB, cfg.n_bilinear)), ("w_up", (cfg.n_bilinear, H)),
        ("w_rbf_gate", (R, H)), ("w_self", (H, H)),
        ("w_out_edge", (H, H)))}
    return {"feat_proj": dense((cfg.d_feat, H)), "rbf_emb": dense((R, H)),
            "edge_emb": dense((3 * H, H)), "blocks": blocks,
            "out_proj": dense((H, cfg.n_out))}


def init_params(cfg: DimeNetConfig, generator: torch.Generator) -> dict:
    """Seeded parameters on the generator's device."""
    return P.init_from_spec(param_spec(cfg), generator)


def params_from_numpy(cfg: DimeNetConfig, tree, device=None) -> dict:
    """The reference's params (numpy arrays, the same nesting) as the
    port's, on `device` (None: the card)."""
    return P.from_numpy(param_spec(cfg), tree, device)


n_params = P.n_params


# ----------------------------------------------------------------- basis ---
def _rbf(d: torch.Tensor, n_radial: int, cutoff: float) -> torch.Tensor:
    """Gaussian radial basis with smooth cutoff envelope. (E,) -> (E, R)."""
    centers = torch.linspace(0.0, cutoff, n_radial, device=d.device)
    width = cutoff / n_radial
    env = 0.5 * (torch.cos(math.pi * torch.clamp(d / cutoff, 0, 1)) + 1.0)
    return env[:, None] * torch.exp(-((d[:, None] - centers[None]) / width)
                                    ** 2)


def _sbf(theta: torch.Tensor, d: torch.Tensor, cfg: DimeNetConfig
         ) -> torch.Tensor:
    """cos(m*theta) x RBF(d) product basis. (T,) -> (T, S*R)."""
    m = torch.arange(cfg.n_spherical, dtype=torch.float32,
                     device=theta.device)
    ang = torch.cos(theta[:, None] * (m[None] + 1.0))        # (T, S)
    rad = _rbf(d, cfg.n_radial, cfg.cutoff)                  # (T, R)
    return (ang[:, :, None] * rad[:, None, :]).reshape(
        theta.shape[0], cfg.n_spherical * cfg.n_radial)


def _rows(x: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """x[ids] as `index_select`, whose backward is an `index_add`: the
    padded slots all point at row 0, and advanced indexing's backward
    (a sorted accumulate) serializes such a run of duplicates on the card
    (1.8 s a step at minibatch_lg's 1.2M padded triplets)."""
    return torch.index_select(x, 0, ids)


def _segment_sum(x: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    return torch.zeros((n,) + x.shape[1:], dtype=x.dtype,
                       device=x.device).index_add(0, ids, x)


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.linalg.vector_norm(v + 1e-12, dim=-1)


# --------------------------------------------------------------- forward ---
def forward(params: dict, batch: dict, cfg: DimeNetConfig,
            n_graphs: int = 1) -> torch.Tensor:
    """batch keys: feats (N, d_feat), pos (N, 3), edge_src/edge_dst (E,),
    trip_kj/trip_ji (T,), node_graph (N,) [graph_reg], with -1 padding on
    edge/triplet arrays. Returns (N, n_out) or (n_graphs, n_out), f32."""
    dt = cfg.param_dtype
    feats = batch["feats"].to(dt)
    pos = batch["pos"].float()
    src, dst = batch["edge_src"].long(), batch["edge_dst"].long()
    tkj, tji = batch["trip_kj"].long(), batch["trip_ji"].long()
    N, E = feats.shape[0], src.shape[0]
    e_valid = ((src >= 0) & (dst >= 0))[:, None]
    t_valid = ((tkj >= 0) & (tji >= 0))[:, None]
    srcs, dsts = src.clamp(min=0), dst.clamp(min=0)
    zero = torch.zeros((), dtype=dt, device=feats.device)

    h = feats @ params["feat_proj"]                           # (N, H)
    vec = _rows(pos, dsts) - _rows(pos, srcs)                 # (E, 3)
    dist = _norm(vec)
    rbf = _rbf(dist, cfg.n_radial, cfg.cutoff).to(dt)

    m = torch.cat([_rows(h, srcs), _rows(h, dsts), rbf @ params["rbf_emb"]],
                  dim=-1)
    m = F.silu(m @ params["edge_emb"])                        # (E, H)
    m = torch.where(e_valid, m, zero)

    # triplet geometry: the angle at j between (k->j) and (j->i)
    tkjs, tjis = tkj.clamp(min=0), tji.clamp(min=0)
    v_kj, v_ji = _rows(vec, tkjs), _rows(vec, tjis)
    cosang = torch.sum(v_kj * v_ji, -1) / (_norm(v_kj) * _norm(v_ji) + 1e-12)
    theta = torch.arccos(torch.clamp(cosang, -1 + 1e-6, 1 - 1e-6))
    sbf = _sbf(theta, _rows(dist, tkjs), cfg).to(dt)          # (T, S*R)
    sbf = torch.where(t_valid, sbf, zero)

    def block(m, node_out, bp):
        # directional interaction: m_kj down-projected, gated by the
        # angular basis, summed onto edge ji
        a = _rows(m @ bp["w_kj_down"], tkjs) * (sbf @ bp["w_sbf"])  # (T, nb)
        a = torch.where(t_valid, a, zero)
        agg = _segment_sum(a, tjis, E)                          # (E, nb)
        upd = F.silu(m @ bp["w_msg"]) \
            + (agg @ bp["w_up"]) * (rbf @ bp["w_rbf_gate"])
        m_new = torch.where(e_valid, F.silu(upd @ bp["w_self"]), zero)
        # per-block output: edge messages summed onto destination nodes
        eo = torch.where(e_valid, m_new @ bp["w_out_edge"], zero)
        return m_new, node_out + _segment_sum(eo, dsts, N)

    node_out = torch.zeros((N, cfg.d_hidden), dtype=dt, device=feats.device)
    for i in range(cfg.n_blocks):
        bp = {k: t[i] for k, t in params["blocks"].items()}
        if cfg.remat:
            m, node_out = ckpt.checkpoint(block, m, node_out, bp,
                                          use_reentrant=False)
        else:
            m, node_out = block(m, node_out, bp)

    out = F.silu(node_out) @ params["out_proj"]               # (N, n_out)
    if cfg.task == "graph_reg":
        out = _segment_sum(out, batch["node_graph"].long(), n_graphs)
    return out.float()


def loss_fn(params: dict, batch: dict, cfg: DimeNetConfig,
            n_graphs: int = 1) -> Tuple:
    out = forward(params, batch, cfg, n_graphs=n_graphs)
    if cfg.task == "node_clf":
        labels = batch["labels"].long()                      # (N,), -1 ignore
        mask = labels >= 0
        logp = torch.log_softmax(out, dim=-1)
        nll = -torch.gather(logp, -1, labels.clamp(min=0)[:, None])[:, 0]
        loss = torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1)
    else:
        target = batch["targets"]                            # (G,)
        loss = torch.mean((out[:, 0] - target) ** 2)
    return loss, {"loss": loss}
