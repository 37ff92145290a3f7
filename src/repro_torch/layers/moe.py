"""Mixture-of-Experts FFN with sort-based dispatch, the counterpart of the
JAX package's `layers/moe.py` (DESIGN.md §7).

  router top-k -> flatten (T*k) assignments -> stable-sort by expert ->
  per-expert positions via exclusive-scan of counts -> capacity-drop ->
  scatter token ids into an (E, C) slot buffer -> gather tokens (E, C, d)
  -> batched expert GEMMs -> weighted scatter-add back to (T, d).

Capacity C = max(1, int(T*k/E * capacity_factor)), a floor (the
reference computes it so, though its docstring says "ceil"); overflow
assignments are dropped. The aux load-balancing loss is Switch-style.

Every step matches the reference's: the top-k breaks ties to the lower
expert index, as `lax.top_k` does (a stable descending sort, no host sync;
`torch.topk`'s tie order is not fixed), and the kept set and slots are
equal bit for bit. In `moe_ffn`, `MoEConfig`'s `ep_axis`, `tp_axis` and
`token_axes` only pin the reference's sharding and change no value.

`moe_ffn_shardmap` is the reference's explicit-collective dispatch over an
EP x TP device mesh (`launch/mesh.py`), with the collectives placed by
hand; the model calls it when `use_shardmap` is set. Each rank passes its
own blocks: its tokens and its slices of the expert weights
(`local_moe_params`).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

from repro_torch.launch import mesh as M
from repro_torch.layers import common as L
from repro_torch.layers import params as P
from repro_torch.layers.params import Leaf


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    gated: bool = True           # SwiGLU experts
    act: str = "silu"
    router_aux_weight: float = 0.01
    # the mesh axes experts and expert widths are sharded over, and the
    # axes the tokens are (moe_ffn_shardmap reads ep_axis and tp_axis; in
    # moe_ffn they pin the reference's layout and no value depends on them)
    ep_axis: str = ""
    tp_axis: str = ""
    token_axes: tuple = ()
    # explicit-collective dispatch over the ambient mesh (moe_ffn_shardmap)
    # and the sizes of its EP and TP axes
    use_shardmap: bool = False
    ep_size: int = 0
    tp_size: int = 0


def moe_spec(d_model: int, cfg: MoEConfig, dtype=torch.float32,
             lead: Tuple[int, ...] = ()) -> dict:
    """The MoE parameters as `Leaf` specs, with `lead` stacked in front
    (the transformer's (n_layers,)); the router is f32."""
    E, f = cfg.n_experts, cfg.d_ff_expert
    s_in = 1.0 / (d_model ** 0.5)
    s_out = 1.0 / (f ** 0.5)
    p = {"router": Leaf(lead + (d_model, E), torch.float32, s_in),
         "w_in": Leaf(lead + (E, d_model, f), dtype, s_in),
         "w_out": Leaf(lead + (E, f, d_model), dtype, s_out)}
    if cfg.gated:
        p["w_gate"] = Leaf(lead + (E, d_model, f), dtype, s_in)
    if cfg.n_shared_experts:
        fs = f * cfg.n_shared_experts
        p["shared_w_in"] = Leaf(lead + (d_model, fs), dtype, s_in)
        p["shared_w_gate"] = Leaf(lead + (d_model, fs), dtype, s_in)
        p["shared_w_out"] = Leaf(lead + (fs, d_model), dtype, s_out)
    return p


def init_moe(generator: torch.Generator, d_model: int, cfg: MoEConfig,
             dtype=torch.float32) -> dict:
    """Seeded MoE parameters on the generator's device."""
    return P.init_from_spec(moe_spec(d_model, cfg, dtype), generator)


def capacity(n_tokens: int, cfg: MoEConfig) -> int:
    return max(1, int(n_tokens * cfg.top_k / cfg.n_experts
                      * cfg.capacity_factor))


def route(params: dict, x: torch.Tensor, cfg: MoEConfig):
    """(probs (T, E) f32, renormalised top-k weights (T, K), expert ids
    (T, K) int64): the f32 router, a softmax, and the top-k in
    `lax.top_k`'s order (descending, ties to the lower expert)."""
    logits = x.float() @ params["router"]
    probs = torch.softmax(logits, dim=-1)
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    w, eidx = vals[:, :cfg.top_k], idx[:, :cfg.top_k]
    w = w / torch.clamp(torch.sum(w, dim=-1, keepdim=True), min=1e-9)
    return probs, w, eidx


def _count(ids: torch.Tensor, n: int) -> torch.Tensor:
    """Occurrences of 0..n-1 in ids, with no host sync (`bincount` reads
    the max on the card)."""
    return torch.zeros(n, dtype=torch.long, device=ids.device).index_add_(
        0, ids, torch.ones_like(ids))


class Dispatch(NamedTuple):
    """The sort-based dispatch of T*K assignments into E*C slots, in
    expert-sorted order: token id, weight, kept (within capacity), slot
    (E*C for a drop) of each; and the slot buffer's token ids (-1 empty)."""
    st: torch.Tensor
    sw: torch.Tensor
    keep: torch.Tensor
    slot: torch.Tensor
    buf_tok: torch.Tensor


def dispatch(w: torch.Tensor, eidx: torch.Tensor, n_experts: int,
             cap: int) -> Dispatch:
    T, K = eidx.shape
    E, C = n_experts, cap
    dev = eidx.device
    flat_e = eidx.reshape(-1)
    flat_t = torch.arange(T, device=dev).repeat_interleave(K)
    order = torch.argsort(flat_e, stable=True)
    se, st, sw = flat_e[order], flat_t[order], w.reshape(-1)[order]
    counts = _count(se, E)
    starts = torch.cumsum(counts, 0) - counts            # exclusive scan
    pos = torch.arange(T * K, device=dev) - starts[se]
    keep = pos < C
    slot = torch.where(keep, se * C + pos, E * C)        # drop -> sentinel
    buf = torch.full((E * C + 1,), -1, dtype=torch.long, device=dev)
    buf[slot] = torch.where(keep, st, -1)
    return Dispatch(st, sw, keep, slot, buf[:E * C])


def _slots(x: torch.Tensor, dp: Dispatch, E: int, C: int) -> torch.Tensor:
    """The (E, C, d) slot buffer of x's rows (empty slots zero in x's
    dtype, so a bf16 pipeline stays bf16). The gathers are index_selects,
    whose backward (an index_add) does not serialize the empty slots' and
    drops' runs of one repeated row."""
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    return torch.where((dp.buf_tok >= 0)[:, None],
                       torch.index_select(x, 0, dp.buf_tok.clamp(min=0)),
                       zero).reshape(E, C, x.shape[1])


def _combine(y: torch.Tensor, dp: Dispatch, n_tokens: int) -> torch.Tensor:
    """The weighted scatter-add of the (E*C, d) expert outputs back to
    (n_tokens, d)."""
    EC, d = y.shape
    zero = torch.zeros((), dtype=y.dtype, device=y.device)
    contrib = torch.where(dp.keep[:, None],
                          torch.index_select(y, 0, dp.slot.clamp(max=EC - 1))
                          * dp.sw[:, None].to(y.dtype), zero)
    return torch.zeros((n_tokens, d), dtype=y.dtype,
                       device=y.device).index_add(0, dp.st, contrib)


def _shared(params: dict, x: torch.Tensor, out: torch.Tensor,
            cfg: MoEConfig) -> torch.Tensor:
    """out plus the shared experts (DeepSeek/Kimi style, always on)."""
    if "shared_w_in" not in params:
        return out
    act = L.act_fn(cfg.act)
    hs = x @ params["shared_w_in"]
    gs = x @ params["shared_w_gate"]
    return out + (act(gs) * hs) @ params["shared_w_out"]


def _aux(probs: torch.Tensor, eidx: torch.Tensor,
         cfg: MoEConfig) -> torch.Tensor:
    """The Switch load-balance loss (eq. 4) over these tokens' routing."""
    E = cfg.n_experts
    frac_tokens = _count(eidx[:, 0], E).float() / eidx.shape[0]
    frac_probs = torch.mean(probs, dim=0)
    return cfg.router_aux_weight * E * torch.sum(frac_tokens * frac_probs)


def _experts(params: dict, xe: torch.Tensor, cfg: MoEConfig) -> torch.Tensor:
    """Batched expert GEMMs over the (E, C, d) buffer, in its dtype."""
    act = L.act_fn(cfg.act)
    h = torch.bmm(xe, params["w_in"])
    if cfg.gated:
        h = act(torch.bmm(xe, params["w_gate"])) * h
    else:
        h = act(h)
    return torch.bmm(h, params["w_out"])


def moe_ffn(params: dict, x: torch.Tensor, cfg: MoEConfig
            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (T, d) flattened tokens -> (out (T, d) in x's dtype, aux loss
    (f32 scalar))."""
    T, d = x.shape
    E = cfg.n_experts
    C = capacity(T, cfg)
    probs, w, eidx = route(params, x, cfg)
    dp = dispatch(w, eidx, E, C)
    ye = _experts(params, _slots(x, dp, E, C), cfg).reshape(E * C, d)
    out = _combine(ye, dp, T)
    return _shared(params, x, out, cfg).to(x.dtype), _aux(probs, eidx, cfg)


# --------------------------------------------------------------------------
# explicit-collective MoE over an EP x TP mesh
# --------------------------------------------------------------------------
def local_moe_params(params: dict, cfg: MoEConfig) -> dict:
    """This rank's blocks of (stacked) MoE params on the ambient mesh, the
    reference's `P(ep, tp, None)` layout: w_in and w_gate (..., E, d, f)
    keep experts [i*E/ep, (i+1)*E/ep) and d slice j of tp, w_out (..., E,
    f, d) the same experts and f slice j; the router and shared experts
    whole."""
    mesh = M.current_mesh()
    ep, tp = M.mesh_axis(mesh, cfg.ep_axis), M.mesh_axis(mesh, cfg.tp_axis)

    def block(t):
        E, w = t.shape[-3], t.shape[-2]
        return t.narrow(-3, ep.index * (E // ep.size), E // ep.size).narrow(
            -2, tp.index * (w // tp.size), w // tp.size)

    return {k: block(v) if k in ("w_in", "w_gate", "w_out") else v
            for k, v in params.items()}


def moe_ffn_shardmap(params: dict, x: torch.Tensor, cfg: MoEConfig
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """moe_ffn with hand-placed collectives on the ambient mesh (ep x tp,
    `cfg.ep_axis` x `cfg.tp_axis`; `launch.mesh.mesh_context`).

    Each rank passes its blocks of the reference's `in_specs`: x (T_l, d)
    its tokens (sharded over the token axes, the same on every TP rank),
    the router whole, w_in / w_gate (E_l, d/tp, f) and w_out (E_l, f/tp,
    d) from `local_moe_params`. Returns (out (T_l, d), aux), out the same
    on every TP rank. Per rank (r, c), in the reference's order:

      1. route the T_l tokens (the router is whole: the same on every c);
      2. column c dispatches its T_s = T_l/tp token slice into an
         (E, C_l, d) buffer, C_l = max(1, int(T_s*K/E * factor));
      3. all_to_all over ep -> (E_l, ep*C_l, d);
      4. all_to_all over tp trades d for tokens -> (E_l, tp*C_row, d/tp),
         the w_in / w_gate GEMMs, psum_scatter over tp -> (E_l, C_row, f);
      5. the same trade of f for the down-projection;
      6. all_to_all back over ep -> (E, C_l, d);
      7. the weighted combine to (T_s, d), all_gather over tp -> (T_l, d);

    then the shared experts on all T_l tokens. The aux loss is the mean
    over ep, then tp, of each rank's Switch loss over its T_l tokens.
    With no drop (capacity large enough) out equals moe_ffn's rows.

    Gradients (`launch.mesh`'s collectives): each rank back-propagates
    its own loss; w_in / w_gate / w_out get their block of the gradient of
    all ranks' losses, and the router, the shared experts and x get on
    every TP rank the gradient of their token row's losses."""
    mesh = M.current_mesh()
    De, Dt = cfg.ep_size, cfg.tp_size
    if De <= 0 or Dt <= 0:
        raise ValueError("set MoEConfig.ep_size/tp_size for shardmap")
    ep, tp = M.mesh_axis(mesh, cfg.ep_axis), M.mesh_axis(mesh, cfg.tp_axis)
    if (ep.size, tp.size) != (De, Dt):
        raise ValueError(f"the mesh's {cfg.ep_axis} x {cfg.tp_axis} is "
                         f"{ep.size} x {tp.size}, the config says {De} x {Dt}")
    E = cfg.n_experts
    T_l, d = x.shape
    if T_l % Dt or E % De:
        raise ValueError(f"{T_l} tokens over {Dt} TP ranks, {E} experts "
                         f"over {De} EP ranks: neither may leave a remainder")
    T_s = T_l // Dt
    C_l = capacity(T_s, cfg)
    act = L.act_fn(cfg.act)

    # 1. routing: local and exact, the router is whole
    probs, w, eidx = route(params, x, cfg)
    aux = M.pmean(M.pmean(_aux(probs, eidx, cfg), ep), tp)

    # 2. column c dispatches its token slice
    x_s, w_s = M.split(x, tp), M.split(w, tp)
    dp = dispatch(w_s, eidx.narrow(0, tp.index * T_s, T_s), E, C_l)

    # 3. dispatch all_to_all over EP
    xr = M.all_to_all(_slots(x_s, dp, E, C_l), ep, 0, 1)   # (E_l, De*C_l, d)

    # 4. expert GEMMs: columns hold disjoint token slices, so trade d for
    # tokens over TP, contract the local d slice, and reduce-scatter each
    # column's own token block of the full-f result
    xr = M.all_to_all(xr, tp, 2, 1)                    # (E_l, Dt*C_row, d_l)
    h = M.psum_scatter(torch.bmm(xr, params["w_in"]), tp, 1)
    if cfg.gated:
        h = act(M.psum_scatter(torch.bmm(xr, params["w_gate"]), tp, 1)) * h
    else:
        h = act(h)

    # 5. the down-projection: the same trade, f for tokens
    hh = M.all_to_all(h, tp, 2, 1)                     # (E_l, Dt*C_row, f_l)
    ye = M.psum_scatter(torch.bmm(hh, params["w_out"]), tp, 1)

    # 6. return all_to_all over EP
    yr = M.all_to_all(ye, ep, 1, 0).reshape(E * C_l, d)

    # 7. weighted combine, then the token slices gathered over TP
    out = M.all_gather(_combine(yr, dp, T_s), tp)
    return _shared(params, x, out, cfg).to(x.dtype), aux
