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
equal bit for bit. `MoEConfig`'s `ep_axis`, `tp_axis` and `token_axes` only
pin the reference's sharding, so on one card they change no value: they
are read and ignored. The reference's `moe_ffn_shardmap` (an `all_to_all`
over an EP x TP mesh) has no counterpart on one card; a config with
`use_shardmap=True` is refused by the model (`models/transformer.py`).
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple

import torch

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
    # the reference's EP/TP layout constraints: no value depends on them
    ep_axis: str = ""
    tp_axis: str = ""
    token_axes: tuple = ()
    # the reference's explicit-collective dispatch (mesh-bound, not ported)
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

    # aux load-balance loss (Switch eq. 4)
    frac_tokens = _count(eidx[:, 0], E).float() / T
    frac_probs = torch.mean(probs, dim=0)
    aux = cfg.router_aux_weight * E * torch.sum(frac_tokens * frac_probs)

    dp = dispatch(w, eidx, E, C)
    # the zero rows carry x's dtype, so a bf16 pipeline stays bf16; the
    # gathers are index_selects, whose backward (an index_add) does not
    # serialize the empty slots' and drops' runs of one repeated row
    zero = torch.zeros((), dtype=x.dtype, device=x.device)
    xe = torch.where((dp.buf_tok >= 0)[:, None],
                     torch.index_select(x, 0, dp.buf_tok.clamp(min=0)),
                     zero).reshape(E, C, d)
    ye = _experts(params, xe, cfg).reshape(E * C, d)

    # weighted combine back to tokens
    contrib = torch.where(dp.keep[:, None],
                          torch.index_select(ye, 0,
                                             dp.slot.clamp(max=E * C - 1))
                          * dp.sw[:, None].to(ye.dtype), zero)
    out = torch.zeros((T, d), dtype=ye.dtype, device=x.device).index_add(
        0, dp.st, contrib)

    # shared experts (DeepSeek/Kimi style, always on)
    if "shared_w_in" in params:
        act = L.act_fn(cfg.act)
        hs = x @ params["shared_w_in"]
        gs = x @ params["shared_w_gate"]
        out = out + (act(gs) * hs) @ params["shared_w_out"]
    return out.to(x.dtype), aux
