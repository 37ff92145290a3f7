"""Optimizers over parameter trees, the counterpart of the JAX package's
`train/optimizer.py` (DESIGN.md §6).

AdamW and Adafactor, written out (no `torch.optim`), so the state is a
tree keyed like the reference's: AdamW `{"m": tree, "v": tree, "count"}`,
Adafactor `{"v": tree of {"vr", "vc"} (>= 2-D leaves) or {"v"}, "count"}`.
Checkpoints of either package restore into the other. Adafactor's
factored second moment collapses an (E, d, f) leaf's moments from E*d*f
to E*(d + f) floats. Updates are functional (new tensors, the inputs
untouched) unless AdamW is asked to donate its inputs, as the reference's
Trainer donates its buffers: then it updates them in place. Call them
under `torch.no_grad()` (the trainer does).
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.train.tree import leaves, tree_map


@dataclasses.dataclass(frozen=True)
class OptConfig:
    kind: str = "adamw"          # "adamw" | "adafactor"
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.999            # adafactor: decay exponent handled below
    eps: float = 1e-8
    weight_decay: float = 0.01
    grad_clip: float = 1.0
    # adafactor
    min_dim_factored: int = 2    # factor second moment for >=2-D params


def _count0(params) -> torch.Tensor:
    dev = leaves(params)[0].device
    return torch.zeros((), dtype=torch.int32, device=dev)


# ------------------------------------------------------------------ AdamW --
def adamw_init(params):
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "count": _count0(params)}


def _global_norm(tree) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in leaves(tree)))


def _clip_scale(gn: torch.Tensor, max_norm: float) -> torch.Tensor:
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0)


def _clip(grads, max_norm: float):
    gn = _global_norm(grads)
    scale = _clip_scale(gn, max_norm)
    return tree_map(lambda g: g * scale, grads), gn


# elements a donated update takes at a time: its f32 temporaries stay a
# few hundred MB however large the leaf (llama4's 202,048 x 5,120 embedding
# would need 4 GB a temporary)
_DONATE_CHUNK = 1 << 26


def adamw_update(grads, state, params, cfg: OptConfig, donate: bool = False):
    """donate: write the new params and moments into `params` and
    `state`'s tensors (the reference's buffer donation), a slice of
    `_DONATE_CHUNK` elements at a time, so the step needs no second copy
    of the state. The values are the same either way (every op is
    elementwise)."""
    gnorm = _global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip)
    c = state["count"] + 1
    b1, b2 = cfg.b1, cfg.b2
    bc1 = 1 - b1 ** c.float()
    bc2 = 1 - b2 ** c.float()

    def new(p, g, m, v):
        g = g.float() * scale
        m2 = b1 * m + (1 - b1) * g
        v2 = b2 * v + (1 - b2) * g * g
        step = (m2 / bc1) / (torch.sqrt(v2 / bc2) + cfg.eps)
        step = step + cfg.weight_decay * p.float()
        return (p.float() - cfg.lr * step).to(p.dtype), m2, v2

    def upd(p, g, m, v):
        if not donate:
            return new(p, g, m, v)
        flat = [t.view(-1).split(_DONATE_CHUNK)
                for t in (p, g.reshape(-1), m, v)]
        for pc, gc, mc, vc in zip(*flat):
            for dst, src in zip((pc, mc, vc), new(pc, gc, mc, vc)):
                dst.copy_(src)
        return p, m, v

    triples = tree_map(upd, params, grads, state["m"], state["v"])
    is_triple = lambda x: isinstance(x, tuple)  # noqa: E731
    new_params, m, v = (tree_map(lambda t: t[i], triples, is_leaf=is_triple)
                        for i in range(3))
    return new_params, {"m": m, "v": v, "count": c}, gnorm


# -------------------------------------------------------------- Adafactor --
def _factored(shape, cfg: OptConfig) -> bool:
    return len(shape) >= cfg.min_dim_factored


def adafactor_init(params, cfg: OptConfig = OptConfig(kind="adafactor")):
    def init(p):
        f32 = dict(dtype=torch.float32, device=p.device)
        if _factored(p.shape, cfg):
            return {"vr": torch.zeros(p.shape[:-1], **f32),
                    "vc": torch.zeros(p.shape[:-2] + p.shape[-1:], **f32)}
        return {"v": torch.zeros(p.shape, **f32)}
    return {"v": tree_map(init, params), "count": _count0(params)}


def adafactor_update(grads, state, params, cfg: OptConfig):
    grads = tree_map(lambda g: g.float(), grads)
    grads, gnorm = _clip(grads, cfg.grad_clip)
    c = state["count"] + 1
    # time-dependent decay (Shazeer & Stern): beta2_t = 1 - t^-0.8
    b2t = 1.0 - torch.pow(c.float(), -0.8)

    def upd(p, g, v):
        g2 = g * g + 1e-30
        if _factored(p.shape, cfg):
            vr = b2t * v["vr"] + (1 - b2t) * torch.mean(g2, dim=-1)
            vc = b2t * v["vc"] + (1 - b2t) * torch.mean(g2, dim=-2)
            r = vr / torch.clamp(torch.mean(vr, dim=-1, keepdim=True),
                                 min=1e-30)
            pre = torch.sqrt(r)[..., None] * torch.sqrt(vc)[..., None, :]
            step = g / torch.clamp(pre, min=cfg.eps)
            new_v = {"vr": vr, "vc": vc}
        else:
            vv = b2t * v["v"] + (1 - b2t) * g2
            step = g / (torch.sqrt(vv) + cfg.eps)
            new_v = {"v": vv}
        # update clipping (RMS <= 1) as in the paper
        rms = torch.sqrt(torch.mean(step * step) + 1e-30)
        step = step / torch.clamp(rms, min=1.0)
        step = step + cfg.weight_decay * p.float()
        return (p.float() - cfg.lr * step).to(p.dtype), new_v

    # state["v"] holds, at each param leaf's place, that leaf's {"v"} or
    # {"vr", "vc"} dict, which tree_map passes through whole
    pairs = tree_map(upd, params, grads, state["v"])
    is_pair = lambda x: isinstance(x, tuple)  # noqa: E731
    new_params = tree_map(lambda t: t[0], pairs, is_leaf=is_pair)
    new_v = tree_map(lambda t: t[1], pairs, is_leaf=is_pair)
    return new_params, {"v": new_v, "count": c}, gnorm


# ---------------------------------------------------------------- facade ---
def opt_init(params, cfg: OptConfig):
    if cfg.kind == "adamw":
        return adamw_init(params)
    return adafactor_init(params, cfg)


def opt_update(grads, state, params, cfg: OptConfig, donate: bool = False):
    """(new params, new state, the global grad norm before clipping).
    donate (AdamW): update `params` and `state` in place."""
    if cfg.kind == "adamw":
        return adamw_update(grads, state, params, cfg, donate)
    return adafactor_update(grads, state, params, cfg)
