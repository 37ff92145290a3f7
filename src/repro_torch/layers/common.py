"""Shared NN building blocks, the counterpart of the JAX package's
`layers/common.py` (DESIGN.md §6).

Pure functions over tensors: the models keep their parameters as nested
dicts of tensors (the reference's pytrees, key for key), and these layers
take them leaf by leaf. What differs from torch's defaults, to match the
reference: `rms_norm` scales by `1 + scale`; `layer_norm` uses the
population variance; `act_fn("gelu")` is the tanh approximation, as
`jax.nn.gelu` is by default; `dense_init` draws from a `torch.Generator`
(jax.random draws have no torch twin, so values never match the
reference's, only shapes and scales do).
"""
from __future__ import annotations

import math
from typing import Optional, Union

import torch
import torch.nn.functional as F


# ---------------------------------------------------------------- norms ----
def rms_norm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6
             ) -> torch.Tensor:
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * (1.0 + scale.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    xf = x.float()
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.var(xf, dim=-1, keepdim=True, correction=0)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale + bias).to(x.dtype)


# ----------------------------------------------------------------- RoPE ----
def rope_freqs(head_dim: int, base: float = 10_000.0,
               device=None) -> torch.Tensor:
    """(head_dim/2,) inverse frequencies."""
    return 1.0 / (base ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               base: float = 10_000.0, rotary_frac: float = 1.0
               ) -> torch.Tensor:
    """Rotary embedding. x: (..., S, H, D); positions: (..., S).

    rotary_frac < 1 rotates only the first rotary_frac*D dims (ChatGLM's
    "2d" RoPE rotates half the head dim and leaves the rest as plain
    channels: rotary_frac=0.5).
    """
    D = x.shape[-1]
    rd = int(D * rotary_frac)
    rd -= rd % 2
    xr, xp = x[..., :rd], x[..., rd:]
    inv = rope_freqs(rd, base, device=x.device)                 # (rd/2,)
    ang = positions[..., None].float() * inv            # (..., S, rd/2)
    cos = torch.cos(ang)[..., None, :]                  # (..., S, 1, rd/2)
    sin = torch.sin(ang)[..., None, :]
    x1 = xr[..., 0::2].float()
    x2 = xr[..., 1::2].float()
    o1 = x1 * cos - x2 * sin
    o2 = x2 * cos + x1 * sin
    out = torch.stack([o1, o2], dim=-1).reshape(xr.shape).to(x.dtype)
    return torch.cat([out, xp], dim=-1) if rd < D else out


# ------------------------------------------------------------ attention ----
def gqa_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  *, causal: bool, window: int = 0,
                  q_offset: Union[torch.Tensor, int] = 0,
                  kv_len: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Grouped-query attention.

    q: (B, S, Hq, D); k, v: (B, T, Hkv, D) with Hq % Hkv == 0.
    causal: causal mask with q positions offset by q_offset (decode).
    window > 0: sliding-window attention (mask-based).
    kv_len: (B,) valid kv prefix length (decode with a preallocated cache).
    """
    B, S, Hq, D = q.shape
    T, Hkv = k.shape[1], k.shape[2]
    G = Hq // Hkv
    qf = q.reshape(B, S, Hkv, G, D).float()
    kf = k.float()
    vf = v.float()
    scores = torch.einsum("bshgd,bthd->bhgst", qf, kf) / math.sqrt(D)

    # per-example query positions: (B, S)
    off = torch.as_tensor(q_offset, device=q.device).reshape(-1, 1)
    off = off.expand(B, 1)
    qpos = off + torch.arange(S, device=q.device)[None, :]
    kpos = torch.arange(T, device=q.device)
    mask = torch.ones((B, S, T), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kpos[None, None, :] <= qpos[:, :, None]
    if window > 0:
        mask &= kpos[None, None, :] > qpos[:, :, None] - window
    if kv_len is not None:
        mask &= kpos[None, None, :] < kv_len[:, None, None]
    mask = mask[:, None, None]                          # (B, 1, 1, S, T)
    scores = torch.where(mask, scores, float("-inf"))
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgst,bthd->bshgd", probs, vf)
    return out.reshape(B, S, Hq, D).to(q.dtype)


# ----------------------------------------------------------------- acts ----
def _gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")


def act_fn(name: str):
    return {"silu": F.silu, "gelu": _gelu_tanh, "relu": F.relu,
            "tanh": torch.tanh}[name]


# ------------------------------------------------------------- embedbag ----
def embedding_bag(table: torch.Tensor, ids: torch.Tensor,
                  offsets_or_mask: torch.Tensor, mode: str = "sum"
                  ) -> torch.Tensor:
    """EmbeddingBag as a gather plus a masked reduce, the reference's
    formulation (torch's `nn.EmbeddingBag` takes offsets, not a mask).

    table: (V, D); ids: (B, A) int with -1 padding;
    offsets_or_mask: (B, A) bool validity mask.
    """
    vecs = table[ids.clamp(min=0).long()]               # (B, A, D)
    m = offsets_or_mask[..., None].to(vecs.dtype)
    s = torch.sum(vecs * m, dim=1)
    if mode == "sum":
        return s
    if mode == "mean":
        cnt = torch.clamp(torch.sum(m, dim=1), min=1.0)
        return s / cnt
    if mode == "max":
        neg = torch.where(offsets_or_mask[..., None], vecs, float("-inf"))
        return torch.amax(neg, dim=1)
    raise ValueError(mode)


# ----------------------------------------------------------------- init ----
def dense_init(generator: torch.Generator, shape,
               scale: Optional[float] = None,
               dtype=torch.float32) -> torch.Tensor:
    """Normal draw times `scale` (default 1/sqrt(fan_in), fan_in the first
    dim of a >= 2-D shape), on the generator's device, drawn in `dtype`
    (a bf16 leaf of many GB needs no f32 transient of its size)."""
    fan_in = shape[0] if len(shape) >= 2 else 1
    scale = scale if scale is not None else 1.0 / math.sqrt(fan_in)
    x = torch.randn(tuple(shape), generator=generator,
                    device=generator.device, dtype=dtype)
    return x.mul_(scale)
