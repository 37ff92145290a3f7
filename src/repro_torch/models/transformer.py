"""Decoder-only transformer LM (dense and MoE), the counterpart of the JAX
package's `models/transformer.py`, for the five LM archs (qwen2.5-14b,
chatglm3-6b, gemma-2b, kimi-k2-1t-a32b, llama4-scout-17b-a16e).

One parameterized implementation:
  * GQA / MQA attention (n_kv_heads), optional QKV bias (qwen), head_dim
    override (gemma 256), rotary_frac (chatglm 2-d RoPE = 0.5), GeGLU vs
    SwiGLU vs plain MLP, optional sliding window;
  * MoE layers with sort-based dispatch (kimi, llama4-scout;
    `layers/moe.py`);
  * layers stacked on a leading (n_layers,) axis and run in a Python loop
    over the layer index (the reference's `lax.scan`; `unroll_layers`, its
    cost-analysis switch, gives the same loop), with optional activation
    checkpointing: `remat` checkpoints each layer, and the "dots" and
    "dots_nb" policies save the matmul outputs (all, or those without a
    batch dim) so the backward re-runs only the rest; values are equal
    under every policy;
  * train path: full-sequence causal LM loss, naive or shard-blocked over
    `loss_vocab_shards` blocks of the vocabulary (the reference's
    vocab-sharded loss, on one card with no sharding calls);
  * serve path: prefill, and single-token decode against a preallocated
    KV cache that `decode_step` updates in place.

Parameters are a nested dict keyed as the reference's pytree (`embed`,
`layers/*` stacked `(L, ...)`, `ln_f`, `unembed` unless tied), so
checkpoints and optimizer states carry over key for key;
`params_from_numpy` carries the reference's weights across. With
`MoEConfig.use_shardmap` the MoE layers run `moe_ffn_shardmap` on the
ambient device mesh (`launch.mesh.mesh_context`; raises outside one):
each rank then passes its own token rows and its blocks of the expert
weights (`layers.moe.local_moe_params` on `params["layers"]["moe"]`).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import torch
from torch.utils import checkpoint as ckpt

from repro_torch.layers import common as L
from repro_torch.layers import params as P
from repro_torch.layers.moe import (MoEConfig, moe_ffn, moe_ffn_shardmap,
                                    moe_spec)
from repro_torch.layers.params import Leaf
from repro_torch.train.tree import tree_map


@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int = 0            # 0 => d_model // n_heads
    act: str = "silu"            # mlp activation; "geglu" => gelu-gated
    gated_mlp: bool = True
    qkv_bias: bool = False
    rotary_frac: float = 1.0     # chatglm "2d" rope = 0.5
    rope_base: float = 10_000.0
    tie_embeddings: bool = False
    window: int = 0              # sliding-window attention (0 = full)
    norm_eps: float = 1e-6
    moe: Optional[MoEConfig] = None
    moe_every: int = 1           # the reference's field; every layer of an
                                 # MoE config is MoE there and here
    remat: bool = True
    remat_policy: str = "full"   # "full" | "dots" | "dots_nb"
    dtype: str = "bfloat16"      # params/activation dtype
    unroll_layers: bool = False  # the reference's cost-analysis switch; the
                                 # port always runs one Python loop
    loss_vocab_axis: str = ""    # set: the shard-blocked loss over
    loss_batch_axes: tuple = ()  # loss_vocab_shards blocks of the vocab
    loss_vocab_shards: int = 0   # (the axes only name the reference's mesh)

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def param_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


# ---------------------------------------------------------------- params ---
def param_spec(cfg: LMConfig) -> dict:
    """The parameter tree of `cfg` as `Leaf` specs: the reference's
    `init_params` structure, each weight drawn at its per-layer fan-in."""
    dt, d, hd, nl = cfg.param_dtype, cfg.d_model, cfg.hd, cfg.n_layers
    f32 = torch.float32

    def w(shape):
        return Leaf((nl,) + shape, dt, 1.0 / shape[0] ** 0.5)

    layers = {"ln1": Leaf((nl, d), f32, zeros=True),
              "ln2": Leaf((nl, d), f32, zeros=True),
              "wq": w((d, cfg.n_heads * hd)),
              "wk": w((d, cfg.n_kv_heads * hd)),
              "wv": w((d, cfg.n_kv_heads * hd)),
              "wo": w((cfg.n_heads * hd, d))}
    if cfg.qkv_bias:
        for name, width in (("bq", cfg.n_heads), ("bk", cfg.n_kv_heads),
                            ("bv", cfg.n_kv_heads)):
            layers[name] = Leaf((nl, width * hd), dt, zeros=True)
    if cfg.moe is not None:
        layers["moe"] = moe_spec(d, cfg.moe, dt, lead=(nl,))
    else:
        layers["w_in"] = w((d, cfg.d_ff))
        if cfg.gated_mlp:
            layers["w_gate"] = w((d, cfg.d_ff))
        layers["w_out"] = w((cfg.d_ff, d))
    spec = {"embed": Leaf((cfg.vocab, d), dt, 0.02), "layers": layers,
            "ln_f": Leaf((d,), f32, zeros=True)}
    if not cfg.tie_embeddings:
        spec["unembed"] = Leaf((d, cfg.vocab), dt, 1.0 / d ** 0.5)
    return spec


def init_params(cfg: LMConfig, generator: torch.Generator) -> dict:
    """Seeded parameters on the generator's device, each leaf drawn in its
    own dtype (kimi's (384, 7168, 2048) expert leaf needs no f32
    transient)."""
    return P.init_from_spec(param_spec(cfg), generator)


def params_from_numpy(cfg: LMConfig, tree, device=None) -> dict:
    """The reference's params (numpy arrays, the same nesting) as the
    port's, on `device` (None: the card); bf16 leaves from their raw 16
    bits. Shapes and dtypes are held to `cfg`'s."""
    return P.from_numpy(param_spec(cfg), tree, device)


n_params = P.n_params


class LMModel(P.TreeModule):
    """The parameter tree as an `nn.Module` (`layers.params.TreeModule`):
    `named_paths()` are the reference's tree paths (`layers.wq` is
    `layers/wq`), sharing storage with the tree it was made from."""

    def forward(self, tokens: torch.Tensor) -> Tuple:
        return forward(self.params(), tokens, self.cfg)


# --------------------------------------------------------------- forward ---
_DOTS = {"dots": (torch.ops.aten.mm.default, torch.ops.aten.addmm.default,
                  torch.ops.aten.bmm.default, torch.ops.aten.baddbmm.default),
         # projections and the head; the batched (E, C, *) expert GEMMs and
         # attention einsums are recomputed
         "dots_nb": (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)}


def _save_dots(ops, ctx, op, *args, **kwargs):
    return (ckpt.CheckpointPolicy.MUST_SAVE if op in ops
            else ckpt.CheckpointPolicy.PREFER_RECOMPUTE)


def _remat(body, cfg: LMConfig):
    if not cfg.remat:
        return body
    kw = {}
    if cfg.remat_policy in _DOTS:
        policy = functools.partial(_save_dots, _DOTS[cfg.remat_policy])
        kw["context_fn"] = functools.partial(
            ckpt.create_selective_checkpoint_contexts, policy)

    def run(*args):
        return ckpt.checkpoint(body, *args, use_reentrant=False, **kw)
    return run


def _layer(stacked, i: int):
    return tree_map(lambda t: t[i], stacked)


def _scan_layers(body, carry, stacked, cfg: LMConfig):
    """carry = body(carry, layer i's params) over the layers."""
    fn = _remat(body, cfg)
    for i in range(cfg.n_layers):
        carry = fn(carry, _layer(stacked, i))
    return carry


def _mlp(p: dict, x: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    act = L.act_fn("gelu" if cfg.act == "geglu" else cfg.act)
    h = x @ p["w_in"]
    if cfg.gated_mlp:
        h = act(x @ p["w_gate"]) * h
    else:
        h = act(h)
    return h @ p["w_out"]


def _qkv(p: dict, x: torch.Tensor, cfg: LMConfig, positions):
    B, S, _ = x.shape
    hd = cfg.hd
    q = x @ p["wq"]
    k = x @ p["wk"]
    v = x @ p["wv"]
    if cfg.qkv_bias:
        q, k, v = q + p["bq"], k + p["bk"], v + p["bv"]
    q = q.reshape(B, S, cfg.n_heads, hd)
    k = k.reshape(B, S, cfg.n_kv_heads, hd)
    v = v.reshape(B, S, cfg.n_kv_heads, hd)
    q = L.apply_rope(q, positions, cfg.rope_base, cfg.rotary_frac)
    k = L.apply_rope(k, positions, cfg.rope_base, cfg.rotary_frac)
    return q, k, v


def _attn(p: dict, x: torch.Tensor, cfg: LMConfig, positions,
          cache_kv: Optional[Tuple] = None, kv_len=None):
    """x: (B, S, d). cache_kv: (k_cache, v_cache) (B, T, Hkv, D) for decode,
    written in place at kv_len."""
    B, S, _ = x.shape
    q, k, v = _qkv(p, x, cfg, positions)
    new_cache = None
    if cache_kv is not None:
        kc, vc = cache_kv
        idx = kv_len[:, None].long() + torch.arange(S, device=x.device)[None]
        bidx = torch.arange(B, device=x.device)[:, None]
        kc[bidx, idx] = k.to(kc.dtype)
        vc[bidx, idx] = v.to(vc.dtype)
        new_cache = (kc, vc)
        out = L.gqa_attention(q, kc, vc, causal=True, window=cfg.window,
                              q_offset=kv_len, kv_len=kv_len + S)
    else:
        out = L.gqa_attention(q, k, v, causal=True, window=cfg.window)
    return out.reshape(B, S, cfg.n_heads * cfg.hd) @ p["wo"], new_cache


def _ffn(p: dict, hin: torch.Tensor, cfg: LMConfig):
    """(the MLP or MoE output, its aux loss)."""
    if cfg.moe is None:
        return _mlp(p, hin, cfg), torch.zeros((), device=hin.device)
    B, S, d = hin.shape
    fn = moe_ffn_shardmap if cfg.moe.use_shardmap else moe_ffn
    out, aux = fn(p["moe"], hin.reshape(B * S, d), cfg.moe)
    return out.reshape(B, S, d), aux


def _block(p: dict, x: torch.Tensor, cfg: LMConfig, positions, cache_kv=None,
           kv_len=None):
    h, new_cache = _attn(p, L.rms_norm(x, p["ln1"], cfg.norm_eps), cfg,
                         positions, cache_kv, kv_len)
    x = x + h
    out, aux = _ffn(p, L.rms_norm(x, p["ln2"], cfg.norm_eps), cfg)
    return x + out, aux, new_cache


def _embed(params: dict, tokens: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    x = params["embed"][tokens.long()].to(cfg.param_dtype)
    if cfg.tie_embeddings:                      # gemma: sqrt(d) in f32
        scale = torch.sqrt(torch.tensor(float(cfg.d_model),
                                        dtype=torch.float32))
        x = x * scale.to(device=x.device, dtype=x.dtype)
    return x


def _positions(B: int, S: int, device) -> torch.Tensor:
    return torch.arange(S, device=device)[None].expand(B, S)


def forward_features(params: dict, tokens: torch.Tensor, cfg: LMConfig
                     ) -> Tuple:
    """Backbone only: tokens (B, S) -> (final hidden (B, S, d), aux)."""
    B, S = tokens.shape
    x = _embed(params, tokens, cfg)
    positions = _positions(B, S, x.device)

    def body(carry, layer_p):
        x, aux = carry
        x, a, _ = _block(layer_p, x, cfg, positions)
        return x, aux + a

    aux0 = torch.zeros((), dtype=torch.float32, device=x.device)
    x, aux = _scan_layers(body, (x, aux0), params["layers"], cfg)
    return L.rms_norm(x, params["ln_f"], cfg.norm_eps), aux


def _head(params: dict, x: torch.Tensor, cfg: LMConfig) -> torch.Tensor:
    if cfg.tie_embeddings:
        return x @ params["embed"].T.to(x.dtype)
    return x @ params["unembed"]


def forward(params: dict, tokens: torch.Tensor, cfg: LMConfig) -> Tuple:
    """Training forward. tokens: (B, S) -> (logits (B, S, V) f32, aux)."""
    x, aux = forward_features(params, tokens, cfg)
    return _head(params, x, cfg).float(), aux


def loss_fn(params: dict, batch: dict, cfg: LMConfig) -> Tuple:
    """Causal LM loss. batch: {"tokens": (B, S+1) int}.

    With cfg.loss_vocab_axis set, the head's logits stay in the param
    dtype and the softmax statistics reduce over `loss_vocab_shards`
    blocks of the vocabulary (a log-sum-exp per block, then across
    blocks), the target logit by a select-and-reduce instead of a gather:
    the reference's vocab-sharded loss, on one card.
    """
    tokens = batch["tokens"].long()
    inp, tgt = tokens[:, :-1], tokens[:, 1:]
    if not cfg.loss_vocab_axis:
        logits, aux = forward(params, inp, cfg)
        logp = torch.log_softmax(logits, dim=-1)
        nll = -torch.gather(logp, -1, tgt[..., None])[..., 0]
        loss = torch.mean(nll) + aux
        return loss, {"nll": torch.mean(nll), "aux": aux}

    x, aux = forward_features(params, inp, cfg)
    logits = _head(params, x, cfg)                    # param dtype
    B, S, V = logits.shape
    n = max(cfg.loss_vocab_shards, 1)
    lf = logits.reshape(B, S, n, V // n).float()
    m_l = torch.amax(lf, dim=-1)                      # (B, S, n)
    s_l = torch.sum(torch.exp(lf - m_l[..., None]), dim=-1)
    m = torch.amax(m_l, dim=-1)                       # (B, S)
    lse = m + torch.log(torch.sum(s_l * torch.exp(m_l - m[..., None]),
                                  dim=-1))
    # target logit: a select inside the owning block
    iota = (torch.arange(V // n, device=lf.device)[None, :]
            + torch.arange(n, device=lf.device)[:, None] * (V // n))
    tgt_logit = torch.sum(torch.where(iota == tgt[..., None, None], lf, 0.0),
                          dim=(-1, -2))
    nll = lse - tgt_logit
    loss = torch.mean(nll) + aux
    return loss, {"nll": torch.mean(nll), "aux": aux}


@torch.no_grad()
def prefill(params: dict, tokens: torch.Tensor, cfg: LMConfig
            ) -> Tuple[torch.Tensor, dict]:
    """Inference prefill: a full-sequence forward that also materializes
    the KV cache. Returns (last-token logits (B, 1, V) f32, cache sized
    exactly to S: k, v (L, B, S, Hkv, D) in the param dtype, len (B,))."""
    B, S = tokens.shape
    x = _embed(params, tokens, cfg)
    positions = _positions(B, S, x.device)
    ks, vs = [], []
    for i in range(cfg.n_layers):
        p = _layer(params["layers"], i)
        q, k, v = _qkv(p, L.rms_norm(x, p["ln1"], cfg.norm_eps), cfg,
                       positions)
        a = L.gqa_attention(q, k, v, causal=True, window=cfg.window)
        x = x + a.reshape(B, S, cfg.n_heads * cfg.hd) @ p["wo"]
        hin = L.rms_norm(x, p["ln2"], cfg.norm_eps)
        if cfg.moe is not None:                 # as the reference: moe_ffn
            out, _ = moe_ffn(p["moe"], hin.reshape(B * S, -1), cfg.moe)
            out = out.reshape(B, S, -1)
        else:
            out = _mlp(p, hin, cfg)
        x = x + out
        ks.append(k.to(cfg.param_dtype))
        vs.append(v.to(cfg.param_dtype))
    x = L.rms_norm(x[:, -1:], params["ln_f"], cfg.norm_eps)
    logits = _head(params, x, cfg)
    cache = {"k": torch.stack(ks), "v": torch.stack(vs),
             "len": torch.full((B,), S, dtype=torch.int32, device=x.device)}
    return logits.float(), cache


# ----------------------------------------------------------------- decode --
def init_cache(cfg: LMConfig, batch: int, max_len: int, dtype=None,
               device=None) -> dict:
    """An empty KV cache: k, v (L, batch, max_len, Hkv, D) zeros in `dtype`
    (None: the param dtype), len (batch,) int32, on `device` (None: the
    card)."""
    dt = dtype or cfg.param_dtype
    dev = torch.device("cuda" if device is None else device)
    shape = (cfg.n_layers, batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {"k": torch.zeros(shape, dtype=dt, device=dev),
            "v": torch.zeros(shape, dtype=dt, device=dev),
            "len": torch.zeros((batch,), dtype=torch.int32, device=dev)}


@torch.no_grad()
def decode_step(params: dict, cache: dict, tokens: torch.Tensor,
                cfg: LMConfig) -> Tuple[torch.Tensor, dict]:
    """One decode step. tokens: (B, S) (S = 1) -> (logits (B, S, V) f32,
    cache'). The new K/V are written into the caller's cache IN PLACE
    (a functional copy of a many-GB cache every token would cost more than
    the step): cache' holds the same k and v tensors and len + S."""
    B, S = tokens.shape
    x = _embed(params, tokens, cfg)
    kv_len = cache["len"]
    positions = kv_len[:, None].long() + torch.arange(S, device=x.device)[None]
    for i in range(cfg.n_layers):
        x, _, _ = _block(_layer(params["layers"], i), x, cfg, positions,
                         cache_kv=(cache["k"][i], cache["v"][i]),
                         kv_len=kv_len)
    x = L.rms_norm(x, params["ln_f"], cfg.norm_eps)
    logits = _head(params, x, cfg)
    new_cache = {"k": cache["k"], "v": cache["v"], "len": kv_len + S}
    return logits.float(), new_cache
