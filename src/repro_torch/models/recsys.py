"""RecSys architectures: deepfm, fm, bst, bert4rec (the counterpart of the
JAX package's `models/recsys.py`, DESIGN.md §5).

Parameters are a nested dict of tensors keyed as the reference's pytree
(`tables`, `linear`, `bias`, `mlp/<i>/{w,b}`, `item_emb`, `pos_emb`,
`blocks/<name>` stacked `(n_blocks, ...)`, `ln_f`), so checkpoints and
optimizer states carry over key for key; `RecsysModel` holds the same
tensors as an `nn.Module` whose parameter names are those paths with "."
for "/". `params_from_numpy` turns the reference's params (as numpy
arrays) into the port's: jax.random draws have no torch twin, so value
parity goes through it.

  * embedding tables: a stacked (F, V, D) per-field table, looked up by
    advanced indexing (autograd scatters the gradient into a dense table);
  * feature interaction: FM's sum-square trick (O(F*D), Rendle ICDM'10),
    self-attention over behaviour sequences (BST), a bidirectional
    encoder (BERT4Rec);
  * retrieval_cand serving: one query vector against 10^6 candidate item
    embeddings, the paper's workload, on the `batch_dist` kernel (exact)
    or a KBest index over `candidate_table()` (ANN).

Shapes (assigned): train_batch 65536 / serve_p99 512 / serve_bulk 262144 /
retrieval_cand 1 x 1e6.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from repro_torch.core.build import stable_topk_smallest
from repro_torch.launch.mesh import gather_stack, mesh_axis
from repro_torch.layers import common as L
from repro_torch.layers import params as P
from repro_torch.layers.params import Leaf


@dataclasses.dataclass(frozen=True)
class RecsysConfig:
    name: str
    kind: str                    # "deepfm" | "fm" | "bst" | "bert4rec"
    n_sparse: int = 39           # categorical fields (deepfm / fm)
    vocab_per_field: int = 100_000
    embed_dim: int = 10
    mlp_dims: Tuple[int, ...] = (400, 400, 400)
    # sequence models
    n_items: int = 1_000_000     # item vocabulary (bst / bert4rec / retrieval)
    seq_len: int = 200
    n_blocks: int = 2
    n_heads: int = 2
    d_model: int = 64            # bert4rec embed_dim / bst transformer dim
    dtype: str = "float32"
    unroll_blocks: bool = False  # the reference's cost-analysis switch
                                 # (scan or unrolled); the port always runs
                                 # the same Python loop over the blocks
    masked_positions: int = 0    # bert4rec: logits ONLY at <= P masked
                                 # positions per row instead of all S x V

    @property
    def param_dtype(self) -> torch.dtype:
        return torch.bfloat16 if self.dtype == "bfloat16" else torch.float32


# ---------------------------------------------------------------- params ---
def param_spec(cfg: RecsysConfig) -> dict:
    """The parameter tree of `cfg`, as `Leaf` specs (the reference's
    `init_params` structure)."""
    dt = cfg.param_dtype

    def mlp(d_in):
        dims = (d_in,) + tuple(cfg.mlp_dims) + (1,)
        return [{"w": Leaf((dims[i], dims[i + 1]), dt),
                 "b": Leaf((dims[i + 1],), dt, zeros=True)}
                for i in range(len(dims) - 1)]

    if cfg.kind in ("deepfm", "fm"):
        F, V, D = cfg.n_sparse, cfg.vocab_per_field, cfg.embed_dim
        p = {"tables": Leaf((F, V, D), dt, 0.01),
             "linear": Leaf((F, V), dt, 0.01),     # per-field scalar weights
             "bias": Leaf((), torch.float32, zeros=True)}
        if cfg.kind == "deepfm":
            p["mlp"] = mlp(F * D)
        return p
    Dm = cfg.d_model
    if cfg.kind == "bst":
        return {"item_emb": Leaf((cfg.n_items, Dm), dt, 0.02),
                "pos_emb": Leaf((cfg.seq_len + 1, Dm), dt, 0.02),
                "blocks": _block_spec(cfg, Dm),
                "mlp": mlp((cfg.seq_len + 1) * Dm)}
    if cfg.kind == "bert4rec":
        return {"item_emb": Leaf((cfg.n_items, Dm), dt, 0.02),
                "pos_emb": Leaf((cfg.seq_len, Dm), dt, 0.02),
                "blocks": _block_spec(cfg, Dm),
                "ln_f": Leaf((Dm,), torch.float32, zeros=True)}
    raise ValueError(cfg.kind)


def _block_spec(cfg: RecsysConfig, Dm: int) -> dict:
    """Encoder blocks stacked on a leading (n_blocks,) axis. Each weight is
    drawn at its own fan-in, as the reference draws each block's."""
    nb, dt = cfg.n_blocks, cfg.param_dtype
    spec = {"ln1": Leaf((nb, Dm), torch.float32, zeros=True),
            "ln2": Leaf((nb, Dm), torch.float32, zeros=True)}
    for name, shape in (("wq", (Dm, Dm)), ("wk", (Dm, Dm)), ("wv", (Dm, Dm)),
                        ("wo", (Dm, Dm)), ("w_in", (Dm, 4 * Dm)),
                        ("w_out", (4 * Dm, Dm))):
        spec[name] = Leaf((nb,) + shape, dt, 1.0 / shape[0] ** 0.5)
    return spec


def init_params(cfg: RecsysConfig, generator: torch.Generator) -> dict:
    """Seeded parameters on the generator's device."""
    return P.init_from_spec(param_spec(cfg), generator)


def params_from_numpy(cfg: RecsysConfig, tree, device=None) -> dict:
    """The reference's params (numpy arrays, the same nesting) as the
    port's, on `device` (None: the card). Shapes and dtypes are held to
    `cfg`'s."""
    return P.from_numpy(param_spec(cfg), tree, device)


class RecsysModel(P.TreeModule):
    """The parameter tree as an `nn.Module` (`layers.params.TreeModule`):
    `named_paths()` are the reference's tree paths (`mlp.0.w` is
    `mlp/0/w`), sharing storage with the tree it was made from."""

    def forward(self, batch: dict) -> torch.Tensor:
        return forward(self.params(), batch, self.cfg)


n_params = P.n_params


# -------------------------------------------------------------- encoders ---
def _mlp_head(mlp, x):
    h = x
    for i, lyr in enumerate(mlp):
        h = h @ lyr["w"] + lyr["b"]
        if i < len(mlp) - 1:
            h = torch.relu(h)
    return h


def _encoder(blocks, x, cfg: RecsysConfig, causal: bool):
    """Tiny pre-LN transformer encoder, a loop over the leading axis of the
    stacked blocks (the reference's `lax.scan`; `unroll_blocks` gives the
    same loop). x: (B, S, Dm)."""
    B, S, Dm = x.shape
    H = cfg.n_heads
    hd = Dm // H
    gelu = L.act_fn("gelu")
    for i in range(cfg.n_blocks):
        bp = {k: t[i] for k, t in blocks.items()}
        hin = L.rms_norm(x, bp["ln1"])
        q = (hin @ bp["wq"]).reshape(B, S, H, hd)
        k = (hin @ bp["wk"]).reshape(B, S, H, hd)
        v = (hin @ bp["wv"]).reshape(B, S, H, hd)
        a = L.gqa_attention(q, k, v, causal=causal)
        x = x + a.reshape(B, S, Dm) @ bp["wo"]
        hin = L.rms_norm(x, bp["ln2"])
        x = x + gelu(hin @ bp["w_in"]) @ bp["w_out"]
    return x


def _fm_terms(params, ids, cfg: RecsysConfig):
    """Shared FM machinery. ids: (B, F) -> (linear+fm logit, field embs)."""
    fidx = torch.arange(cfg.n_sparse, device=ids.device)[None, :]
    ids = ids.long()
    emb = params["tables"][fidx, ids]             # (B, F, D)
    lin = params["linear"][fidx, ids]             # (B, F)
    s = torch.sum(emb, dim=1)                     # sum-square trick, O(F*D)
    fm = 0.5 * torch.sum(s * s - torch.sum(emb * emb, dim=1), dim=-1)
    logit = params["bias"] + torch.sum(lin, dim=1) + fm
    return logit.float(), emb


def _embed_seq(params, seq, cfg: RecsysConfig):
    x = params["item_emb"][seq.long()] + params["pos_emb"][None]
    return _encoder(params["blocks"], x.to(cfg.param_dtype), cfg,
                    causal=False)


# ---------------------------------------------------------------- scoring --
def forward(params: dict, batch: dict, cfg: RecsysConfig) -> torch.Tensor:
    """Per-example logits.

    deepfm/fm: batch {"sparse_ids": (B, F)}; bst: {"hist": (B, S),
    "target": (B,)}; bert4rec: {"seq": (B, S)} -> (B, S, n_items) logits.
    """
    if cfg.kind == "fm":
        logit, _ = _fm_terms(params, batch["sparse_ids"], cfg)
        return logit
    if cfg.kind == "deepfm":
        logit, emb = _fm_terms(params, batch["sparse_ids"], cfg)
        B = emb.shape[0]
        deep = _mlp_head(params["mlp"], emb.reshape(B, -1))[:, 0]
        return logit + deep.float()
    if cfg.kind == "bst":
        hist, target = batch["hist"], batch["target"]       # (B,S), (B,)
        B = hist.shape[0]
        seq = torch.cat([hist, target[:, None]], dim=1)
        x = _embed_seq(params, seq, cfg)
        out = _mlp_head(params["mlp"], x.reshape(B, -1))[:, 0]
        return out.float()
    if cfg.kind == "bert4rec":
        x = _embed_seq(params, batch["seq"], cfg)
        x = L.rms_norm(x, params["ln_f"])
        logits = x @ params["item_emb"].T.to(x.dtype)        # tied softmax
        return logits.float()
    raise ValueError(cfg.kind)


def _masked_nll(logits, labels):
    """Mean negative log-likelihood over labels >= 0 (-1 is ignored)."""
    mask = labels >= 0
    logp = torch.log_softmax(logits, dim=-1)
    idx = labels.clamp(min=0).long()[..., None]
    nll = -torch.gather(logp, -1, idx)[..., 0]
    return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1)


def loss_fn(params: dict, batch: dict, cfg: RecsysConfig) -> Tuple:
    if cfg.kind == "bert4rec" and cfg.masked_positions > 0:
        return _bert4rec_masked_loss(params, batch, cfg)
    out = forward(params, batch, cfg)
    if cfg.kind == "bert4rec":
        loss = _masked_nll(out, batch["labels"])     # (B, S), -1 ignore
    else:
        y = batch["label"].float()
        loss = torch.mean(torch.maximum(out, torch.zeros_like(out)) - out * y
                          + torch.log1p(torch.exp(-torch.abs(out))))
    return loss, {"loss": loss}


def _bert4rec_masked_loss(params: dict, batch: dict, cfg: RecsysConfig
                          ) -> Tuple:
    """Masked-LM loss evaluated ONLY at masked positions.

    The full loss materializes (B, S, V) logits; only ~15% of positions
    carry labels, so gathering the <= P labelled encodings per row before
    the tied-softmax matmul shrinks every logits buffer by S/P. The loss is
    identical whenever a row has <= P masked positions; rows beyond the cap
    drop the excess (fixed-budget masking). The P positions are the
    reference's `lax.top_k` of `is_masked * (S - position)`: masked ones
    first in position order, ties to the lower position.
    """
    seq, labels = batch["seq"], batch["labels"]              # (B, S)
    B, S = seq.shape
    P_ = min(cfg.masked_positions, S)
    x = _embed_seq(params, seq, cfg)
    x = L.rms_norm(x, params["ln_f"])                        # (B, S, Dm)
    is_m = (labels >= 0).to(torch.int32)
    key = is_m * (S - torch.arange(S, device=seq.device, dtype=torch.int32))
    _, pos = stable_topk_smallest((-key).float(), P_)       # masked first
    xg = torch.gather(x, 1, pos[..., None].expand(B, P_, x.shape[-1]))
    lg = torch.gather(labels.long(), 1, pos)                 # (B, P)
    logits = (xg @ params["item_emb"].T.to(xg.dtype)).float()
    loss = _masked_nll(logits, lg)
    return loss, {"loss": loss}


@torch.no_grad()
def serve_step(params: dict, batch: dict, cfg: RecsysConfig) -> torch.Tensor:
    """Online/bulk scoring: one logit per example.

    fm/deepfm/bst: forward() already is pairwise scoring. bert4rec: a
    (user-sequence, candidate) pair scores the dot of the last-position
    encoding with the candidate's item embedding (the standard eval
    protocol; the full (B, S, V) softmax is not served at V=10^6).
    batch for bert4rec: {"seq": (B, S), "cand": (B,)}.
    """
    if cfg.kind != "bert4rec":
        return forward(params, batch, cfg)
    u = query_vector(params, batch, cfg)                     # (B, Dm)
    c = params["item_emb"][batch["cand"].long()].float()
    return torch.sum(u * c, dim=-1)


# --------------------------------------------------------------- retrieval -
def query_vector(params: dict, batch: dict, cfg: RecsysConfig) -> torch.Tensor:
    """User/query embedding for retrieval (the ANN query).

    fm/deepfm: the sum of the user fields' embedding vectors: FM's score of
    item i against the user fields is <v_i, sum_f v_f> + lin_i, so
    retrieval reduces exactly to inner-product search (Rendle's trick).
    bst/bert4rec: the sequence encoder's output at the last position
    (SASRec-style next-item retrieval).
    """
    if cfg.kind in ("fm", "deepfm"):
        _, emb = _fm_terms(params, batch["sparse_ids"], cfg)
        return torch.sum(emb, dim=1).float()                 # (B, D)
    if cfg.kind == "bst":
        hist = batch["hist"]
        x = params["item_emb"][hist.long()] \
            + params["pos_emb"][None, :hist.shape[1]]
        x = _encoder(params["blocks"], x.to(cfg.param_dtype), cfg,
                     causal=False)
        return x[:, -1].float()
    if cfg.kind == "bert4rec":
        x = _embed_seq(params, batch["seq"], cfg)
        x = L.rms_norm(x, params["ln_f"])
        return x[:, -1].float()
    raise ValueError(cfg.kind)


def candidate_table(params: dict, cfg: RecsysConfig) -> torch.Tensor:
    """The corpus searched in retrieval_cand."""
    if cfg.kind in ("fm", "deepfm"):
        # the item corpus: field 0's embeddings (the "item id" field)
        return params["tables"][0].float()                  # (V, D)
    return params["item_emb"].float()                        # (n_items, Dm)


@torch.no_grad()
def serve_retrieval(params: dict, batch: dict, cfg: RecsysConfig,
                    k: int = 100, use_kernel: bool = False,
                    shard_topk: int = 0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact retrieval: the 1-to-B inner product over all candidates (the
    paper's H1 workload at B = n_candidates) and a top-k. Returns the k
    smallest distances -q.x (ascending) and their ids (int32), ties to the
    lower id as `lax.top_k` breaks them. The sub-linear alternative is a
    KBest index over candidate_table().

    use_kernel: the distances come from the `batch_dist` kernel (its plain
    version on the CPU). shard_topk = S > 1: the (B, V) scores split into
    S chunks of V/S columns, a top-k per chunk, then a merge of the S*k
    (the reference's row-sharded top-k on one card; the same result as the
    plain top-k). `serve_retrieval_shardmap` is the same merge over a
    device mesh.
    """
    q = query_vector(params, batch, cfg)                     # (B, D)
    cands = candidate_table(params, cfg)                     # (V, D)
    if use_kernel:
        from repro_torch.kernels import ops as kops
        d = kops.batch_dist(q.contiguous(), cands.contiguous(), metric="ip")
    else:
        d = -(q @ cands.T)
    if shard_topk > 1:
        B, V = d.shape
        S = shard_topk
        if V % S:
            raise ValueError(f"{V} candidates do not split into {S} chunks")
        vals_l, ids_l = stable_topk_smallest(d.reshape(B * S, V // S), k)
        base = torch.arange(S, device=d.device) * (V // S)
        ids_l = (ids_l.reshape(B, S, k) + base[None, :, None]).reshape(B, -1)
        vals, pos = stable_topk_smallest(vals_l.reshape(B, S * k), k)
        return vals, torch.gather(ids_l, 1, pos).to(torch.int32)
    vals, ids = stable_topk_smallest(d, k)
    return vals, ids.to(torch.int32)


@torch.no_grad()
def serve_retrieval_shardmap(params: dict, batch: dict, cfg: RecsysConfig,
                             mesh, k: int = 100, axis: str = "model",
                             use_kernel: bool = False
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact retrieval with the candidate table row-sharded over the mesh
    axis `axis` (the same on the other axes): rank i of n scores only rows
    [i*V/n, (i+1)*V/n) of candidate_table() against the query vectors,
    takes a local top-k, adds its row offset, and only the (n, B, k)
    candidates are all-gathered and merged. Every rank passes the whole
    params and batch (query_vector needs the whole table) and gets the
    same (dists, ids) as serve_retrieval: ties to the lower id.
    use_kernel: the local distances come from the `batch_dist` kernel."""
    ax = mesh_axis(mesh, axis)
    q = query_vector(params, batch, cfg)                     # (B, D)
    cands = candidate_table(params, cfg)                     # (V, D)
    V = cands.shape[0]
    if V % ax.size:
        raise ValueError(f"{V} candidates do not split over {ax.size} "
                         f"ranks of {axis!r}")
    V_l = V // ax.size
    c_l = cands[ax.index * V_l:(ax.index + 1) * V_l]
    if use_kernel:
        from repro_torch.kernels import ops as kops
        d = kops.batch_dist(q.contiguous(), c_l.contiguous(), metric="ip")
    else:
        d = -(q @ c_l.T)                                     # (B, V_l)
    vals, ids = stable_topk_smallest(d, k)
    ids = ids.to(torch.int32) + ax.index * V_l
    B = q.shape[0]
    all_v = gather_stack(vals, ax).permute(1, 0, 2).reshape(B, -1)
    all_i = gather_stack(ids, ax).permute(1, 0, 2).reshape(B, -1)
    mv, pos = stable_topk_smallest(all_v, k)
    return mv, torch.gather(all_i, 1, pos)
