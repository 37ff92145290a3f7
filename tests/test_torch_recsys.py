"""The port's RecSys family (src/repro_torch/models/recsys.py and the four
configs) against the JAX package's, on the same numpy inputs.

Parameters come from the reference's own `init_params` and are carried
across with `params_from_numpy` (jax.random draws have no torch twin). Per
`smoke_config()`: forward, loss and the gradient of every leaf
(`jax.value_and_grad` against `torch.autograd`), `serve_step`,
`query_vector` and `candidate_table` within f32 `rtol=1e-5, atol=1e-6`;
`serve_retrieval` on both distance paths (the reference's Pallas
`batch_dist` in interpret mode, the port's plain version) within the
kernels' `rtol=3e-5, atol=3e-4`, ids through `assert_same_ranking`; the
port's chunked top-k equal to its plain one bit for bit; bert4rec's masked
loss; the configs field for field.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jreg
from repro.models import recsys as JR
from repro_torch import configs as treg
from repro_torch.models import recsys as TR
from repro_torch.train.tree import leaves_with_path, path_key, unflatten
from test_torch_parity import assert_same_ranking
from torch_reference_cache import jax_maps_below_limit  # noqa: F401

torch.set_num_threads(1)

ARCHS = ("fm", "deepfm", "bst", "bert4rec")
TOL = dict(rtol=1e-5, atol=1e-6)
DIST_TOL = dict(rtol=3e-5, atol=3e-4)
B = 6


def _batch(cfg, seed=1, masked=0.25):
    """A numpy batch of each kind's keys (bert4rec also "cand")."""
    r = np.random.default_rng(seed)
    if cfg.kind in ("fm", "deepfm"):
        return {"sparse_ids": r.integers(0, cfg.vocab_per_field,
                                         (B, cfg.n_sparse)).astype(np.int32),
                "label": (r.random(B) < 0.5).astype(np.float32)}
    if cfg.kind == "bst":
        return {"hist": r.integers(0, cfg.n_items,
                                   (B, cfg.seq_len)).astype(np.int32),
                "target": r.integers(0, cfg.n_items, B).astype(np.int32),
                "label": (r.random(B) < 0.5).astype(np.float32)}
    seq = r.integers(1, cfg.n_items, (B, cfg.seq_len)).astype(np.int32)
    labels = np.where(r.random(seq.shape) < masked, seq, -1).astype(np.int32)
    labels[0] = -1                       # a row with no label
    return {"seq": np.where(labels >= 0, 0, seq).astype(np.int32),
            "labels": labels,
            "cand": r.integers(0, cfg.n_items, B).astype(np.int32)}


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module", params=ARCHS)
def arch(request):
    jcfg = jreg.get(request.param).smoke_config()
    cfg = treg.get(request.param).smoke_config()
    jp = JR.init_params(jcfg, jax.random.PRNGKey(0))
    tp = TR.params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")
    return cfg, jcfg, jp, tp


def _close(out, exp, tol=TOL):
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(exp), **tol)


def _ref_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): np.asarray(leaf) for path, leaf in flat}


# --------------------------------------------------------------------------
# params and the module view
# --------------------------------------------------------------------------
def test_params_carry_across_key_for_key(arch):
    cfg, jcfg, jp, tp = arch
    ref = _ref_paths(jp)
    port = {path_key(p): t for p, t in leaves_with_path(tp)}
    assert sorted(ref) == sorted(port)
    for k, a in ref.items():
        assert port[k].dtype == torch.float32
        np.testing.assert_array_equal(port[k].numpy(), a)
    model = TR.RecsysModel(cfg, tp)
    assert sorted(p for p, _ in model.named_paths()) == sorted(ref)
    b = _torch(_batch(cfg))
    assert torch.equal(model(b), TR.forward(tp, b, cfg))
    # the module shares the tree's storage
    assert all(t.data_ptr() == dict(model.named_paths())[path_key(p)]
               .data_ptr() for p, t in leaves_with_path(tp))


def test_init_params_shapes_dtypes_and_scales(arch):
    cfg, jcfg, jp, _ = arch
    ref = _ref_paths(jp)
    own = TR.init_params(cfg, torch.Generator().manual_seed(0))
    port = {path_key(p): t for p, t in leaves_with_path(own)}
    assert sorted(ref) == sorted(port)
    for k, a in ref.items():
        t = port[k]
        assert tuple(t.shape) == a.shape and str(a.dtype) == "float32", k
        if not a.any():
            assert not t.any(), k         # zeros stay zeros
        elif a.size >= 1000:
            assert abs(float(t.std()) / float(a.std()) - 1) < 0.1, k
    again = TR.init_params(cfg, torch.Generator().manual_seed(0))
    assert all(torch.equal(a, b) for a, b in zip(
        (t for _, t in leaves_with_path(own)),
        (t for _, t in leaves_with_path(again))))


def test_params_from_numpy_rejects_wrong_shapes(arch):
    cfg, jcfg, jp, _ = arch
    bad = jax.tree.map(np.asarray, jp)
    key = "tables" if cfg.kind in ("fm", "deepfm") else "item_emb"
    bad[key] = bad[key][:-1]
    with pytest.raises(ValueError):
        TR.params_from_numpy(cfg, bad, device="cpu")


# --------------------------------------------------------------------------
# forward, loss and gradients
# --------------------------------------------------------------------------
def test_forward_loss_and_every_gradient_match(arch):
    cfg, jcfg, jp, tp = arch
    batch = _batch(cfg)
    jb = _jax(batch)
    _close(TR.forward(tp, _torch(batch), cfg), JR.forward(jp, jb, jcfg))
    (jl, _), jg = jax.value_and_grad(JR.loss_fn, has_aux=True)(jp, jb, jcfg)
    req = {path_key(p): t.clone().requires_grad_(True)
           for p, t in leaves_with_path(tp)}
    tree = unflatten(tp, [req[path_key(p)] for p, _ in leaves_with_path(tp)])
    tl, metrics = TR.loss_fn(tree, _torch(batch), cfg)
    _close(tl, jl)
    assert metrics["loss"] is tl
    names = sorted(req)
    grads = torch.autograd.grad(tl, [req[k] for k in names])
    ref = _ref_paths(jg)
    for k, g in zip(names, grads):
        _close(g, ref[k])


def test_serving_functions_match(arch):
    cfg, jcfg, jp, tp = arch
    batch = _batch(cfg, seed=2)
    jb, tb = _jax(batch), _torch(batch)
    _close(TR.serve_step(tp, tb, cfg), JR.serve_step(jp, jb, jcfg))
    _close(TR.query_vector(tp, tb, cfg), JR.query_vector(jp, jb, jcfg))
    _close(TR.candidate_table(tp, cfg), JR.candidate_table(jp, jcfg))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_serve_retrieval_matches_reference(arch, use_kernel):
    cfg, jcfg, jp, tp = arch
    batch = _batch(cfg, seed=3)
    jd, ji = JR.serve_retrieval(jp, _jax(batch), jcfg, k=100,
                                use_kernel=use_kernel)
    td, ti = TR.serve_retrieval(tp, _torch(batch), cfg, k=100,
                                use_kernel=use_kernel)
    assert ti.dtype == torch.int32 and td.dtype == torch.float32
    assert_same_ranking(td.numpy(), ti.numpy(), np.asarray(jd),
                        np.asarray(ji), tol=DIST_TOL)


@pytest.mark.parametrize("shard_topk", [2, 4])
def test_chunked_topk_equals_plain_bit_for_bit(arch, shard_topk):
    cfg, _, _, tp = arch
    batch = _torch(_batch(cfg, seed=4))
    d0, i0 = TR.serve_retrieval(tp, batch, cfg, k=100)
    d1, i1 = TR.serve_retrieval(tp, batch, cfg, k=100, shard_topk=shard_topk)
    assert torch.equal(d0, d1) and torch.equal(i0, i1)
    assert i1.dtype == torch.int32


def test_retrieval_ties_go_to_the_lower_id():
    """Duplicate candidate rows tie exactly; `lax.top_k` keeps the lower
    id first, and so must every top-k of the port (plain and chunked)."""
    cfg, jcfg = treg.get("bst").smoke_config(), jreg.get("bst").smoke_config()
    tp = TR.init_params(cfg, torch.Generator().manual_seed(3))
    tp["item_emb"][300:400] = tp["item_emb"][0:100]   # rows 300+i == rows i
    batch = _batch(cfg, seed=5)
    jp = jax.tree.map(lambda t: jnp.asarray(t.numpy()), tp)
    jd, ji = JR.serve_retrieval(jp, _jax(batch), jcfg, k=100)
    batch = _torch(batch)
    for s in (0, 4):
        td, ti = TR.serve_retrieval(tp, batch, cfg, k=100, shard_topk=s)
        # every tied pair keeps the lower id first
        tied = td[:, 1:] == td[:, :-1]
        assert int(tied.sum()) > 0
        assert bool((ti[:, 1:] > ti[:, :-1])[tied].all())
        assert_same_ranking(td.numpy(), ti.numpy(), np.asarray(jd),
                            np.asarray(ji), tol=DIST_TOL, max_tied=1.0)


# --------------------------------------------------------------------------
# bert4rec's masked loss
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def b4r():
    jcfg = jreg.get("bert4rec").smoke_config()
    cfg = treg.get("bert4rec").smoke_config()
    jp = JR.init_params(jcfg, jax.random.PRNGKey(0))
    tp = TR.params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                              device="cpu")
    return cfg, jcfg, jp, tp


def test_bert4rec_masked_loss_matches_full(b4r):
    """The reference's test, on the port: P covering every position gives
    the full loss."""
    cfg, _, _, tp = b4r
    batch = _torch(_batch(cfg, seed=6, masked=0.2))
    l0, _ = TR.loss_fn(tp, batch, cfg)
    cfg2 = dataclasses.replace(cfg, masked_positions=cfg.seq_len)
    l1, _ = TR.loss_fn(tp, batch, cfg2)
    np.testing.assert_allclose(float(l0), float(l1), rtol=1e-5)


@pytest.mark.parametrize("P", [2, 3, 12])
def test_bert4rec_masked_loss_matches_reference(b4r, P):
    """Below the row's masked count P drops the excess; which positions
    stay is `lax.top_k`'s choice (masked first, lower position first)."""
    cfg, jcfg, jp, tp = b4r
    cfg = dataclasses.replace(cfg, masked_positions=P)
    jcfg = dataclasses.replace(jcfg, masked_positions=P)
    batch = _batch(cfg, seed=7, masked=0.4)
    assert ((batch["labels"] >= 0).sum(1) > 3).any()
    jl, jg = jax.value_and_grad(
        lambda p: JR.loss_fn(p, _jax(batch), jcfg)[0])(jp)
    req = [t.clone().requires_grad_(True) for _, t in leaves_with_path(tp)]
    tl, _ = TR.loss_fn(unflatten(tp, req), _torch(batch), cfg)
    _close(tl, jl)
    ref = _ref_paths(jg)
    for (p, _), g in zip(leaves_with_path(tp), torch.autograd.grad(tl, req)):
        _close(g, ref[path_key(p)])


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", ARCHS)
def test_configs_equal_field_for_field(name):
    jm, tm = jreg.get(name), treg.get(name)
    assert (tm.ARCH_ID, tm.FAMILY, tm.SHAPES) == (jm.ARCH_ID, jm.FAMILY,
                                                  jm.SHAPES)
    for fn in ("full_config", "smoke_config"):
        tc, jc = getattr(tm, fn)(), getattr(jm, fn)()
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert tc.param_dtype == torch.float32


def test_registry_equals_reference():
    assert treg.ARCHS == jreg.ARCHS and treg._ALIAS == jreg._ALIAS
    assert (treg.LM_SHAPES, treg.GNN_SHAPES, treg.RECSYS_SHAPES) == \
        (jreg.LM_SHAPES, jreg.GNN_SHAPES, jreg.RECSYS_SHAPES)
    assert [f.name for f in dataclasses.fields(TR.RecsysConfig)] == \
        [f.name for f in dataclasses.fields(JR.RecsysConfig)]
    assert dataclasses.replace(treg.get("bst").smoke_config(),
                               dtype="bfloat16").param_dtype == torch.bfloat16


@pytest.mark.parametrize("arch_name", ["gemma-2b", "qwen2.5-14b", "dimenet",
                                       "chatglm3-6b", "kimi-k2-1t-a32b",
                                       "llama4-scout-17b-a16e"])
def test_unported_families_name_their_roadmap_item(arch_name):
    """The LM and GNN archs, once unported (`get()` raised the error naming
    their ROADMAP item), now resolve to the port's own config modules."""
    mod = treg.get(arch_name)
    name = arch_name.replace("-", "_").replace(".", "_")
    assert mod.__name__ == f"repro_torch.configs.{name}"
    assert mod.FAMILY == jreg.get(arch_name).FAMILY
    with pytest.raises(AssertionError):
        treg.get("no_such_arch")
