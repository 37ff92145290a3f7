"""The port's LM family (src/repro_torch/models/transformer.py, the five LM
configs) against the JAX package's, on the same numpy inputs.

Parameters come from the reference's own `init_params` and are carried
across with `params_from_numpy` (jax.random draws have no torch twin). Per
LM `smoke_config()`: `forward` logits, `loss_fn` (loss, nll, aux) and the
gradient of every leaf, `prefill` (logits and cache) and `init_cache`
followed by three `decode_step`s (logits, cache and len). Tolerance: f32
`rtol=1e-5` with an `atol` of 3e-6 of each output's largest magnitude
and 2e-5 of each gradient leaf's (ATOL_OF_SCALE, GRAD_OF_SCALE: the
errors measured are stated there). Also: a sliding window, the
shard-blocked vocab loss against the reference's naive loss (the
reference's own sharded path fails under this JAX), the three remat
policies, bf16, five Trainer steps against the reference Trainer's, and
the configs field for field.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jreg
from repro.data import pipeline as JP
from repro.layers import moe as JMOE
from repro.models import transformer as JT
from repro.train import loop as JLOOP
from repro.train import optimizer as JO
from repro_torch import configs as treg
from repro_torch.data import pipeline as TP
from repro_torch.layers import moe as TMOE
from repro_torch.models import transformer as TT
from repro_torch.train import loop as TLOOP
from repro_torch.train import optimizer as TO
from repro_torch.train.tree import (leaves_with_path, path_key, to_tensor,
                                    unflatten)
import torch_mesh_ranks
from torch_reference_cache import jax_maps_below_limit  # noqa: F401

torch.set_num_threads(1)

LM_ARCHS = ("qwen2_5_14b", "chatglm3_6b", "gemma_2b", "kimi_k2_1t_a32b",
            "llama4_scout_17b_a16e")
# f32, rtol 1e-5 of each value and an atol of a share of the output's
# largest magnitude. The RecSys slice's 1e-6 holds for one layer; two
# layers of d=128 sums in another order than XLA's reached 1.05e-6 of the
# logits' scale (chatglm3's forward), so 3e-6. Gradient leaves sum over
# tokens, heads and layers as well: up to 6.5e-6 of a leaf's scale
# (llama4's), so 2e-5.
RTOL, ATOL_OF_SCALE = 1e-5, 3e-6
GRAD_OF_SCALE = 2e-5
NO_DROP = 64.0                   # a capacity factor at which no token drops
B, S = 2, 16


def _tokens(cfg, shape=(B, S + 1), seed=1):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab, shape).astype(np.int32)


def _close(out, exp, rtol=RTOL, of_scale=ATOL_OF_SCALE):
    """Within rtol of each value and of_scale of the largest magnitude."""
    exp = np.asarray(exp, dtype=np.float32)
    out = out.detach().float().numpy()
    assert out.shape == exp.shape
    scale = float(np.abs(exp).max()) if exp.size else 0.0
    np.testing.assert_allclose(out, exp, rtol=rtol, atol=of_scale * scale)


def _ref_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): np.asarray(leaf) for path, leaf in flat}


def _carry(cfg, jcfg, seed=0):
    jp = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, TT.params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                                    device="cpu")


@pytest.fixture(scope="module", params=LM_ARCHS)
def arch(request):
    jcfg = jreg.get(request.param).smoke_config()
    cfg = treg.get(request.param).smoke_config()
    return (cfg, jcfg) + _carry(cfg, jcfg)


def _grads(tp, fn):
    """(fn's output, {path: grad}) with every leaf of tp requiring grad."""
    req = [t.clone().requires_grad_(True) for _, t in leaves_with_path(tp)]
    out = fn(unflatten(tp, req))
    loss = out[0] if isinstance(out, tuple) else out
    grads = torch.autograd.grad(loss, req)
    return out, {path_key(p): g for (p, _), g in zip(leaves_with_path(tp),
                                                     grads)}


def _check_grads(grads, jg):
    ref = _ref_paths(jg)
    assert sorted(grads) == sorted(ref)
    for k, g in grads.items():
        _close(g, ref[k], of_scale=GRAD_OF_SCALE)


# --------------------------------------------------------------------------
# params and the module view
# --------------------------------------------------------------------------
def test_params_carry_across_key_for_key(arch):
    cfg, jcfg, jp, tp = arch
    ref = _ref_paths(jp)
    port = {path_key(p): t for p, t in leaves_with_path(tp)}
    assert sorted(ref) == sorted(port)
    for k, a in ref.items():
        np.testing.assert_array_equal(port[k].numpy(), a)
    model = TT.LMModel(cfg, tp)
    assert sorted(p for p, _ in model.named_paths()) == sorted(ref)
    toks = torch.from_numpy(_tokens(cfg)[:, :-1])
    assert torch.equal(model(toks)[0], TT.forward(tp, toks, cfg)[0])
    assert TT.n_params(tp) == sum(a.size for a in ref.values())


def test_init_params_shapes_dtypes_and_scales(arch):
    cfg, jcfg, jp, _ = arch
    ref = _ref_paths(jp)
    own = TT.init_params(cfg, torch.Generator().manual_seed(0))
    port = {path_key(p): t for p, t in leaves_with_path(own)}
    assert sorted(ref) == sorted(port)
    for k, a in ref.items():
        t = port[k]
        assert tuple(t.shape) == a.shape and str(a.dtype) == "float32", k
        if not a.any():
            assert not t.any(), k         # zeros stay zeros
        elif a.size >= 1000:
            assert abs(float(t.std()) / float(a.std()) - 1) < 0.1, k
    # a bf16 config draws its leaves in bf16; the router stays f32
    bcfg = dataclasses.replace(cfg, dtype="bfloat16")
    bown = TT.init_params(bcfg, torch.Generator().manual_seed(0))
    assert bown["layers"]["wq"].dtype == torch.bfloat16
    assert bown["layers"]["ln1"].dtype == torch.float32
    if cfg.moe is not None:
        assert bown["layers"]["moe"]["router"].dtype == torch.float32


def test_params_from_numpy_rejects_wrong_shapes(arch):
    cfg, _, jp, _ = arch
    bad = jax.tree.map(np.asarray, jp)
    bad["embed"] = bad["embed"][:-1]
    with pytest.raises(ValueError):
        TT.params_from_numpy(cfg, bad, device="cpu")


# --------------------------------------------------------------------------
# forward, loss and gradients
# --------------------------------------------------------------------------
def test_forward_logits_match(arch):
    cfg, jcfg, jp, tp = arch
    toks = _tokens(cfg)[:, :-1]
    jl, jaux = JT.forward(jp, jnp.asarray(toks), jcfg)
    tl, taux = TT.forward(tp, torch.from_numpy(toks), cfg)
    assert tl.dtype == torch.float32 and tl.shape == (B, S, cfg.vocab)
    _close(tl, jl)
    _close(taux, jaux, of_scale=1e-6)


def test_loss_and_every_gradient_match(arch):
    cfg, jcfg, jp, tp = arch
    toks = _tokens(cfg, seed=2)
    (jl, jm), jg = jax.value_and_grad(JT.loss_fn, has_aux=True)(
        jp, {"tokens": jnp.asarray(toks)}, jcfg)
    (tl, tm), grads = _grads(tp, lambda p: TT.loss_fn(
        p, {"tokens": torch.from_numpy(toks)}, cfg))
    _close(tl, jl)
    _close(tm["nll"], jm["nll"])
    np.testing.assert_allclose(float(tm["aux"]), float(jm["aux"]),
                               rtol=RTOL, atol=1e-7)
    _check_grads(grads, jg)


def test_prefill_matches(arch):
    cfg, jcfg, jp, tp = arch
    toks = _tokens(cfg, (B, 9), seed=3)
    jlg, jc = JT.prefill(jp, jnp.asarray(toks), jcfg)
    tlg, tc = TT.prefill(tp, torch.from_numpy(toks), cfg)
    assert tlg.shape == (B, 1, cfg.vocab)
    _close(tlg, jlg)
    for k in ("k", "v"):
        assert tc[k].shape == jc[k].shape and tc[k].dtype == torch.float32
        _close(tc[k], jc[k])
    assert tc["len"].dtype == torch.int32
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))


def _decode_both(cfg, jcfg, jp, tp, toks, max_len=12):
    """init_cache then one decode_step per column of toks in both
    packages; yields each step's ((port logits, cache), (ref logits,
    cache))."""
    jc = JT.init_cache(jcfg, toks.shape[0], max_len, dtype=jnp.float32)
    tc = TT.init_cache(cfg, toks.shape[0], max_len, dtype=torch.float32,
                       device="cpu")
    for s in range(toks.shape[1]):
        jlg, jc = JT.decode_step(jp, jc, jnp.asarray(toks[:, s:s + 1]), jcfg)
        tk = tc["k"]
        tlg, tc = TT.decode_step(tp, tc, torch.from_numpy(toks[:, s:s + 1]),
                                 cfg)
        assert tc["k"] is tk                    # written in place
        yield (tlg, tc), (jlg, jc)


def test_decode_steps_match(arch):
    cfg, jcfg, jp, tp = arch
    toks = _tokens(cfg, (B, 3), seed=4)
    for (tlg, tc), (jlg, jc) in _decode_both(cfg, jcfg, jp, tp, toks):
        assert tlg.shape == (B, 1, cfg.vocab)
        _close(tlg, jlg)
    for k in ("k", "v"):
        _close(tc[k], jc[k])
    np.testing.assert_array_equal(tc["len"].numpy(), np.asarray(jc["len"]))
    assert tc["len"].dtype == torch.int32 and int(tc["len"][0]) == 3


@pytest.fixture(scope="module")
def windowed():
    jcfg = dataclasses.replace(jreg.get("qwen2_5_14b").smoke_config(),
                               window=4)
    cfg = dataclasses.replace(treg.get("qwen2_5_14b").smoke_config(),
                              window=4)
    return (cfg, jcfg) + _carry(cfg, jcfg)


def test_sliding_window_matches(windowed):
    """window=4 on a dense config: forward, and decode past the window."""
    cfg, jcfg, jp, tp = windowed
    toks = _tokens(cfg, seed=5)[:, :-1]
    jl, _ = JT.forward(jp, jnp.asarray(toks), jcfg)
    tl, _ = TT.forward(tp, torch.from_numpy(toks), cfg)
    _close(tl, jl)
    full, _ = TT.forward(tp, torch.from_numpy(toks), dataclasses.replace(
        cfg, window=0))
    assert not torch.allclose(tl[:, 4:], full[:, 4:])   # the window bites
    for (tlg, _), (jlg, _) in _decode_both(cfg, jcfg, jp, tp, toks[:, :6]):
        _close(tlg, jlg)


# --------------------------------------------------------------------------
# the shard-blocked vocab loss and remat
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", ["gemma_2b", "kimi_k2_1t_a32b"])
def test_vocab_blocked_loss_matches_reference_naive_loss(name):
    """loss_vocab_shards=2 (the reference's vocab-sharded loss on one card)
    against the reference's naive loss_fn: loss, nll, aux and gradients."""
    jcfg = jreg.get(name).smoke_config()
    cfg = dataclasses.replace(treg.get(name).smoke_config(),
                              loss_vocab_axis="model",
                              loss_batch_axes=("data",), loss_vocab_shards=2)
    jp, tp = _carry(cfg, jcfg)
    toks = _tokens(cfg, seed=6)
    (jl, jm), jg = jax.value_and_grad(JT.loss_fn, has_aux=True)(
        jp, {"tokens": jnp.asarray(toks)}, jcfg)
    (tl, tm), grads = _grads(tp, lambda p: TT.loss_fn(
        p, {"tokens": torch.from_numpy(toks)}, cfg))
    _close(tl, jl)
    _close(tm["nll"], jm["nll"])
    _check_grads(grads, jg)


def test_remat_policies_match():
    """remat=True under "full", "dots" and "dots_nb" gives the losses and
    gradients of remat=False (the reference's own test asks rtol=1e-6 of
    the loss; the port's policies only choose what is saved)."""
    name = "kimi_k2_1t_a32b"         # MoE: the batched expert GEMMs too
    cfg0 = treg.get(name).smoke_config()
    jcfg = jreg.get(name).smoke_config()
    jp, tp = _carry(cfg0, jcfg)
    batch = {"tokens": torch.from_numpy(_tokens(cfg0, (2, 9), seed=7))}
    (l0, _), g0 = _grads(tp, lambda p: TT.loss_fn(p, batch, cfg0))
    for pol in ("full", "dots", "dots_nb"):
        cfg = dataclasses.replace(cfg0, remat=True, remat_policy=pol)
        (l1, _), g1 = _grads(tp, lambda p: TT.loss_fn(p, batch, cfg))
        assert torch.equal(l0, l1), pol
        for k in g0:
            assert torch.equal(g0[k], g1[k]), (pol, k)


def test_shardmap_dispatch_is_not_ported():
    """`MoEConfig.use_shardmap` runs the model's MoE layers through
    moe_ffn_shardmap (the name is from before that dispatch was ported):
    llama4-scout's smoke config on 4 gloo ranks, a (2, 2) mesh (experts
    over "data", expert widths over "model", batch rows over "data"), at
    no-drop capacity. Each rank's forward logits and nll equal the
    one-process model's (use_shardmap=False) on its batch row, and the
    logits those of the whole batch's forward; its aux is the mean of the
    rows' (the reference's pmean over the EP axis) and its loss its nll
    plus that aux."""
    inp = torch_mesh_ranks.lm_inputs()
    base = dataclasses.replace(inp["cfg"], moe=dataclasses.replace(
        inp["cfg"].moe, use_shardmap=False))
    tp = TT.params_from_numpy(base, inp["params"], device="cpu")
    toks = inp["tokens"]
    ranks = torch_mesh_ranks.spawn("lm_shardmap", inp)
    full, _ = TT.forward(tp, torch.from_numpy(toks[:, :-1]), base)
    rows = [TT.loss_fn(tp, {"tokens": torch.from_numpy(toks[r:r + 1])},
                       base)[1] for r in range(2)]
    aux = float(np.mean([float(m["aux"]) for m in rows]))
    for rank, out in enumerate(ranks):
        r = rank // 2
        logits, _ = TT.forward(tp, torch.from_numpy(toks[r:r + 1, :-1]),
                               base)
        _close(torch.from_numpy(out["logits"]), logits)
        _close(torch.from_numpy(out["logits"]), full[r:r + 1])
        nll = float(rows[r]["nll"])
        np.testing.assert_allclose(out["nll"], nll, rtol=RTOL)
        np.testing.assert_allclose(out["aux"], aux, rtol=RTOL)
        np.testing.assert_allclose(out["loss"], nll + aux, rtol=RTOL)


@pytest.mark.parametrize("name", ["kimi_k2_1t_a32b", "llama4_scout_17b_a16e"])
def test_moe_prefill_and_decode_match_forward_without_drops(name):
    """Prefill of 32 tokens, then 16 decode steps, against one forward
    over the 48: at no-drop capacity the MoE archs' cache path gives the
    forward's logits (the drift at the default capacity is the drop set,
    which depends on the number of tokens in a call)."""
    cfg = treg.get(name).smoke_config()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=NO_DROP))
    tp = TT.init_params(cfg, torch.Generator().manual_seed(0))
    toks = torch.from_numpy(_tokens(cfg, (B, 48), seed=10))
    full, _ = TT.forward(tp, toks, cfg)
    lg, pc = TT.prefill(tp, toks[:, :32], cfg)
    cache = TT.init_cache(cfg, B, 48, dtype=torch.float32, device="cpu")
    cache["k"][:, :, :32] = pc["k"]
    cache["v"][:, :, :32] = pc["v"]
    cache["len"].fill_(32)
    steps = [lg]
    for s in range(32, 48):
        lg, cache = TT.decode_step(tp, cache, toks[:, s:s + 1], cfg)
        steps.append(lg)
    _close(torch.cat(steps, dim=1), full[:, 31:], of_scale=1e-6)


# --------------------------------------------------------------------------
# bf16
# --------------------------------------------------------------------------
BF16_TOL = dict(rtol=2e-2, of_scale=2e-2)   # a few bf16 ulps (2^-8)


def test_forward_keeps_bf16():
    """A dense config in bf16 (the reference's bf16 draws, carried across
    from their raw 16 bits): the hidden states stay bf16, and the logits
    fall within a few bf16 ulps of the reference's."""
    name = "chatglm3_6b"
    jcfg = dataclasses.replace(jreg.get(name).smoke_config(),
                               dtype="bfloat16")
    cfg = dataclasses.replace(treg.get(name).smoke_config(),
                              dtype="bfloat16")
    jp, tp = _carry(cfg, jcfg)
    assert tp["layers"]["wq"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        tp["embed"].float().numpy(),
        np.asarray(jp["embed"]).astype(np.float32))
    toks = _tokens(cfg, seed=8)[:, :-1]
    x, _ = TT.forward_features(tp, torch.from_numpy(toks), cfg)
    assert x.dtype == torch.bfloat16
    jl, _ = JT.forward(jp, jnp.asarray(toks), jcfg)
    tl, _ = TT.forward(tp, torch.from_numpy(toks), cfg)
    _close(tl, jl, **BF16_TOL)


def test_moe_ffn_keeps_bf16():
    """The reference's f32-poisoning guard (`test_moe_keeps_dtype_bf16`),
    on the port: bf16 in, bf16 out, within a few bf16 ulps."""
    cfg = JMOE.MoEConfig(n_experts=4, top_k=2, d_ff_expert=16)
    jp = JMOE.init_moe(jax.random.PRNGKey(0), 8, cfg, dtype=jnp.bfloat16)
    x = jax.random.normal(jax.random.PRNGKey(1), (12, 8)).astype(jnp.bfloat16)
    tcfg = TMOE.MoEConfig(n_experts=4, top_k=2, d_ff_expert=16)
    tp = {k: to_tensor(np.asarray(v), "cpu") for k, v in jp.items()}
    tx = to_tensor(np.asarray(x), "cpu")
    assert tx.dtype == tp["w_in"].dtype == torch.bfloat16
    out, aux = TMOE.moe_ffn(tp, tx, tcfg)
    jout, jaux = JMOE.moe_ffn(jp, x, cfg)
    assert out.dtype == torch.bfloat16 and aux.dtype == torch.float32
    _close(out, np.asarray(jout).astype(np.float32), **BF16_TOL)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=1e-5)


# --------------------------------------------------------------------------
# the Trainer
# --------------------------------------------------------------------------
TINY = dict(name="tiny", n_layers=2, d_model=64, n_heads=4, n_kv_heads=4,
            d_ff=128, vocab=128, dtype="float32", remat=False)


@pytest.mark.parametrize("name", ["tiny", "llama4_scout_17b_a16e"])
def test_five_steps_match_reference_trainer(tmp_path, name):
    """`tests/test_train.py`'s TINY LM (and llama4-scout's f32 smoke
    config, an MoE), its lr and its stream: five AdamW steps of the port's
    Trainer give the reference Trainer's losses within atol=1e-5, its
    moments within the deepfm case's bound, and its params within a tenth
    of lr. Adam's update g / (|g| + eps) turns a gradient's absolute error
    d into lr * d / eps where |g| is near eps = 1e-8: one entry of w_out
    (|g| ~ 1e-8, its leaf's largest 8e-3) moves 3.75e-5 apart in the
    first step, an f32 difference of 5e-8 of the leaf's scale."""
    if name == "tiny":
        jcfg, cfg = JT.LMConfig(**TINY), TT.LMConfig(**TINY)
    else:
        jcfg, cfg = jreg.get(name).smoke_config(), \
            treg.get(name).smoke_config()
    jp, tp = _carry(cfg, jcfg)
    n = 5
    jtr = JLOOP.Trainer(lambda p, b: JT.loss_fn(p, b, jcfg),
                        JO.OptConfig(lr=1e-3),
                        JLOOP.TrainerConfig(ckpt_dir=str(tmp_path / "j"),
                                            ckpt_every=100, log_every=1),
                        donate=False)
    jout = jtr.fit(jp, JP.lm_batches(cfg.vocab, 8, 32), n_steps=n)
    ttr = TLOOP.Trainer(lambda p, b: TT.loss_fn(p, b, cfg),
                        TO.OptConfig(lr=1e-3),
                        TLOOP.TrainerConfig(ckpt_dir=str(tmp_path / "t"),
                                            ckpt_every=100, log_every=1),
                        device="cpu")
    tout = ttr.fit(tp, TP.lm_batches(cfg.vocab, 8, 32), n_steps=n)
    np.testing.assert_allclose([h["loss"] for h in tout["history"]],
                               [h["loss"] for h in jout["history"]],
                               rtol=0, atol=1e-5)
    for got, exp, tol in ((tout["params"], jout["params"], dict(atol=1e-4)),
                          (tout["opt"], jout["opt"],
                           dict(rtol=1e-4, atol=1e-7))):
        ref = _ref_paths(exp)
        assert sorted(ref) == sorted(path_key(p)
                                     for p, _ in leaves_with_path(got))
        for p, t in leaves_with_path(got):
            np.testing.assert_allclose(t.numpy(), ref[path_key(p)],
                                       err_msg=path_key(p), **tol)


# --------------------------------------------------------------------------
# configs
# --------------------------------------------------------------------------
@pytest.mark.parametrize("name", LM_ARCHS)
def test_configs_equal_field_for_field(name):
    jm, tm = jreg.get(name), treg.get(name)
    assert (tm.ARCH_ID, tm.FAMILY, tm.SHAPES) == (jm.ARCH_ID, jm.FAMILY,
                                                  jm.SHAPES)
    for fn in ("full_config", "smoke_config"):
        tc, jc = getattr(tm, fn)(), getattr(jm, fn)()
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        assert tc.hd == jc.hd
        assert tc.param_dtype == (torch.bfloat16 if jc.dtype == "bfloat16"
                                  else torch.float32)


def test_config_classes_equal_reference():
    for t, j in ((TT.LMConfig, JT.LMConfig),
                 (TMOE.MoEConfig, JMOE.MoEConfig)):
        assert [(f.name, f.default) for f in dataclasses.fields(t)] == \
            [(f.name, f.default) for f in dataclasses.fields(j)]
    # the capacity is the reference's floor expression
    for T, cf in ((16, 1.25), (7, 1.0), (1, 0.5), (30, 2.0)):
        cfg = TMOE.MoEConfig(n_experts=3, top_k=2, d_ff_expert=4,
                             capacity_factor=cf)
        assert TMOE.capacity(T, cfg) == max(1, int(T * 2 / 3 * cf))
