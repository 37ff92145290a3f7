"""The port's MoE FFN (src/repro_torch/layers/moe.py) against the JAX
package's `layers/moe.py`, on the same numpy inputs.

The dispatch is held bit for bit: the top-k expert ids against
`lax.top_k` (an exact-tie case included: zero router weights give every
token experts 0..K-1), and the kept set, slots, token order and slot
buffer against the reference's sort-based dispatch (its lines, applied to
the reference's own top-k). `out`, `aux` and the gradients of every
parameter and of x within f32 `rtol=1e-5` and an atol of 3e-6 of each
output's largest magnitude (2e-5 for gradients; the errors measured are
in tests/test_torch_lm.py). Cases cover drops (capacity below the load),
ungated and shared experts.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.layers import moe as JMOE
from repro_torch.layers import moe as TMOE
from torch_reference_cache import jax_maps_below_limit  # noqa: F401

torch.set_num_threads(1)

RTOL, ATOL_OF_SCALE, GRAD_OF_SCALE = 1e-5, 3e-6, 2e-5
D = 16

# (T, E, K, capacity_factor, gated, n_shared)
CASES = [
    (24, 4, 2, 1.25, True, 0),      # the default
    (24, 8, 2, 0.5, True, 1),       # drops, a shared expert
    (33, 6, 3, 1.0, False, 0),      # ungated, T*K/E not an integer: C floors
    (16, 4, 1, 0.25, True, 2),      # top-1, heavy drops, two shared
    (40, 16, 4, 2.0, False, 1),     # no drops
]


def _close(out, exp, of_scale=ATOL_OF_SCALE):
    exp = np.asarray(exp, dtype=np.float32)
    scale = float(np.abs(exp).max()) if exp.size else 0.0
    np.testing.assert_allclose(out.detach().numpy(), exp, rtol=RTOL,
                               atol=of_scale * scale)


def _setup(T, E, K, cf, gated, shared, zero_router=False, seed=0):
    kw = dict(n_experts=E, top_k=K, d_ff_expert=8, capacity_factor=cf,
              gated=gated, n_shared_experts=shared)
    jcfg, cfg = JMOE.MoEConfig(**kw), TMOE.MoEConfig(**kw)
    jp = JMOE.init_moe(jax.random.PRNGKey(seed), D, jcfg)
    if zero_router:
        jp["router"] = jnp.zeros_like(jp["router"])
    x = np.random.default_rng(seed + 1).normal(size=(T, D)).astype(np.float32)
    tp = {k: torch.from_numpy(np.array(v)) for k, v in jp.items()}
    return jcfg, cfg, jp, tp, x


def _ref_dispatch(jp, x, jcfg):
    """The reference's routing and dispatch lines (`moe_ffn`, routing and
    "sort-based dispatch"), on its own router and `lax.top_k`."""
    T = x.shape[0]
    E, K = jcfg.n_experts, jcfg.top_k
    C = max(1, int(T * K / E * jcfg.capacity_factor))
    probs = jax.nn.softmax(jnp.asarray(x) @ jp["router"], axis=-1)
    w, eidx = jax.lax.top_k(probs, K)
    w = w / jnp.maximum(jnp.sum(w, axis=-1, keepdims=True), 1e-9)
    flat_e = eidx.reshape(-1)
    flat_t = jnp.repeat(jnp.arange(T, dtype=jnp.int32), K)
    order = jnp.argsort(flat_e, stable=True)
    se, st, sw = flat_e[order], flat_t[order], w.reshape(-1)[order]
    counts = jax.ops.segment_sum(jnp.ones_like(se, jnp.int32), se,
                                 num_segments=E)
    starts = jnp.concatenate([jnp.zeros((1,), jnp.int32),
                              jnp.cumsum(counts)[:-1]])
    pos = jnp.arange(T * K, dtype=jnp.int32) - starts[se]
    keep = pos < C
    slot = jnp.where(keep, se * C + pos, E * C)
    buf = jnp.full((E * C + 1,), -1, jnp.int32).at[slot].set(
        jnp.where(keep, st, -1))[:E * C]
    return C, eidx, w, dict(st=st, sw=sw, keep=keep, slot=slot, buf_tok=buf)


def _check_dispatch(jcfg, cfg, jp, tp, x):
    C, jeidx, jw, ref = _ref_dispatch(jp, x, jcfg)
    assert TMOE.capacity(x.shape[0], cfg) == C
    _, w, eidx = TMOE.route(tp, torch.from_numpy(x), cfg)
    np.testing.assert_array_equal(eidx.numpy(), np.asarray(jeidx))
    _close(w, jw)
    dp = TMOE.dispatch(w, eidx, cfg.n_experts, C)
    for name in ("st", "keep", "slot", "buf_tok"):
        np.testing.assert_array_equal(getattr(dp, name).numpy(),
                                      np.asarray(ref[name]), err_msg=name)
    _close(dp.sw, ref["sw"])
    return dp


@pytest.mark.parametrize("case", CASES, ids=[
    "T{}-E{}-K{}-cf{}-{}-sh{}".format(T, E, K, cf, "gated" if g else "plain",
                                      sh)
    for T, E, K, cf, g, sh in CASES])
def test_moe_ffn_matches_reference(case):
    jcfg, cfg, jp, tp, x = _setup(*case)
    dp = _check_dispatch(jcfg, cfg, jp, tp, x)
    T, E, K, cf = case[:4]
    if cf < 1.0:
        assert not bool(dp.keep.all())          # the case drops
    # out, aux and every gradient (of x too)
    def jloss(p, x):
        out, aux = JMOE.moe_ffn(p, x, jcfg)
        return jnp.sum(out * jnp.cos(out)) + aux, (out, aux)
    (_, (jout, jaux)), (jgp, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(jp, jnp.asarray(x))
    req = {k: v.clone().requires_grad_(True) for k, v in tp.items()}
    tx = torch.from_numpy(x).requires_grad_(True)
    out, aux = TMOE.moe_ffn(req, tx, cfg)
    assert out.dtype == torch.float32 and out.shape == (T, D)
    _close(out, jout)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=RTOL, atol=1e-8)
    loss = torch.sum(out * torch.cos(out)) + aux
    names = sorted(req)
    grads = torch.autograd.grad(loss, [req[k] for k in names] + [tx])
    assert sorted(jgp) == names
    for k, g in zip(names + ["x"], grads):
        # at K=1 the renormalised weight is p/p, whose gradient is zero up
        # to rounding of the terms it cancels: the router's leaf is then the
        # aux loss's gradient (largest 9e-4) plus that noise, measured at
        # 7.5e-5 of the leaf's scale; 1e-3 of it there
        tol = 1e-3 if (k == "router" and K == 1) else GRAD_OF_SCALE
        _close(g, jgx if k == "x" else jgp[k], of_scale=tol)


@pytest.mark.parametrize("K", [1, 2, 3])
def test_exact_ties_go_to_the_lower_expert(K):
    """Zero router weights: every probability ties, so lax.top_k gives
    experts 0..K-1 to every token, and so must the port."""
    jcfg, cfg, jp, tp, x = _setup(20, 6, K, 1.0, True, 0, zero_router=True)
    dp = _check_dispatch(jcfg, cfg, jp, tp, x)
    _, _, eidx = TMOE.route(tp, torch.from_numpy(x), cfg)
    assert torch.equal(eidx, torch.arange(K).expand(20, K))
    assert not bool(dp.keep.all())         # 20 tokens into C = 3 slots each
    jout, jaux = JMOE.moe_ffn(jp, jnp.asarray(x), jcfg)
    out, aux = TMOE.moe_ffn(tp, torch.from_numpy(x), cfg)
    _close(out, jout)
    np.testing.assert_allclose(float(aux), float(jaux), rtol=RTOL)


def test_sharding_fields_change_no_value():
    """ep_axis, tp_axis and token_axes only pin the reference's sharding:
    the port reads and ignores them (the reference's
    `test_moe_ep_constraints_nop_without_axes`, on the port)."""
    import dataclasses
    jcfg, cfg, jp, tp, x = _setup(*CASES[1])
    cfg2 = dataclasses.replace(cfg, ep_axis="data", tp_axis="model",
                               token_axes=("data",))
    a = TMOE.moe_ffn(tp, torch.from_numpy(x), cfg)
    b = TMOE.moe_ffn(tp, torch.from_numpy(x), cfg2)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_init_moe_shapes_and_scales():
    jcfg, cfg, jp, _, _ = _setup(8, 16, 2, 1.0, True, 1)
    own = TMOE.init_moe(torch.Generator().manual_seed(0), D, cfg)
    assert sorted(own) == sorted(jp)
    for k, a in jp.items():
        assert tuple(own[k].shape) == a.shape and own[k].dtype == torch.float32
        assert abs(float(own[k].std()) / float(jnp.std(a)) - 1) < 0.15, k
    bf = TMOE.init_moe(torch.Generator().manual_seed(0), D, cfg,
                       dtype=torch.bfloat16)
    assert bf["router"].dtype == torch.float32
    assert bf["w_in"].dtype == bf["shared_w_out"].dtype == torch.bfloat16
