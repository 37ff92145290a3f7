"""The port's shared layers (src/repro_torch/layers/common.py) against the
JAX package's, on the same numpy inputs, f32 `rtol=1e-5, atol=1e-6`.

The cases are the ones a torch port gets wrong by default: `rms_norm`
scales by 1 + scale, `layer_norm` takes the population variance, GELU is
the tanh approximation (`jax.nn.gelu`'s default; torch's is exact),
attention under every mask (causal, window, per-example `q_offset`,
`kv_len`) with G = Hq/Hkv > 1, partial RoPE, and `embedding_bag`'s -1
padding in all three modes.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.layers import common as JL
from repro_torch.layers import common as TL
from torch_reference_cache import jax_maps_below_limit  # noqa: F401

torch.set_num_threads(1)

TOL = dict(rtol=1e-5, atol=1e-6)


def _close(out, exp):
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(exp), **TOL)


def _rng(seed=0):
    return np.random.default_rng(seed)


@pytest.mark.parametrize("shape", [(4, 16), (2, 3, 33)])
def test_norms_match_reference(shape):
    r = _rng(1)
    x = (3.0 * r.normal(size=shape) + 0.5).astype(np.float32)
    scale = r.normal(size=shape[-1:]).astype(np.float32)
    bias = r.normal(size=shape[-1:]).astype(np.float32)
    _close(TL.rms_norm(torch.from_numpy(x), torch.from_numpy(scale)),
           JL.rms_norm(jnp.asarray(x), jnp.asarray(scale)))
    _close(TL.layer_norm(torch.from_numpy(x), torch.from_numpy(scale),
                         torch.from_numpy(bias)),
           JL.layer_norm(jnp.asarray(x), jnp.asarray(scale),
                         jnp.asarray(bias)))
    # the traps: 1 + scale, and the population variance
    xt = torch.from_numpy(x)
    zero = torch.zeros(shape[-1])
    assert not torch.allclose(TL.rms_norm(xt, zero),
                              TL.rms_norm(xt, torch.ones(shape[-1])))
    ln = TL.layer_norm(xt, torch.ones(shape[-1]), zero)
    torch.testing.assert_close(
        ln.var(dim=-1, correction=0), torch.ones(shape[:-1]), rtol=1e-3,
        atol=1e-3)


@pytest.mark.parametrize("rotary_frac", [1.0, 0.5, 0.3])
def test_rope_matches_reference(rotary_frac):
    r = _rng(2)
    x = r.normal(size=(2, 7, 3, 16)).astype(np.float32)
    pos = r.integers(0, 4000, size=(2, 7)).astype(np.int32)
    _close(TL.rope_freqs(16), JL.rope_freqs(16))
    _close(TL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos),
                         rotary_frac=rotary_frac),
           JL.apply_rope(jnp.asarray(x), jnp.asarray(pos),
                         rotary_frac=rotary_frac))


@pytest.mark.parametrize("case", ["plain", "causal", "window", "offset",
                                  "offsets_kv_len"])
@pytest.mark.parametrize("hq,hkv", [(4, 4), (4, 2), (6, 1)])
def test_gqa_attention_matches_reference(case, hq, hkv):
    r = _rng(3)
    B, S, T, D = 2, 5, 9, 8
    q = r.normal(size=(B, S, hq, D)).astype(np.float32)
    k = r.normal(size=(B, T, hkv, D)).astype(np.float32)
    v = r.normal(size=(B, T, hkv, D)).astype(np.float32)
    kw = {"causal": case != "plain"}
    tkw = dict(kw)
    if case == "window":
        kw["window"] = tkw["window"] = 3
        kw["q_offset"] = tkw["q_offset"] = 4
    if case == "offset":
        kw["q_offset"] = tkw["q_offset"] = 4
    if case == "offsets_kv_len":
        off = np.array([4, 2], np.int32)
        kv = np.array([9, 6], np.int32)
        kw.update(q_offset=jnp.asarray(off), kv_len=jnp.asarray(kv))
        tkw.update(q_offset=torch.from_numpy(off), kv_len=torch.from_numpy(kv))
    out = TL.gqa_attention(*(torch.from_numpy(a) for a in (q, k, v)), **tkw)
    exp = JL.gqa_attention(*(jnp.asarray(a) for a in (q, k, v)), **kw)
    assert out.shape == (B, S, hq, D)
    _close(out, exp)


@pytest.mark.parametrize("name", ["silu", "gelu", "relu", "tanh"])
def test_act_fn_matches_reference(name):
    x = np.linspace(-6, 6, 241).astype(np.float32)
    _close(TL.act_fn(name)(torch.from_numpy(x)),
           JL.act_fn(name)(jnp.asarray(x)))
    if name == "gelu":   # the tanh form, not torch's exact default
        exact = torch.nn.functional.gelu(torch.from_numpy(x))
        assert float((exact - TL.act_fn(name)(torch.from_numpy(x)))
                     .abs().max()) > 1e-4


@pytest.mark.parametrize("mode", ["sum", "mean", "max"])
def test_embedding_bag_matches_reference(mode):
    r = _rng(4)
    table = r.normal(size=(50, 6)).astype(np.float32)
    ids = r.integers(0, 50, size=(5, 7)).astype(np.int32)
    ids[r.random(ids.shape) < 0.3] = -1
    ids[0, :] = -1                      # an empty bag
    ids[1, 3:] = -1                     # a -1 tail
    mask = ids >= 0
    out = TL.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                           torch.from_numpy(mask), mode)
    exp = JL.embedding_bag(jnp.asarray(table), jnp.asarray(ids),
                           jnp.asarray(mask), mode)
    np.testing.assert_array_equal(np.isfinite(out.numpy()),
                                  np.isfinite(np.asarray(exp)))
    fin = np.isfinite(np.asarray(exp))
    np.testing.assert_allclose(out.numpy()[fin], np.asarray(exp)[fin], **TOL)
    with pytest.raises(ValueError):
        TL.embedding_bag(torch.from_numpy(table), torch.from_numpy(ids),
                         torch.from_numpy(mask), "median")


@pytest.mark.parametrize("shape,scale", [((256, 64), None), ((4096,), None),
                                         ((8, 300, 16), 0.02)])
def test_dense_init_shape_and_scale(shape, scale):
    g = torch.Generator().manual_seed(0)
    x = TL.dense_init(g, shape, scale=scale)
    fan_in = shape[0] if len(shape) >= 2 else 1
    want = scale if scale is not None else 1.0 / np.sqrt(fan_in)
    assert tuple(x.shape) == shape and x.dtype == torch.float32
    assert abs(float(x.std()) / want - 1) < 0.05
    assert TL.dense_init(g, shape, dtype=torch.bfloat16).dtype == \
        torch.bfloat16
    again = TL.dense_init(torch.Generator().manual_seed(0), shape, scale)
    assert torch.equal(x, again)
