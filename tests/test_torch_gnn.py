"""The port's GNN family (src/repro_torch/models/dimenet.py and its config)
against the JAX package's, on the same numpy inputs.

Parameters come from the reference's `init_params` through
`params_from_numpy`. `smoke_config()` on a `gnn_minibatches` batch
(node classification) and, as graph regression, on a `molecule_batches`
batch: `forward`, `loss_fn` and the gradient of every leaf within f32
`rtol=1e-5` and an atol of 3e-6 of each output's largest magnitude (2e-5
of each gradient leaf's; the errors measured on the LM family are stated
in tests/test_torch_lm.py, DimeNet's are below them). `remat` and
`unroll_blocks` change no value. The config's `full_config` of every
shape, `SHAPE_PARAMS` and `TRIPLET_CAP` equal the reference's.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jreg
from repro.models import dimenet as JD
from repro_torch import configs as treg
from repro_torch.data import pipeline as TP
from repro_torch.models import dimenet as TD
from repro_torch.train.tree import leaves_with_path, path_key, unflatten
from torch_reference_cache import jax_maps_below_limit  # noqa: F401

torch.set_num_threads(1)

RTOL, ATOL_OF_SCALE, GRAD_OF_SCALE = 1e-5, 3e-6, 2e-5


def _close(out, exp, of_scale=ATOL_OF_SCALE):
    exp = np.asarray(exp, dtype=np.float32)
    scale = float(np.abs(exp).max()) if exp.size else 0.0
    np.testing.assert_allclose(out.detach().numpy(), exp, rtol=RTOL,
                               atol=of_scale * scale)


def _ref_paths(tree):
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): np.asarray(leaf) for path, leaf in flat}


@pytest.fixture(scope="module", params=["node_clf", "graph_reg"])
def task(request):
    """(cfg, jcfg, jp, tp, numpy batch, n_graphs) of one task."""
    jcfg = jreg.get("dimenet").smoke_config()
    cfg = treg.get("dimenet").smoke_config()
    if request.param == "graph_reg":
        jcfg = dataclasses.replace(jcfg, task="graph_reg", n_out=1)
        cfg = dataclasses.replace(cfg, task="graph_reg", n_out=1)
        batch, n_graphs = next(TP.molecule_batches(6, 12, 4, cfg.d_feat)), 4
    else:
        batch, n_graphs = next(TP.gnn_minibatches(
            500, cfg.d_feat, 8, fanouts=(3, 2), n_classes=cfg.n_out,
            triplet_cap=4)), 1
    jp = JD.init_params(jcfg, jax.random.PRNGKey(0))
    tp = TD.params_from_numpy(cfg, jax.tree.map(np.asarray, jp),
                              device="cpu")
    return cfg, jcfg, jp, tp, batch, n_graphs


def _jax(batch):
    return {k: jnp.asarray(v) for k, v in batch.items()}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def test_params_carry_across_key_for_key(task):
    cfg, jcfg, jp, tp, _, _ = task
    ref = _ref_paths(jp)
    port = {path_key(p): t for p, t in leaves_with_path(tp)}
    assert sorted(ref) == sorted(port)
    for k, a in ref.items():
        np.testing.assert_array_equal(port[k].numpy(), a)
    own = TD.init_params(cfg, torch.Generator().manual_seed(0))
    for p, t in leaves_with_path(own):
        a = ref[path_key(p)]
        assert tuple(t.shape) == a.shape and t.dtype == torch.float32
        if a.size >= 1000:
            assert abs(float(t.std()) / float(a.std()) - 1) < 0.1
    bad = jax.tree.map(np.asarray, jp)
    bad["feat_proj"] = bad["feat_proj"][:-1]
    with pytest.raises(ValueError):
        TD.params_from_numpy(cfg, bad, device="cpu")


def test_forward_loss_and_every_gradient_match(task):
    cfg, jcfg, jp, tp, batch, ng = task
    out = TD.forward(tp, _torch(batch), cfg, n_graphs=ng)
    jout = JD.forward(jp, _jax(batch), jcfg, n_graphs=ng)
    assert out.dtype == torch.float32 and out.shape == jout.shape
    assert out.shape[0] == (ng if cfg.task == "graph_reg"
                            else batch["feats"].shape[0])
    _close(out, jout)
    (jl, _), jg = jax.value_and_grad(JD.loss_fn, has_aux=True)(
        jp, _jax(batch), jcfg, ng)
    req = [t.clone().requires_grad_(True) for _, t in leaves_with_path(tp)]
    tl, metrics = TD.loss_fn(unflatten(tp, req), _torch(batch), cfg, ng)
    assert metrics["loss"] is tl
    _close(tl, jl)
    ref = _ref_paths(jg)
    for (p, _), g in zip(leaves_with_path(tp), torch.autograd.grad(tl, req)):
        _close(g, ref[path_key(p)], of_scale=GRAD_OF_SCALE)


def test_remat_and_unroll_change_no_value(task):
    """The reference's `test_dimenet_remat_matches` (rtol 1e-6), on the
    port: equal loss and gradients, bit for bit."""
    cfg, _, _, tp, batch, ng = task
    grads = {}
    for c in (cfg, dataclasses.replace(cfg, remat=True),
              dataclasses.replace(cfg, unroll_blocks=True)):
        req = [t.clone().requires_grad_(True) for _, t in leaves_with_path(tp)]
        loss, _ = TD.loss_fn(unflatten(tp, req), _torch(batch), c, ng)
        grads[c] = (loss,) + torch.autograd.grad(loss, req)
    base = grads.pop(cfg)
    for c, gs in grads.items():
        assert all(torch.equal(a, b) for a, b in zip(base, gs)), c


def test_bases_match():
    """_rbf and _sbf alone, at the full config's sizes."""
    cfg = treg.get("dimenet").full_config("molecule")
    jcfg = jreg.get("dimenet").full_config("molecule")
    r = np.random.default_rng(3)
    d = (r.random(200) * 6).astype(np.float32)          # past the cutoff too
    theta = (r.random(200) * np.pi).astype(np.float32)
    _close(TD._rbf(torch.from_numpy(d), cfg.n_radial, cfg.cutoff),
           JD._rbf(jnp.asarray(d), jcfg.n_radial, jcfg.cutoff))
    _close(TD._sbf(torch.from_numpy(theta), torch.from_numpy(d), cfg),
           JD._sbf(jnp.asarray(theta), jnp.asarray(d), jcfg))


@pytest.mark.parametrize("shape", jreg.GNN_SHAPES)
def test_configs_equal_field_for_field(shape):
    jm, tm = jreg.get("dimenet"), treg.get("dimenet")
    assert (tm.ARCH_ID, tm.FAMILY, tm.SHAPES, tm.TRIPLET_CAP) == \
        (jm.ARCH_ID, jm.FAMILY, jm.SHAPES, jm.TRIPLET_CAP)
    assert tm.SHAPE_PARAMS == jm.SHAPE_PARAMS
    assert dataclasses.asdict(tm.full_config(shape)) == \
        dataclasses.asdict(jm.full_config(shape))
    assert dataclasses.asdict(tm.smoke_config()) == \
        dataclasses.asdict(jm.smoke_config())
    assert [(f.name, f.default) for f in dataclasses.fields(TD.DimeNetConfig)] \
        == [(f.name, f.default) for f in dataclasses.fields(JD.DimeNetConfig)]
