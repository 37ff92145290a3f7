"""The port's training substrate (src/repro_torch/train, data/pipeline.py,
launch/train.py) against the JAX package's, on the same numpy inputs.

Optimizers: three updates on the same params, grads and state, on 0- to
3-D leaves, within `rtol=1e-6`. Compression: equal, and the reference's
two tests mirrored. Checkpoints: read both ways bit for bit (the format
is the reference's), atomic commit, pruning, async errors. Trainer: loss
falls on a deepfm smoke config, a resume after an injected failure equals
an uninterrupted run bit for bit (on the CPU), stragglers are counted, and
five steps equal the reference Trainer's within `atol=1e-5`. The seven
data streams yield equal arrays.
"""
import gc
import itertools
import os
import subprocess
import sys
import time
import weakref
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jreg
from repro.data import pipeline as JP
from repro.models import recsys as JR
from repro.train import checkpoint as JC
from repro.train import compress as JZ
from repro.train import loop as JLOOP
from repro.train import optimizer as JO
from repro_torch import configs as treg
from repro_torch.data import pipeline as TP
from repro_torch.models import recsys as TR
from repro_torch.train import checkpoint as TC
from repro_torch.train import compress as TZ
from repro_torch.train import loop as TLOOP
from repro_torch.train import optimizer as TO
from repro_torch.train.tree import (leaves, leaves_with_path, path_key,
                                    tree_map)
from torch_reference_cache import jax_maps_below_limit  # noqa: F401

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parents[1]
CPU = "cpu"


def _np_tree(tree):
    """{path: numpy} of either package's tree."""
    if any(isinstance(x, torch.Tensor) for _, x in leaves_with_path(tree)):
        return {path_key(p): x.detach().numpy()
                for p, x in leaves_with_path(tree)}
    flat, _ = jax.tree_util.tree_flatten_with_path(tree)
    return {"/".join(str(getattr(p, "key", getattr(p, "idx", p)))
                     for p in path): np.asarray(x) for path, x in flat}


def _assert_trees(port, ref, exact=False, leaf_rtol=None, **tol):
    """Leaf by leaf: bit-equal (`exact`), within `tol`, or within
    `leaf_rtol` of each value and of the leaf's largest magnitude (a sum
    that cancels keeps the absolute error of its terms, so its relative
    error grows without bound)."""
    a, b = _np_tree(port), _np_tree(ref)
    assert sorted(a) == sorted(b)
    for k in a:
        assert a[k].shape == b[k].shape, k
        if exact:
            assert a[k].dtype == b[k].dtype, (k, a[k].dtype, b[k].dtype)
            np.testing.assert_array_equal(a[k], b[k], err_msg=k)
        elif leaf_rtol is not None:
            scale = float(np.abs(b[k]).max()) if b[k].size else 0.0
            np.testing.assert_allclose(a[k], b[k], err_msg=k, rtol=leaf_rtol,
                                       atol=leaf_rtol * scale)
        else:
            np.testing.assert_allclose(a[k], b[k], err_msg=k, **tol)


def _leaf_shapes():
    return {"bias": (), "w1": (7,), "emb": {"t": (12, 5)},
            "mlp": [{"w": (3, 6, 4)}, {"w": (4, 1)}]}


def _draw(shapes, r, scale=1.0):
    def one(s):
        return np.asarray(scale * r.normal(size=s), np.float32)
    return jax.tree.map(one, shapes, is_leaf=lambda x: isinstance(x, tuple))


# --------------------------------------------------------------------------
# optimizers and compression
# --------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
@pytest.mark.parametrize("clip", [1.0, 100.0])
def test_optimizer_updates_match_reference(kind, clip):
    r = np.random.default_rng(0)
    shapes = _leaf_shapes()
    params = _draw(shapes, r)
    cfg_t = TO.OptConfig(kind=kind, lr=1e-2, grad_clip=clip)
    cfg_j = JO.OptConfig(kind=kind, lr=1e-2, grad_clip=clip)
    jp = jax.tree.map(jnp.asarray, params)
    tp = tree_map(torch.from_numpy, params)
    js, ts = JO.opt_init(jp, cfg_j), TO.opt_init(tp, cfg_t)
    _assert_trees(ts, js, exact=True)
    for step in range(3):
        grads = _draw(shapes, r, scale=0.5 + step)
        jp, js, jn = JO.opt_update(jax.tree.map(jnp.asarray, grads), js, jp,
                                   cfg_j)
        tp, ts, tn = TO.opt_update(tree_map(torch.from_numpy, grads), ts, tp,
                                   cfg_t)
        np.testing.assert_allclose(float(tn), float(jn), rtol=1e-6)
        _assert_trees(tp, jp, leaf_rtol=1e-6)
        _assert_trees(ts, js, leaf_rtol=1e-6)
    if kind == "adafactor":
        assert set(ts["v"]["emb"]["t"]) == {"vr", "vc"}
        assert set(ts["v"]["w1"]) == {"v"}
        assert ts["v"]["mlp"][0]["w"]["vc"].shape == (3, 4)


def test_adamw_and_adafactor_decrease_a_quadratic():
    for cfg, shape, steps in ((TO.OptConfig(lr=0.1, weight_decay=0.0), (4,),
                               60),
                              (TO.OptConfig(kind="adafactor", lr=0.3,
                                            weight_decay=0.0), (8, 4), 80)):
        params = {"w": torch.full(shape, 5.0)}
        state = TO.opt_init(params, cfg)
        for _ in range(steps):
            params, state, _ = TO.opt_update({"w": 2 * params["w"]}, state,
                                             params, cfg)
        assert float(params["w"].abs().max()) < 1.0


def test_compress_matches_reference():
    r = np.random.default_rng(1)
    shapes = _leaf_shapes()
    jr = JZ.init_residual(jax.tree.map(jnp.asarray, _draw(shapes, r)))
    tr = TZ.init_residual(tree_map(torch.from_numpy, _draw(shapes, r)))
    for step in range(3):
        g = _draw(shapes, r, scale=10.0 ** step)
        jq, jr = JZ.compress_decompress(jax.tree.map(jnp.asarray, g), jr)
        tq, tr = TZ.compress_decompress(tree_map(torch.from_numpy, g), tr)
        _assert_trees(tq, jq, rtol=1e-6, atol=1e-7 * 10.0 ** step)
        _assert_trees(tr, jr, rtol=1e-5, atol=1e-7 * 10.0 ** step)
    # round half to even, as jnp.round
    g = {"w": torch.tensor([127.0, 0.5, 1.5, -2.5, 63.5])}
    q, _ = TZ.compress_decompress(g, TZ.init_residual(g))
    torch.testing.assert_close(q["w"], torch.tensor([127.0, 0.0, 2.0, -2.0,
                                                     64.0]), rtol=0, atol=1e-5)


def test_grad_compression_error_feedback_converges():
    """The reference's test on the port: EF-int8 compressed updates reach
    the same optimum on a quadratic."""
    w = torch.full((16,), 3.0)
    res = TZ.init_residual({"w": w})
    for _ in range(300):
        gq, res = TZ.compress_decompress({"w": 2 * w}, res)
        w = w - 0.05 * gq["w"]
    assert float(w.abs().max()) < 1e-2


def test_grad_compression_bounded_error():
    """The reference's test on the port: half a bin of error at most, and
    the residual is what was lost."""
    rng = np.random.default_rng(0)
    g = {"w": torch.from_numpy(rng.normal(size=(64, 64)).astype(np.float32))}
    gq, res2 = TZ.compress_decompress(g, TZ.init_residual(g))
    scale = float(g["w"].abs().max()) / 127.0
    err = (gq["w"] - g["w"]).abs()
    assert float(err.max()) <= scale * 0.5 + 1e-6
    np.testing.assert_allclose(res2["w"].numpy(), (g["w"] - gq["w"]).numpy(),
                               rtol=1e-6)


# --------------------------------------------------------------------------
# checkpoints
# --------------------------------------------------------------------------
@pytest.fixture(scope="module")
def deepfm():
    jcfg = jreg.get("deepfm").smoke_config()
    cfg = treg.get("deepfm").smoke_config()
    jp = JR.init_params(jcfg, jax.random.PRNGKey(0))
    tp = TR.params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device=CPU)
    return cfg, jcfg, jp, tp


def _states(tree_j, tree_t, kind):
    """Both packages' optimizer states after one update of equal grads."""
    cj, ct = JO.OptConfig(kind=kind), TO.OptConfig(kind=kind)
    gj = jax.tree.map(lambda x: 0.1 * x + 0.01, tree_j)
    gt = tree_map(lambda x: 0.1 * x + 0.01, tree_t)
    _, sj, _ = JO.opt_update(gj, JO.opt_init(tree_j, cj), tree_j, cj)
    _, st, _ = TO.opt_update(gt, TO.opt_init(tree_t, ct), tree_t, ct)
    return sj, st


@pytest.mark.parametrize("kind", ["adamw", "adafactor"])
def test_checkpoints_read_both_ways_bit_for_bit(tmp_path, deepfm, kind):
    _, _, jp, tp = deepfm
    sj, st = _states(jp, tp, kind)
    ref_tree = {"params": jp, "opt": sj}
    port_tree = {"params": tp, "opt": st}
    # the reference writes, the port reads
    JC.save(str(tmp_path / "ref"), 4, ref_tree)
    back = TC.restore(str(tmp_path / "ref"), 4, port_tree, device=CPU)
    _assert_trees(back, ref_tree, exact=True)
    assert back["opt"]["count"].dtype == torch.int32
    # the port writes, the reference reads; the files' keys are equal
    TC.save(str(tmp_path / "port"), 4, port_tree)
    back_j = JC.restore(str(tmp_path / "port"), 4, ref_tree)
    _assert_trees(port_tree, back_j, exact=True)
    keys = [set(np.load(tmp_path / d / "step_00000004" / "arrays.npz").files)
            for d in ("ref", "port")]
    assert keys[0] == keys[1]
    assert "opt/v/mlp/0/w/vr" in keys[1] or kind == "adamw"


def test_checkpoint_bf16_leaves_both_ways(tmp_path):
    """The reference saves bf16 as raw 2-byte voids (ml_dtypes); the port
    reads their 16 bits and saves bf16 as f32, which the reference's
    restore casts back exactly."""
    x = np.random.default_rng(2).normal(size=(5, 3)).astype(np.float32)
    jt = {"w": jnp.asarray(x, dtype=jnp.bfloat16), "s": jnp.ones(())}
    tt = {"w": torch.from_numpy(x).to(torch.bfloat16), "s": torch.ones(())}
    JC.save(str(tmp_path / "ref"), 1, jt)
    back = TC.restore(str(tmp_path / "ref"), 1, tt, device=CPU)
    assert back["w"].dtype == torch.bfloat16
    assert torch.equal(back["w"], tt["w"])
    TC.save(str(tmp_path / "port"), 1, tt)
    back_j = JC.restore(str(tmp_path / "port"), 1, jt)
    assert back_j["w"].dtype == jnp.bfloat16
    np.testing.assert_array_equal(np.asarray(back_j["w"], np.float32),
                                  tt["w"].float().numpy())


def test_checkpoint_atomic_and_pruned(tmp_path):
    tree = {"a": torch.arange(10.0), "b": {"c": torch.ones((3, 3))}}
    assert TC.latest_step(str(tmp_path / "none")) is None
    for s in (1, 2, 3, 4, 5):
        TC.save(str(tmp_path), s, tree, keep_last=2)
    assert TC.latest_step(str(tmp_path)) == 5
    kept = sorted(tmp_path.glob("step_*"))
    assert [p.name for p in kept] == ["step_00000004", "step_00000005"]
    # a save killed before its commit leaves a tmp dir and no _DONE: it is
    # never the latest, and restoring it fails
    (tmp_path / ".tmp_step_00000006").mkdir()
    (tmp_path / "step_00000007").mkdir()
    assert TC.latest_step(str(tmp_path)) == 5
    with pytest.raises(AssertionError, match="incomplete"):
        TC.restore(str(tmp_path), 7, tree, device=CPU)
    back = TC.restore(str(tmp_path), 5, tree, device=CPU)
    assert torch.equal(back["a"], tree["a"])
    assert torch.equal(back["b"]["c"], tree["b"]["c"])
    with pytest.raises(AssertionError):
        TC.restore(str(tmp_path), 5, {"a": torch.zeros(3),
                                      "b": {"c": torch.ones((3, 3))}},
                   device=CPU)


def test_async_checkpointer_saves_and_raises_on_wait(tmp_path):
    ck = TC.AsyncCheckpointer(str(tmp_path / "ok"), keep_last=2)
    tree = {"w": torch.arange(6.0).reshape(2, 3)}
    ck.save(3, tree)
    tree["w"] += 1                    # the host copy was taken in save()
    ck.wait()
    back = TC.restore(str(tmp_path / "ok"), 3, tree, device=CPU)
    assert torch.equal(back["w"], torch.arange(6.0).reshape(2, 3))
    blocker = tmp_path / "file"
    blocker.write_text("not a directory")
    bad = TC.AsyncCheckpointer(str(blocker))
    bad.save(1, tree)
    with pytest.raises(OSError):
        bad.wait()
    bad.wait()                        # the error is raised once


# --------------------------------------------------------------------------
# the trainer
# --------------------------------------------------------------------------
def _port_loss(cfg):
    return lambda p, b: TR.loss_fn(p, b, cfg)


def test_trainer_loss_decreases(tmp_path, deepfm):
    cfg, _, _, tp = deepfm
    tr = TLOOP.Trainer(_port_loss(cfg), TO.OptConfig(lr=1e-2),
                       TLOOP.TrainerConfig(ckpt_dir=str(tmp_path),
                                           ckpt_every=100, log_every=1),
                       device=CPU)
    data = TP.Prefetcher(TP.ctr_batches(cfg.n_sparse, cfg.vocab_per_field,
                                        256))
    out = tr.fit(tp, data, n_steps=30)
    h = [x["loss"] for x in out["history"]]
    assert len(h) == 30 and all(np.isfinite(h))
    assert np.mean(h[-5:]) < np.mean(h[:5]) - 0.05, h
    assert TC.latest_step(str(tmp_path)) == 30


def test_resume_after_failure_equals_uninterrupted(tmp_path, deepfm):
    cfg, _, _, tp = deepfm
    opt = TO.OptConfig(lr=1e-2)

    def stream(start=0):
        return itertools.islice(TP.ctr_batches(cfg.n_sparse,
                                               cfg.vocab_per_field, 64),
                                start, None)

    def trainer(d, fail=-1):
        return TLOOP.Trainer(_port_loss(cfg), opt, TLOOP.TrainerConfig(
            ckpt_dir=str(d), ckpt_every=5, log_every=1, fail_at_step=fail),
            device=CPU)

    full = trainer(tmp_path / "full").fit(tp, stream(), n_steps=20)
    with pytest.raises(TLOOP.SimulatedFailure):
        trainer(tmp_path / "crash", fail=12).fit(tp, stream(), n_steps=20)
    assert TC.latest_step(str(tmp_path / "crash")) == 10
    resumed = trainer(tmp_path / "crash").fit(tp, stream(10), n_steps=20)
    assert resumed["history"][0]["step"] == 10
    _assert_trees(resumed["params"], full["params"], exact=True)
    _assert_trees(resumed["opt"], full["opt"], exact=True)
    assert [h["loss"] for h in resumed["history"]] == \
        [h["loss"] for h in full["history"][10:]]
    # the same state, restored onto another device (here the host again)
    like = {"params": tp, "opt": TO.opt_init(tp, opt)}
    moved = TLOOP.reshard_checkpoint(str(tmp_path / "crash"), 20, like, CPU)
    _assert_trees(moved["params"], full["params"], exact=True)


def test_donated_steps_equal_functional_steps(tmp_path, deepfm, monkeypatch):
    """donate=True (the reference's buffer donation) updates the params
    and AdamW moments in place, in slices (here of 1,000 elements, so the
    embedding tables take several), and gives the functional path's
    values bit for bit; the params given to `fit` are consumed."""
    cfg, _, _, tp = deepfm
    monkeypatch.setattr(TO, "_DONATE_CHUNK", 1000)
    assert max(t.numel() for t in leaves(tp)) > 3 * 1000
    outs = {}
    for donate in (False, True):
        mine = tree_map(torch.clone, tp)
        tr = TLOOP.Trainer(_port_loss(cfg), TO.OptConfig(lr=1e-2),
                           TLOOP.TrainerConfig(ckpt_dir=str(tmp_path / str(
                               donate)), ckpt_every=3, log_every=1),
                           device=CPU, donate=donate)
        out = tr.fit(mine, TP.ctr_batches(cfg.n_sparse, cfg.vocab_per_field,
                                          32), n_steps=5)
        outs[donate] = (mine, out)
    (kept, func), (given, don) = outs[False], outs[True]
    _assert_trees(don["params"], func["params"], exact=True)
    _assert_trees(don["opt"], func["opt"], exact=True)
    assert [h["loss"] for h in don["history"]] == \
        [h["loss"] for h in func["history"]]
    _assert_trees(kept, tp, exact=True)             # functional: untouched
    assert all(a.data_ptr() == b.data_ptr() for a, b in
               zip(leaves(given), leaves(don["params"])))
    # the checkpoint written mid-run holds step 3's state, not a later one
    back = TC.restore(str(tmp_path / "True"), 3, {"params": tp,
                                                  "opt": func["opt"]}, CPU)
    mid = TC.restore(str(tmp_path / "False"), 3, {"params": tp,
                                                  "opt": func["opt"]}, CPU)
    _assert_trees(back, mid, exact=True)


def test_straggler_detection(tmp_path, deepfm):
    cfg, _, _, tp = deepfm
    tr = TLOOP.Trainer(_port_loss(cfg), TO.OptConfig(lr=1e-3),
                       TLOOP.TrainerConfig(ckpt_dir=str(tmp_path),
                                           ckpt_every=1000,
                                           straggler_kappa=1.5), device=CPU)
    base = TP.ctr_batches(cfg.n_sparse, cfg.vocab_per_field, 8)

    def gen():
        for i, b in enumerate(base):
            if i == 12:
                time.sleep(0.5)   # inject a straggler step
            yield b
    out = tr.fit(tp, gen(), n_steps=16)
    assert out["stragglers"] >= 1


def test_trainer_frees_each_step_without_the_cycle_collector(tmp_path,
                                                             deepfm):
    """A step's params and optimizer state die when the next step replaces
    them, by reference counting alone: at 10^6 ids a field a tree is GBs,
    and one left to the cyclic collector stays alive for several steps."""
    cfg, _, _, tp = deepfm
    tr = TLOOP.Trainer(_port_loss(cfg), TO.OptConfig(lr=1e-3),
                       TLOOP.TrainerConfig(ckpt_dir=str(tmp_path),
                                           ckpt_every=1000), device=CPU)
    refs, inner = [], tr.step_fn

    def step_fn(params, opt_state, batch):
        out = inner(params, opt_state, batch)
        refs.append([weakref.ref(t) for t in leaves(out[:2])])
        return out
    tr.step_fn = step_fn
    gc.collect()
    gc.disable()
    try:
        out = tr.fit(tp, TP.ctr_batches(cfg.n_sparse, cfg.vocab_per_field, 8),
                     n_steps=4)
        alive = [sum(r() is not None for r in step) for step in refs]
    finally:
        gc.enable()
    assert alive[:-1] == [0, 0, 0] and alive[-1] == len(refs[-1]), alive


def test_five_steps_match_reference_trainer(tmp_path, deepfm):
    cfg, jcfg, jp, tp = deepfm
    n = 5
    jtr = JLOOP.Trainer(lambda p, b: JR.loss_fn(p, b, jcfg),
                        JO.OptConfig(lr=1e-2),
                        JLOOP.TrainerConfig(ckpt_dir=str(tmp_path / "j"),
                                            ckpt_every=100, log_every=1),
                        donate=False)
    jout = jtr.fit(jp, JP.ctr_batches(cfg.n_sparse, cfg.vocab_per_field, 32),
                   n_steps=n)
    ttr = TLOOP.Trainer(_port_loss(cfg), TO.OptConfig(lr=1e-2),
                        TLOOP.TrainerConfig(ckpt_dir=str(tmp_path / "t"),
                                            ckpt_every=100, log_every=1),
                        device=CPU)
    tout = ttr.fit(tp, TP.ctr_batches(cfg.n_sparse, cfg.vocab_per_field, 32),
                   n_steps=n)
    np.testing.assert_allclose([h["loss"] for h in tout["history"]],
                               [h["loss"] for h in jout["history"]],
                               rtol=0, atol=1e-5)
    _assert_trees(tout["params"], jout["params"], rtol=0, atol=1e-5)
    _assert_trees(tout["opt"], jout["opt"], rtol=1e-4, atol=1e-7)
    # and each package restores the other's final checkpoint
    back = TC.restore(str(tmp_path / "j"), n, {"params": tp,
                                               "opt": tout["opt"]}, CPU)
    _assert_trees(back["params"], jout["params"], exact=True)


# --------------------------------------------------------------------------
# data streams
# --------------------------------------------------------------------------
STREAMS = {
    "lm": lambda M: M.lm_batches(50, 4, 9),
    "lm_unstructured": lambda M: M.lm_batches(50, 4, 9, structured=False),
    "ctr": lambda M: M.ctr_batches(5, 1000, 8, seed=3),
    "seq_bst": lambda M: M.seq_batches("bst", 500, 4, 6),
    "seq_bert4rec": lambda M: M.seq_batches("bert4rec", 500, 4, 12, seed=1),
    "gnn": lambda M: M.gnn_minibatches(300, 4, 4, fanouts=(3, 2),
                                       n_classes=5, triplet_cap=3),
    "molecule": lambda M: M.molecule_batches(6, 12, 2, 3, triplet_cap=3),
    "prefetched_ctr": lambda M: M.Prefetcher(M.ctr_batches(4, 100, 16,
                                                           host_id=1,
                                                           n_hosts=2)),
}


@pytest.mark.parametrize("name", sorted(STREAMS))
def test_streams_equal_reference(name):
    ours, ref = STREAMS[name](TP), STREAMS[name](JP)
    for _ in range(3):
        a, b = next(ours), next(ref)
        assert sorted(a) == sorted(b)
        for k in a:
            assert a[k].dtype == b[k].dtype, (name, k)
            np.testing.assert_array_equal(a[k], b[k], err_msg=f"{name} {k}")


def test_graph_helpers_equal_reference():
    a = TP.synthetic_graph(400, 6, seed=2)
    b = JP.synthetic_graph(400, 6, seed=2)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x, y)
    seeds = np.array([0, 5, 399], np.int64)
    np.testing.assert_array_equal(
        TP.sample_neighbors(*a, seeds, 4, np.random.default_rng(0)),
        JP.sample_neighbors(*b, seeds, 4, np.random.default_rng(0)))


# --------------------------------------------------------------------------
# the launcher
# --------------------------------------------------------------------------
def test_launch_train_smoke_on_cpu(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch",
           "deepfm", "--smoke", "--steps", "10", "--device", "cpu",
           "--ckpt", str(tmp_path / "ck")]
    res = subprocess.run(cmd, env=env, capture_output=True, text=True,
                         timeout=120)
    assert res.returncode == 0, res.stderr
    losses = [float(l.split("loss")[1]) for l in res.stdout.splitlines()
              if l.startswith("step")]
    assert len(losses) == 2 and all(np.isfinite(losses))
    assert "family=recsys" in res.stdout
    # the LM and GNN archs, once refused (exit 2), train too
    for arch, family in (("gemma-2b", "lm"), ("dimenet", "gnn")):
        res = subprocess.run(
            cmd[:4] + [arch, "--smoke", "--steps", "6", "--batch", "2",
                       "--seq", "16", "--device", "cpu", "--ckpt",
                       str(tmp_path / arch)],
            env=env, capture_output=True, text=True, timeout=120)
        assert res.returncode == 0, res.stderr
        losses = [float(l.split("loss")[1]) for l in res.stdout.splitlines()
                  if l.startswith("step")]
        assert len(losses) == 2 and all(np.isfinite(losses)), arch
        assert f"family={family}" in res.stdout
