"""The LM and GNN families on the card (`cuda`-marked; each test skips
without a CUDA device, and this file imports no JAX).

Each of the six smoke configs on the card against the port on the host
with the same parameters, f32 with TF32 off: forward, loss, every
gradient leaf, prefill and four decode steps (LM), within the CPU tests'
bounds (rtol 1e-5; an atol of 3e-6 of each output's largest magnitude,
2e-5 of each gradient leaf's); the MoE archs' routing, kept sets and
slots equal. And the card's in-place decode cache.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro_torch import configs as reg
from repro_torch.data.pipeline import gnn_minibatches, molecule_batches
from repro_torch.layers import moe as MOE
from repro_torch.models import dimenet as D
from repro_torch.models import transformer as T
from repro_torch.train.tree import (leaves_with_path, to_tensor, tree_map,
                                    unflatten)

LM_ARCHS = ("qwen2_5_14b", "chatglm3_6b", "gemma_2b", "kimi_k2_1t_a32b",
            "llama4_scout_17b_a16e")
RTOL, OF_SCALE, GRAD_OF_SCALE = 1e-5, 3e-6, 2e-5


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _close(card, host, of_scale=OF_SCALE):
    a, b = card.detach().float().cpu(), host.detach().float()
    scale = float(b.abs().max()) if b.numel() else 0.0
    np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=RTOL,
                               atol=of_scale * scale)


def _lm_outputs(cfg, params, toks):
    out = {"logits": T.forward(params, toks[:, :-1], cfg)[0]}
    req = [t.clone().requires_grad_(True) for _, t in leaves_with_path(params)]
    out["loss"], m = T.loss_fn(unflatten(params, req), {"tokens": toks}, cfg)
    out["aux"] = m["aux"]
    out["grads"] = torch.autograd.grad(out["loss"], req)
    out["prefill"], pc = T.prefill(params, toks[:, :9], cfg)
    out["prefill_k"] = pc["k"]
    cache = T.init_cache(cfg, 2, 16, dtype=torch.float32, device=toks.device)
    steps = []
    for s in range(4):
        lg, cache = T.decode_step(params, cache, toks[:, s:s + 1], cfg)
        steps.append(lg)
    out["decode"] = torch.cat(steps, dim=1)
    out["cache_k"], out["cache_v"] = cache["k"], cache["v"]
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("name", LM_ARCHS)
def test_cuda_lm_matches_host(cuda, name):
    cfg = reg.get(name).smoke_config()
    host = T.init_params(cfg, torch.Generator().manual_seed(0))
    card = tree_map(lambda t: t.to(cuda), host)
    toks = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab, (2, 17)).astype(np.int32))
    h = _lm_outputs(cfg, host, toks)
    c = _lm_outputs(cfg, card, toks.to(cuda))
    assert c["logits"].is_cuda and c["cache_k"].is_cuda
    for k in ("logits", "loss", "aux", "prefill", "prefill_k", "decode",
              "cache_k", "cache_v"):
        _close(c[k], h[k])
    for a, b in zip(c["grads"], h["grads"]):
        _close(a, b, GRAD_OF_SCALE)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["kimi_k2_1t_a32b", "llama4_scout_17b_a16e"])
def test_cuda_moe_kept_sets_equal_host(cuda, name):
    cfg = reg.get(name).smoke_config()
    params = T.init_params(cfg, torch.Generator().manual_seed(1))
    p0 = {k: t[0] for k, t in params["layers"]["moe"].items()}
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(64, cfg.d_model)).astype(np.float32))
    C = MOE.capacity(64, cfg.moe)
    got = []
    for dev in ("cpu", cuda):
        _, w, eidx = MOE.route(tree_map(lambda t: t.to(dev), p0),
                               x.to(dev), cfg.moe)
        dp = MOE.dispatch(w, eidx, cfg.moe.n_experts, C)
        got.append([eidx.cpu(), dp.keep.cpu(), dp.slot.cpu(),
                    dp.buf_tok.cpu()])
    assert all(torch.equal(a, b) for a, b in zip(*got))


@pytest.mark.cuda
@pytest.mark.parametrize("task", ["node_clf", "graph_reg"])
def test_cuda_dimenet_matches_host(cuda, task):
    cfg = reg.get("dimenet").smoke_config()
    if task == "graph_reg":
        cfg = dataclasses.replace(cfg, task=task, n_out=1)
        batch, ng = next(molecule_batches(6, 12, 4, cfg.d_feat)), 4
    else:
        batch, ng = next(gnn_minibatches(500, cfg.d_feat, 8, (3, 2),
                                         cfg.n_out, triplet_cap=4)), 1
    host = D.init_params(cfg, torch.Generator().manual_seed(0))
    res = []
    for dev in ("cpu", cuda):
        p = tree_map(lambda t: t.to(dev), host)
        b = {k: to_tensor(v, dev) for k, v in batch.items()}
        req = [t.clone().requires_grad_(True) for _, t in leaves_with_path(p)]
        loss, _ = D.loss_fn(unflatten(p, req), b, cfg, ng)
        res.append((D.forward(p, b, cfg, ng), loss,
                    torch.autograd.grad(loss, req)))
    (hf, hl, hg), (cf, cl, cg) = res
    _close(cf, hf)
    _close(cl, hl)
    for a, b in zip(cg, hg):
        _close(a, b, GRAD_OF_SCALE)


@pytest.mark.cuda
def test_cuda_decode_writes_the_cache_in_place(cuda):
    cfg = dataclasses.replace(reg.get("gemma_2b").smoke_config(),
                              dtype="bfloat16")
    params = T.init_params(cfg, torch.Generator(device=cuda).manual_seed(0))
    cache = T.init_cache(cfg, 3, 8)
    assert cache["k"].is_cuda and cache["k"].dtype == torch.bfloat16
    ptr = cache["k"].data_ptr()
    tok = torch.zeros((3, 1), dtype=torch.long, device=cuda)
    lg, cache = T.decode_step(params, cache, tok, cfg)
    assert cache["k"].data_ptr() == ptr and int(cache["len"][0]) == 1
    assert bool(cache["k"][:, :, 0].any()) and not bool(cache["k"][:, :, 1:]
                                                        .any())
    assert lg.dtype == torch.float32 and bool(torch.isfinite(lg).all())
