"""The rank program of the port's multi-rank tests (tests/test_torch_mesh.py,
and the model case of tests/test_torch_lm.py): `spawn(case, inputs)` runs
`CASES[case](inputs)` on `world` ranks of one host (4 gloo processes;
with device_type="cuda" NCCL, one card a rank, TF32 off), started with
the spawn method over a `file://` store in a temporary directory, and
returns each rank's result (a dict of numpy arrays). Only the port is
imported here, so the ranks start without jax.
"""
import dataclasses
import os
import pickle
import tempfile

import numpy as np
import torch
import torch.multiprocessing as mp

WORLD = 4
TIMEOUT_S = 120


def spawn(case: str, inputs: dict, world: int = WORLD,
          device_type: str = "cpu") -> list:
    with tempfile.TemporaryDirectory() as tmp:
        with open(os.path.join(tmp, "in.pkl"), "wb") as f:
            pickle.dump(inputs, f)
        mp.spawn(_rank_main, args=(world, tmp, case, device_type),
                 nprocs=world, join=True)
        out = []
        for r in range(world):
            with open(os.path.join(tmp, f"out{r}.pkl"), "rb") as f:
                out.append(pickle.load(f))
        return out


def _rank_main(rank: int, world: int, tmp: str, case: str,
               device_type: str) -> None:
    from repro_torch.launch.mesh import process_group
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    with open(os.path.join(tmp, "in.pkl"), "rb") as f:
        inputs = pickle.load(f)
    inputs["device_type"] = device_type
    with process_group(device_type, rank=rank, world_size=world,
                       init_file=os.path.join(tmp, "store"),
                       timeout_s=TIMEOUT_S):
        out = CASES[case](inputs)
    with open(os.path.join(tmp, f"out{rank}.pkl"), "wb") as f:
        pickle.dump(out, f)


def _np(t):
    return t.detach().cpu().numpy()


def _mesh(inp, shape):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(inp["device_type"], shape,
                            mesh_dim_names=("data", "model"))


def _on(mesh, a):
    from repro_torch.launch.mesh import mesh_device
    return torch.as_tensor(a, device=mesh_device(mesh))


# --------------------------------------------------------------------------
# the cases
# --------------------------------------------------------------------------
def corpus(inp, n=None):
    """(db, graph) of the four shards' concatenation, or its first n rows
    with the last shard's edges past them cut (an uneven corpus laid out
    tail-short)."""
    db, graph = inp["db"], inp["graph"]
    if n is None:
        return db, graph
    last = 3 * inp["n_local"]
    tail = graph[last:n]
    return db[:n], np.concatenate([graph[:last], np.where(
        tail >= n - last, np.int32(-1), tail)])


def search_case(mesh, inp, W, n=None) -> dict:
    """build_sharded_search over corpus(inp, n)."""
    from repro_torch.core.sharded import (build_sharded_search,
                                          make_sharded_arrays)
    from repro_torch.core.types import SearchConfig
    db, graph = corpus(inp, n)
    cfg = SearchConfig(**inp["search"], beam_width=W)
    arrays = make_sharded_arrays(mesh, db, graph, inp["entries"],
                                 inp["queries"])
    fn = build_sharded_search(mesh, cfg, inp["metric"], inp["n_local"])
    d, i = fn(*arrays)
    return dict(d=_np(d), i=_np(i), db=_np(arrays[0]), graph=_np(arrays[1]),
                entry=_np(arrays[2]))


def retrieval_case(mesh, inp, use_kernel) -> dict:
    from repro_torch.launch.mesh import mesh_device
    from repro_torch.models import recsys as R
    cfg = inp["bst_cfg"]
    params = R.params_from_numpy(cfg, inp["bst_params"],
                                 device=mesh_device(mesh))
    batch = {"hist": _on(mesh, inp["bst_hist"])}
    d, i = R.serve_retrieval_shardmap(params, batch, cfg, mesh, k=inp["k"],
                                      use_kernel=use_kernel)
    return dict(d=_np(d), i=_np(i))


def moe_case(mesh, inp, capacity_factor, grads) -> dict:
    """moe_ffn_shardmap on this rank's token row and weight blocks; with
    grads, the gradient of <out, g> + aux for every local input."""
    from repro_torch.launch.mesh import mesh_axis, mesh_context
    from repro_torch.layers import moe as MOE
    cfg = dataclasses.replace(inp["moe_cfg"], capacity_factor=capacity_factor)
    params = {k: _on(mesh, v) for k, v in inp["moe_params"].items()}
    x, g = (_on(mesh, inp[k]) for k in ("moe_x", "moe_g"))
    with mesh_context(mesh):
        r = mesh_axis(mesh, cfg.ep_axis).index
        rows = x.shape[0] // cfg.ep_size
        local = MOE.local_moe_params(params, cfg)
        leaves = {k: v.clone().requires_grad_(grads)
                  for k, v in local.items()}
        leaves["x"] = x[r * rows:(r + 1) * rows].clone().requires_grad_(
            grads)
        out, aux = MOE.moe_ffn_shardmap(
            {k: v for k, v in leaves.items() if k != "x"}, leaves["x"], cfg)
        res = dict(out=_np(out), aux=_np(aux))
        if grads:
            loss = torch.sum(out * g[r * rows:(r + 1) * rows]) + aux
            names = sorted(leaves)
            for k, t in zip(names, torch.autograd.grad(
                    loss, [leaves[k] for k in names])):
                res["grad:" + k] = _np(t)
    return res


def mesh_cases(inp) -> dict:
    """Every multi-rank case of tests/test_torch_mesh.py."""
    from repro_torch.launch.mesh import mesh_axis
    mesh = _mesh(inp, (2, 2))
    out = {"coord": np.asarray(mesh.get_coordinate())}
    for W in (1, 4):
        out[f"search_W{W}"] = search_case(mesh, inp, W)
    out["uneven"] = search_case(mesh, inp, 4, n=inp["n_uneven"])
    for shape in ((1, 4), (4, 1)):
        m = _mesh(inp, shape)
        out[f"retrieval_{shape}"] = dict(
            n=mesh_axis(m, "model").size,
            plain=retrieval_case(m, inp, False),
            kernel=retrieval_case(m, inp, True))
    out["moe_nodrop"] = moe_case(mesh, inp, inp["nodrop_factor"], True)
    out["moe_default"] = moe_case(mesh, inp, inp["moe_cfg"].capacity_factor,
                                  False)
    return out


def p1_cases(inp) -> dict:
    """The one-rank cases: make_test_mesh itself, build_sharded_search over
    shard 0 alone at W=1 and W=4, serve_retrieval_shardmap."""
    from repro_torch.core.sharded import mesh_size
    from repro_torch.launch.mesh import make_test_mesh, mesh_flat
    mesh = make_test_mesh(inp["device_type"])
    out = dict(shape=tuple(mesh.shape), names=mesh.mesh_dim_names,
               device_type=mesh.device_type, size=mesh_size(mesh),
               flat=mesh_flat(mesh).size)
    n = inp["n_local"]
    shard0 = dict(inp, db=inp["db"][:n], graph=inp["graph"][:n],
                  entries=inp["entries"][:1])
    for W in (1, 4):
        out[f"search_W{W}"] = search_case(mesh, shard0, W)
    out["retrieval"] = dict(plain=retrieval_case(mesh, inp, False),
                            kernel=retrieval_case(mesh, inp, True))
    return out


def lm_shardmap(inp) -> dict:
    """A MoE LM with use_shardmap on a (2, 2) mesh: this rank's batch row
    through forward and loss_fn (its expert blocks of the same params)."""
    from repro_torch.launch.mesh import mesh_axis, mesh_context, mesh_device
    from repro_torch.layers import moe as MOE
    from repro_torch.models import transformer as T
    cfg = inp["cfg"]
    mesh = _mesh(inp, (2, 2))
    params = T.params_from_numpy(cfg, inp["params"],
                                 device=mesh_device(mesh))
    with mesh_context(mesh):
        r = mesh_axis(mesh, cfg.moe.ep_axis).index
        params["layers"]["moe"] = MOE.local_moe_params(
            params["layers"]["moe"], cfg.moe)
        toks = _on(mesh, inp["tokens"][r:r + 1])
        logits, aux = T.forward(params, toks[:, :-1], cfg)
        loss, m = T.loss_fn(params, {"tokens": toks}, cfg)
    return dict(logits=_np(logits), aux=_np(aux), loss=_np(loss),
                nll=_np(m["nll"]))


def lm_inputs() -> dict:
    """lm_shardmap's inputs: llama4-scout's smoke config with use_shardmap
    on (2, 2) at no-drop capacity (factor 64), seeded params, tokens
    (B=2: one row a data rank, S+1=17)."""
    from repro_torch import configs as reg
    from repro_torch.models import transformer as T
    from repro_torch.train.tree import tree_map
    cfg = reg.get("llama4_scout_17b_a16e").smoke_config()
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=64.0, ep_axis="data", tp_axis="model",
        token_axes=("data",), use_shardmap=True, ep_size=2, tp_size=2))
    params = T.init_params(cfg, torch.Generator().manual_seed(0))
    toks = np.random.default_rng(9).integers(0, cfg.vocab, (2, 17))
    return dict(cfg=cfg, params=tree_map(lambda t: t.numpy(), params),
                tokens=toks.astype(np.int32))


CASES = {"mesh_cases": mesh_cases, "p1_cases": p1_cases,
         "lm_shardmap": lm_shardmap}
