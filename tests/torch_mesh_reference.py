"""The JAX package's side of tests/test_torch_mesh.py, run as a script on 4
forced host devices:

    XLA_FLAGS=--xla_force_host_platform_device_count=4 JAX_PLATFORMS=cpu \\
        PYTHONPATH=src python tests/torch_mesh_reference.py OUT_DIR

It builds four 500-row deep_like shards and saves each (format 2) as
OUT_DIR/shard<s>, then runs `build_sharded_search` on a (2, 2) mesh at
W=1 and W=4 and on a one-device mesh over shard 0,
`serve_retrieval_shardmap` on bst's smoke config over a 4-way and a
1-way "model" axis, and `moe_ffn_shardmap` on a (2, 2) mesh at no-drop
and at the default capacity; inputs, weights and results go to
OUT_DIR/ref.pkl as numpy arrays.
"""
import dataclasses
import pickle
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh

from repro import configs as reg
from repro.core.index import KBest
from repro.core.sharded import build_sharded_search, make_sharded_arrays
from repro.core.types import BuildConfig, IndexConfig, SearchConfig
from repro.data.vectors import make_dataset
from repro.launch.mesh import mesh_context
from repro.layers import moe as MOE
from repro.models import recsys as R

N_SHARDS, N_LOCAL, N_QUERIES, K = 4, 500, 40, 10
SEARCH = dict(L=32, k=K, early_term=False, n_entries=1)
BUILD = dict(M=16, knn_k=24, builder="brute", refine_iters=0)
MOE_CFG = dict(n_experts=8, top_k=2, d_ff_expert=16, n_shared_experts=1)
MOE_D, MOE_T, NODROP = 16, 32, 8.0


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def main(out: Path) -> None:
    assert len(jax.devices()) == 4, jax.devices()
    res = {}
    mesh22 = jax.make_mesh((2, 2), ("data", "model"))
    mesh11 = Mesh(np.asarray(jax.devices()[:1]).reshape(1, 1),
                  ("data", "model"))
    mesh14 = Mesh(np.asarray(jax.devices()).reshape(1, 4),
                  ("data", "model"))

    # ---- the sharded graph search --------------------------------------
    ds = make_dataset("deep_like", n=N_SHARDS * N_LOCAL,
                      n_queries=N_QUERIES, k=K)
    cfg = IndexConfig(dim=ds.base.shape[1], metric=ds.metric,
                      build=BuildConfig(**BUILD),
                      search=SearchConfig(**SEARCH))
    dbs, graphs, entries = [], [], []
    for s in range(N_SHARDS):
        idx = KBest(cfg).add(ds.base[s * N_LOCAL:(s + 1) * N_LOCAL])
        idx.save(str(out / f"shard{s}"))
        dbs.append(np.asarray(idx.db))
        graphs.append(np.asarray(idx.graph))
        entries.append(int(idx.entry))
    db, graph = np.concatenate(dbs), np.concatenate(graphs)
    entries = np.asarray(entries, np.int32)
    res.update(queries=ds.queries, metric=ds.metric, search=SEARCH,
               n_local=N_LOCAL)
    for W in (1, 4):
        scfg = SearchConfig(**SEARCH, beam_width=W)
        fn = build_sharded_search(mesh22, scfg, ds.metric, N_LOCAL)
        d, i = fn(*make_sharded_arrays(mesh22, db, graph, entries,
                                       jnp.asarray(ds.queries)))
        res[f"search_W{W}"] = dict(d=np.asarray(d), i=np.asarray(i))
        fn1 = build_sharded_search(mesh11, scfg, ds.metric, N_LOCAL)
        d1, i1 = fn1(*make_sharded_arrays(mesh11, dbs[0], graphs[0],
                                          entries[:1],
                                          jnp.asarray(ds.queries)))
        res[f"search_p1_W{W}"] = dict(d=np.asarray(d1), i=np.asarray(i1))

    # ---- sharded retrieval ---------------------------------------------
    bcfg = reg.get("bst").smoke_config()
    bp = R.init_params(bcfg, jax.random.PRNGKey(0))
    hist = np.asarray(jax.random.randint(
        jax.random.PRNGKey(1), (6, bcfg.seq_len), 0, bcfg.n_items),
        np.int32)
    res.update(bst_cfg=dataclasses.asdict(bcfg), bst_params=_np(bp),
               bst_hist=hist, k=K)
    batch = {"hist": jnp.asarray(hist)}
    for name, mesh in (("retrieval_4", mesh14), ("retrieval_1", mesh11)):
        d, i = R.serve_retrieval_shardmap(bp, batch, bcfg, mesh, k=K)
        res[name] = dict(d=np.asarray(d), i=np.asarray(i))

    # ---- explicit-collective MoE ---------------------------------------
    cfg0 = MOE.MoEConfig(**MOE_CFG)
    cfg1 = dataclasses.replace(cfg0, ep_axis="data", tp_axis="model",
                               token_axes=("data",), use_shardmap=True,
                               ep_size=2, tp_size=2)
    p = MOE.init_moe(jax.random.PRNGKey(0), MOE_D, cfg0, dtype=jnp.float32)
    x = jax.random.normal(jax.random.PRNGKey(1), (MOE_T, MOE_D))
    g = jax.random.normal(jax.random.PRNGKey(2), (MOE_T, MOE_D))
    res.update(moe_cfg=dataclasses.asdict(cfg1), moe_params=_np(p),
               moe_x=np.asarray(x), moe_g=np.asarray(g),
               nodrop_factor=NODROP)
    with mesh_context(mesh22):
        for name, cf in (("moe_nodrop", NODROP),
                         ("moe_default", cfg1.capacity_factor)):
            c = dataclasses.replace(cfg1, capacity_factor=cf)
            o, a = jax.jit(lambda p, x, c=c: MOE.moe_ffn_shardmap(p, x, c))(
                p, x)
            res[name] = dict(out=np.asarray(o), aux=np.asarray(a))
    with open(out / "ref.pkl", "wb") as f:
        pickle.dump(res, f)


if __name__ == "__main__":
    main(Path(sys.argv[1]))
