"""The port's device mesh and its collectives (repro_torch.launch.mesh, the
mesh lowering of core/sharded.py, models/recsys.serve_retrieval_shardmap,
layers/moe.moe_ffn_shardmap) against the JAX package's, on the CPU.

Multi-rank cases run on 4 gloo ranks and the one-rank cases on one
(tests/torch_mesh_ranks.py: no process group is made in a test worker);
the reference's side runs on 4 forced host devices in a subprocess
(tests/torch_mesh_reference.py), which builds four 500-row deep_like
shards and saves them (format 2) for the port to load. Both are computed
once a session (a file lock: every xdist worker would run them otherwise).
What must hold:
- the mesh builders' shapes and names ((1, 1) here; (16, 16) and
  (2, 16, 16) under the `fake` process group); a shardmap call with no
  ambient mesh raises;
- `build_sharded_search` at P=1 equals `search` on the same arrays (ids
  and distances), and the reference's ids on the same shard; on a (2, 2)
  mesh at W=1 and W=4 the reference's ids (tie-aware:
  tests/test_torch_parity.py) and exactly the port's one-process merge of
  the four local searches; an uneven corpus pads with sentinels that
  never surface;
- `serve_retrieval_shardmap` over a 1-way and a 4-way axis equals
  `serve_retrieval` (distances rtol 1e-5, ids equal) and the reference's
  ids, on the plain path and on `batch_dist`'s;
- `moe_ffn_shardmap` on (2, 2) at no-drop capacity: the forward and every
  gradient equal `moe_ffn`'s (rtol 1e-5 with atol 3e-6 of scale,
  gradients 2e-5, tests/test_torch_lm.py's bounds), the forward and aux
  the reference's; at the default capacity (drops happen) the reference's.
`cuda`-marked: the P=1 cases over NCCL on one card with the kernels.
This file imports no JAX.
"""
import dataclasses
import fcntl
import os
import pickle
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import search as tsearch
from repro_torch.core.build import stable_topk_smallest
from repro_torch.core.index import KBest
from repro_torch.core.sharded import (build_sharded_search,
                                      make_sharded_arrays,
                                      pad_to_shard_boundary)
from repro_torch.core.types import SearchConfig
from repro_torch.launch import mesh as M
from repro_torch.layers import moe as MOE
from repro_torch.models import recsys as R
from repro_torch.train.tree import tree_map
from test_torch_parity import assert_same_ranking
import torch_mesh_ranks

torch.set_num_threads(1)

HERE = Path(__file__).resolve().parent
RTOL, ATOL_OF_SCALE, GRAD_OF_SCALE = 1e-5, 3e-6, 2e-5
N_UNEVEN = 1998                  # 4 shards of 500, the last 498 rows


def _close(out, exp, rtol=RTOL, of_scale=ATOL_OF_SCALE):
    out, exp = np.asarray(out, np.float32), np.asarray(exp, np.float32)
    assert out.shape == exp.shape, (out.shape, exp.shape)
    scale = float(np.abs(exp).max()) if exp.size else 0.0
    np.testing.assert_allclose(out, exp, rtol=rtol, atol=of_scale * scale)


def _shared_dir(tmp_path_factory) -> Path:
    """A directory every xdist worker of this session sees (the parent of
    the workers' base temp dirs), or this process's own."""
    base = tmp_path_factory.getbasetemp()
    if os.environ.get("PYTEST_XDIST_WORKER"):
        base = base.parent
    d = base / "torch_mesh"
    d.mkdir(exist_ok=True)
    return d


def _shards(d: Path):
    return [KBest.load(str(d / f"shard{s}"), device="cpu") for s in range(4)]


def _rank_inputs(ref: dict, shards) -> dict:
    return dict(db=np.concatenate([s.db.numpy() for s in shards]),
                graph=np.concatenate([s.graph.numpy() for s in shards]),
                entries=np.asarray([s.entry for s in shards], np.int32),
                queries=ref["queries"], metric=ref["metric"],
                search=ref["search"], n_local=ref["n_local"],
                n_uneven=N_UNEVEN,
                bst_cfg=R.RecsysConfig(**ref["bst_cfg"]),
                bst_params=ref["bst_params"], bst_hist=ref["bst_hist"],
                k=ref["k"], moe_cfg=MOE.MoEConfig(**ref["moe_cfg"]),
                moe_params=ref["moe_params"], moe_x=ref["moe_x"],
                moe_g=ref["moe_g"], nodrop_factor=ref["nodrop_factor"])


@pytest.fixture(scope="session")
def runs(tmp_path_factory):
    """The reference's subprocess and the port's 4 ranks, once a session:
    {"ref", "port" (one dict a rank), "inp", "shards"}."""
    d = _shared_dir(tmp_path_factory)
    with open(d / "lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if not (d / "port.pkl").exists():
            env = dict(os.environ, JAX_PLATFORMS="cpu",
                       XLA_FLAGS="--xla_force_host_platform_device_count=4",
                       PYTHONPATH=str(HERE.parent / "src"))
            res = subprocess.run(
                [sys.executable, str(HERE / "torch_mesh_reference.py"),
                 str(d)], env=env, capture_output=True, text=True,
                timeout=600)
            assert res.returncode == 0, res.stderr[-4000:]
            with open(d / "ref.pkl", "rb") as f:
                ref = pickle.load(f)
            inp = _rank_inputs(ref, _shards(d))
            port = dict(ranks=torch_mesh_ranks.spawn("mesh_cases", inp),
                        p1=torch_mesh_ranks.spawn("p1_cases", inp,
                                                  world=1)[0])
            with open(d / "port.pkl", "wb") as f:
                pickle.dump(port, f)
    with open(d / "ref.pkl", "rb") as f:
        ref = pickle.load(f)
    with open(d / "port.pkl", "rb") as f:
        port = pickle.load(f)
    shards = _shards(d)
    return dict(ref=ref, port=port["ranks"], p1=port["p1"], shards=shards,
                inp=_rank_inputs(ref, shards))


# --------------------------------------------------------------------------
# the mesh builders
# --------------------------------------------------------------------------
def _run_port(code: str) -> None:
    """code in a fresh interpreter with the port on its path (process
    groups stay out of the test workers)."""
    env = dict(os.environ, PYTHONPATH=str(HERE.parent / "src"))
    res = subprocess.run([sys.executable, "-c", code], env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr[-4000:]


def test_make_test_mesh_cpu(runs):
    p1 = runs["p1"]
    assert p1["shape"] == (1, 1) and p1["size"] == 1 and p1["flat"] == 1
    assert p1["names"] == ("data", "model") and p1["device_type"] == "cpu"


@pytest.mark.parametrize("multi_pod,shape,names", [
    (False, (16, 16), ("data", "model")),
    (True, (2, 16, 16), ("pod", "data", "model"))])
def test_production_meshes_under_fake_group(multi_pod, shape, names):
    _run_port(f"""
import torch.distributed as dist
from torch.testing._internal.distributed.fake_pg import FakeStore
from repro_torch.core.sharded import mesh_size
from repro_torch.launch.mesh import make_production_mesh
dist.init_process_group("fake", store=FakeStore(), rank=0,
                        world_size={int(np.prod(shape))})
mesh = make_production_mesh(multi_pod={multi_pod}, device_type="cpu")
assert mesh.shape == {shape!r} and mesh.mesh_dim_names == {names!r}
assert mesh_size(mesh) == {int(np.prod(shape))}
dist.destroy_process_group()
""")


def test_import_creates_no_group():
    _run_port("import torch.distributed as dist, repro_torch.launch.mesh, "
              "repro_torch.layers.moe, repro_torch.core.sharded; "
              "assert not dist.is_initialized()")


def test_shardmap_without_a_mesh_raises():
    from repro_torch import configs as reg
    from repro_torch.models import transformer as T
    cfg = MOE.MoEConfig(n_experts=4, top_k=2, d_ff_expert=8,
                        ep_axis="data", tp_axis="model", use_shardmap=True,
                        ep_size=1, tp_size=1)
    p = MOE.init_moe(torch.Generator().manual_seed(0), 8, cfg)
    with pytest.raises(RuntimeError, match="mesh_context"):
        MOE.moe_ffn_shardmap(p, torch.zeros((4, 8)), cfg)
    lm = reg.get("llama4_scout_17b_a16e").smoke_config()
    lm = dataclasses.replace(lm, moe=dataclasses.replace(
        lm.moe, ep_axis="data", tp_axis="model", use_shardmap=True,
        ep_size=1, tp_size=1))
    tp = T.init_params(lm, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="mesh_context"):
        T.forward(tp, torch.zeros((1, 4), dtype=torch.int32), lm)


def test_ranks_lie_row_major(runs):
    coords = [tuple(r["coord"]) for r in runs["port"]]
    assert coords == [(0, 0), (0, 1), (1, 0), (1, 1)]


# --------------------------------------------------------------------------
# the sharded graph search
# --------------------------------------------------------------------------
@pytest.mark.parametrize("W", [1, 4])
def test_sharded_search_p1_equals_search_and_reference(runs, W):
    """The port of tests/test_sharding.py::test_distributed_search_parity:
    at P=1 (one gloo rank, make_test_mesh) the merge is the identity."""
    s0 = runs["shards"][0]
    inp = runs["inp"]
    cfg = SearchConfig(**inp["search"], beam_width=W)
    out = runs["p1"][f"search_W{W}"]
    assert np.array_equal(out["db"], s0.db.numpy())
    assert np.array_equal(out["graph"], s0.graph.numpy())
    d_loc, i_loc, _ = tsearch.search(
        s0.graph, torch.from_numpy(inp["queries"]),
        torch.tensor([s0.entry], dtype=torch.int32),
        dist_fn=tsearch.make_dist_fn(s0.db, inp["metric"], "ref"), cfg=cfg,
        n_total=s0.db.shape[0])
    assert np.array_equal(out["i"], i_loc.numpy())
    assert np.array_equal(out["d"], d_loc.numpy())
    ref = runs["ref"][f"search_p1_W{W}"]
    assert_same_ranking(out["d"], out["i"], ref["d"], ref["i"])


def _one_process_merge(inp, W, n=None):
    """The four local searches in this process, merged as ShardedKBest
    merges: the rank program's answer without a collective."""
    n_local = inp["n_local"]
    db, graph, _ = pad_to_shard_boundary(*torch_mesh_ranks.corpus(inp, n), 4)
    cfg = SearchConfig(**inp["search"], beam_width=W)
    q = torch.from_numpy(inp["queries"])
    ds, ids = [], []
    for s in range(4):
        rows = slice(s * n_local, (s + 1) * n_local)
        dbs = torch.from_numpy(db[rows])
        d, i, _ = tsearch.search(
            torch.from_numpy(graph[rows]), q,
            torch.tensor([inp["entries"][s]], dtype=torch.int32),
            dist_fn=tsearch.make_dist_fn(dbs, inp["metric"], "ref"),
            cfg=cfg, n_total=n_local)
        ds.append(d)
        ids.append(torch.where(i >= 0, i + s * n_local, -1))
    vals, pos = stable_topk_smallest(torch.cat(ds, 1), cfg.k)
    return vals.numpy(), torch.gather(torch.cat(ids, 1), 1, pos).numpy()


@pytest.mark.parametrize("W", [1, 4])
def test_sharded_search_2x2_matches_reference(runs, W):
    port = [r[f"search_W{W}"] for r in runs["port"]]
    for r in port[1:]:                       # replicated on every rank
        assert np.array_equal(r["i"], port[0]["i"])
        assert np.array_equal(r["d"], port[0]["d"])
    ref = runs["ref"][f"search_W{W}"]
    assert_same_ranking(port[0]["d"], port[0]["i"], ref["d"], ref["i"])
    d1, i1 = _one_process_merge(runs["inp"], W)
    assert np.array_equal(port[0]["i"], i1)
    assert np.array_equal(port[0]["d"], d1)
    # each rank searched its own block of the concatenation
    inp = runs["inp"]
    for s, r in enumerate(port):
        rows = slice(s * inp["n_local"], (s + 1) * inp["n_local"])
        assert np.array_equal(r["db"], inp["db"][rows])
        assert np.array_equal(r["graph"], inp["graph"][rows])
        assert int(r["entry"][0]) == inp["entries"][s]


def test_uneven_corpus_pads_with_sentinels(runs):
    """The port of tests/test_sharding.py::
    test_make_sharded_arrays_uneven_rejected_then_padded, at P=4: the
    last shard holds 498 real rows and 2 sentinels."""
    inp = runs["inp"]
    n_local, n = inp["n_local"], N_UNEVEN
    assert inp["entries"][3] < n - 3 * n_local
    port = [r["uneven"] for r in runs["port"]]
    for s, r in enumerate(port):
        lo = s * n_local
        real = min(n, lo + n_local) - lo
        assert np.array_equal(r["db"][:real], inp["db"][lo:lo + real])
        assert not r["db"][real:].any()
        assert (r["graph"][real:] == -1).all()
    ids = port[0]["i"]
    assert (ids < n).all() and (ids >= 0).all()
    d1, i1 = _one_process_merge(inp, 4, n)
    assert np.array_equal(ids, i1) and np.array_equal(port[0]["d"], d1)


# --------------------------------------------------------------------------
# sharded retrieval
# --------------------------------------------------------------------------
def _bst(runs):
    inp = runs["inp"]
    cfg = inp["bst_cfg"]
    params = R.params_from_numpy(cfg, inp["bst_params"], device="cpu")
    return cfg, params, {"hist": torch.from_numpy(inp["bst_hist"])}


@pytest.mark.parametrize("path", ["plain", "kernel"])
def test_retrieval_shardmap_p1(runs, path):
    """The port of tests/test_perf_variants.py::
    test_retrieval_shardmap_matches_naive (one gloo rank,
    make_test_mesh)."""
    cfg, params, batch = _bst(runs)
    d0, i0 = R.serve_retrieval(params, batch, cfg, k=runs["inp"]["k"])
    out = runs["p1"]["retrieval"][path]
    np.testing.assert_allclose(out["d"], d0.numpy(), rtol=1e-5)
    assert np.array_equal(out["i"], i0.numpy())
    assert out["i"].dtype == np.int32
    ref = runs["ref"]["retrieval_1"]
    assert_same_ranking(out["d"], out["i"], ref["d"], ref["i"])


@pytest.mark.parametrize("shape", [(1, 4), (4, 1)])
@pytest.mark.parametrize("path", ["plain", "kernel"])
def test_retrieval_shardmap_over_the_axis(runs, shape, path):
    cfg, params, batch = _bst(runs)
    k = runs["inp"]["k"]
    d0, i0 = R.serve_retrieval(params, batch, cfg, k=k)
    ref = runs["ref"]["retrieval_4" if shape == (1, 4) else "retrieval_1"]
    port = [r[f"retrieval_{shape}"] for r in runs["port"]]
    assert port[0]["n"] == shape[1]
    for r in port:
        out = r[path]
        np.testing.assert_allclose(out["d"], d0.numpy(), rtol=1e-5)
        assert np.array_equal(out["i"], i0.numpy())
        assert_same_ranking(out["d"], out["i"], ref["d"], ref["i"])


# --------------------------------------------------------------------------
# explicit-collective MoE
# --------------------------------------------------------------------------
def _moe_rows(runs):
    """moe_ffn per token row r of the (2, 2) mesh at no-drop capacity,
    with the gradient of <out_r, g_r> + aux_r for every input."""
    inp = runs["inp"]
    cfg = dataclasses.replace(inp["moe_cfg"],
                              capacity_factor=inp["nodrop_factor"])
    rows = inp["moe_x"].shape[0] // cfg.ep_size
    out = []
    for r in range(cfg.ep_size):
        leaves = {k: torch.from_numpy(v).requires_grad_(True)
                  for k, v in inp["moe_params"].items()}
        sl = slice(r * rows, (r + 1) * rows)
        leaves["x"] = torch.from_numpy(inp["moe_x"][sl]).requires_grad_(True)
        o, aux = MOE.moe_ffn(
            {k: v for k, v in leaves.items() if k != "x"}, leaves["x"], cfg)
        loss = torch.sum(o * torch.from_numpy(inp["moe_g"][sl])) + aux
        names = sorted(leaves)
        grads = dict(zip(names, torch.autograd.grad(
            loss, [leaves[k] for k in names])))
        out.append((o.detach().numpy(), grads))
    return out


def test_moe_shardmap_nodrop_equals_moe_ffn(runs):
    """Forward and every gradient: w_in / w_gate / w_out by block (experts
    over data, d or f over model), the router, shared experts and x on
    every model rank equal to their token row's moe_ffn gradient."""
    inp = runs["inp"]
    cfg = inp["moe_cfg"]
    rows = _moe_rows(runs)
    full, _ = MOE.moe_ffn(
        {k: torch.from_numpy(v) for k, v in inp["moe_params"].items()},
        torch.from_numpy(inp["moe_x"]),
        dataclasses.replace(cfg, capacity_factor=inp["nodrop_factor"]))
    E_l = cfg.n_experts // cfg.ep_size
    for rank, res in enumerate(runs["port"]):
        r, c = divmod(rank, cfg.tp_size)
        res = res["moe_nodrop"]
        _close(res["out"], rows[r][0])
        _close(res["out"], full.detach().numpy()[r * len(rows[r][0]):
                                                  (r + 1) * len(rows[r][0])])
        for k, g in rows[r][1].items():
            if k in ("w_in", "w_gate", "w_out"):
                g = sum(rows[i][1][k] for i in range(cfg.ep_size))
                w = g.shape[1] // cfg.tp_size
                g = g[r * E_l:(r + 1) * E_l, c * w:(c + 1) * w]
            _close(res["grad:" + k], g.numpy(), of_scale=GRAD_OF_SCALE)


@pytest.mark.parametrize("case", ["moe_nodrop", "moe_default"])
def test_moe_shardmap_matches_reference(runs, case):
    """The port of tests/test_perf_variants.py::
    test_moe_shardmap_matches_reference, and at the default capacity,
    where each column drops its own set."""
    ref = runs["ref"][case]
    port = runs["port"]
    cfg = runs["inp"]["moe_cfg"]
    out = np.concatenate([port[r * cfg.tp_size][case]["out"]
                          for r in range(cfg.ep_size)])
    _close(out, ref["out"])
    for p in port:
        np.testing.assert_allclose(p[case]["aux"], ref["aux"], rtol=RTOL)
    for r in range(cfg.ep_size):             # the same on every model rank
        for c in range(1, cfg.tp_size):
            assert np.array_equal(port[r * cfg.tp_size + c][case]["out"],
                                  port[r * cfg.tp_size][case]["out"])
    if case == "moe_default":                # something was dropped
        assert not np.allclose(out, runs["ref"]["moe_nodrop"]["out"])


# --------------------------------------------------------------------------
# on the card: the P=1 cases over NCCL, on the kernels
# --------------------------------------------------------------------------
@pytest.fixture
def card_mesh():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    with M.process_group("cuda"):
        yield M.make_test_mesh()


@pytest.mark.cuda
@pytest.mark.parametrize("W", [1, 4])
def test_card_sharded_search_p1_equals_search(card_mesh, W):
    from repro_torch.data.vectors import make_dataset
    from repro_torch.core.types import BuildConfig, IndexConfig
    ds = make_dataset("deep_like", n=2000, n_queries=40, k=10, device="cpu")
    cfg = IndexConfig(dim=96, metric="ip", build=BuildConfig(
        M=16, knn_k=24, builder="brute", refine_iters=0),
        search=SearchConfig(L=32, k=10, early_term=False, n_entries=1))
    idx = KBest(cfg, device="cuda").add(ds.base)
    scfg = dataclasses.replace(cfg.search, beam_width=W, dist_impl="kernel")
    n = idx.db.shape[0]
    fn = build_sharded_search(card_mesh, scfg, "ip", n)
    arrays = make_sharded_arrays(card_mesh, idx.db.cpu().numpy(),
                                 idx.graph.cpu().numpy(),
                                 np.asarray([idx.entry], np.int32),
                                 ds.queries)
    assert arrays[0].is_cuda
    d_sh, i_sh = fn(*arrays)
    d_loc, i_loc, _ = tsearch.search(
        idx.graph, arrays[3], torch.tensor([idx.entry], dtype=torch.int32),
        dist_fn=tsearch.make_dist_fn(idx.db, "ip", "kernel"), cfg=scfg,
        n_total=n)
    assert torch.equal(i_sh, i_loc) and torch.equal(d_sh, d_loc)


@pytest.mark.cuda
def test_card_retrieval_shardmap_p1(card_mesh):
    from repro_torch import configs as reg
    cfg = reg.get("bst").smoke_config()
    params = R.init_params(cfg, torch.Generator(device="cuda").manual_seed(0))
    batch = {"hist": torch.randint(0, cfg.n_items, (6, cfg.seq_len),
                                   device="cuda")}
    d0, i0 = R.serve_retrieval(params, batch, cfg, k=10)
    d1, i1 = R.serve_retrieval_shardmap(params, batch, cfg, card_mesh, k=10,
                                        use_kernel=True)
    np.testing.assert_allclose(d1.cpu().numpy(), d0.cpu().numpy(),
                               rtol=1e-5, atol=1e-5)
    assert torch.equal(i1, i0)


@pytest.mark.cuda
def test_card_moe_shardmap_p1_equals_moe_ffn(card_mesh):
    cfg = MOE.MoEConfig(n_experts=8, top_k=2, d_ff_expert=16,
                        n_shared_experts=1, capacity_factor=8.0,
                        ep_axis="data", tp_axis="model", use_shardmap=True,
                        ep_size=1, tp_size=1)
    g = torch.Generator(device="cuda").manual_seed(0)
    p = MOE.init_moe(g, 16, cfg)
    x = torch.randn((32, 16), generator=g, device="cuda")
    out0, aux0 = MOE.moe_ffn(p, x, cfg)
    with M.mesh_context(card_mesh):
        out1, aux1 = MOE.moe_ffn_shardmap(MOE.local_moe_params(p, cfg), x,
                                          cfg)
    _close(out1.cpu(), out0.cpu())
    _close(aux1.cpu(), aux0.cpu())


def _port_inputs() -> dict:
    """The mesh cases' inputs made by the port alone: the reference
    script's four 500-row deep_like shards built on the host by the port,
    bst's smoke params and the MoE's drawn from seeds."""
    from repro_torch import configs as reg
    from repro_torch.core.types import BuildConfig, IndexConfig
    from repro_torch.data.vectors import make_dataset
    search = dict(L=32, k=10, early_term=False, n_entries=1)
    ds = make_dataset("deep_like", n=2000, n_queries=40, k=10, device="cpu")
    cfg = IndexConfig(dim=96, metric="ip", build=BuildConfig(
        M=16, knn_k=24, builder="brute", refine_iters=0),
        search=SearchConfig(**search))
    shards = [KBest(cfg, device="cpu").add(ds.base[s * 500:(s + 1) * 500])
              for s in range(4)]
    bcfg = reg.get("bst").smoke_config()
    bp = R.init_params(bcfg, torch.Generator().manual_seed(0))
    mcfg = MOE.MoEConfig(n_experts=8, top_k=2, d_ff_expert=16,
                         n_shared_experts=1, ep_axis="data",
                         tp_axis="model", token_axes=("data",),
                         use_shardmap=True, ep_size=2, tp_size=2)
    mp = MOE.init_moe(torch.Generator().manual_seed(1), 16, mcfg)
    rng = np.random.default_rng(0)
    ref = dict(queries=ds.queries, metric="ip", search=search, n_local=500,
               bst_cfg=dataclasses.asdict(bcfg),
               bst_params=tree_map(lambda t: t.numpy(), bp),
               bst_hist=rng.integers(0, bcfg.n_items, (6, bcfg.seq_len)
                                     ).astype(np.int32), k=10,
               moe_cfg=dataclasses.asdict(mcfg),
               moe_params={k: v.numpy() for k, v in mp.items()},
               moe_x=rng.standard_normal((32, 16)).astype(np.float32),
               moe_g=rng.standard_normal((32, 16)).astype(np.float32),
               nodrop_factor=8.0)
    return _rank_inputs(ref, shards)


@pytest.mark.cuda
def test_card_mesh_cases_on_four_cards():
    """Every multi-rank case (and the LM with use_shardmap) over NCCL on
    4 cards of one host against the same cases on 4 gloo ranks of the
    host: ids tie-aware, the MoE's and the LM's outputs and gradients
    within the CPU bounds (f32, TF32 off)."""
    if torch.cuda.device_count() < 4:
        pytest.skip("needs 4 CUDA devices")
    lm = torch_mesh_ranks.lm_inputs()
    for h, c in zip(torch_mesh_ranks.spawn("lm_shardmap", lm),
                    torch_mesh_ranks.spawn("lm_shardmap", lm,
                                           device_type="cuda")):
        for k, v in h.items():
            _close(c[k], v)
    inp = _port_inputs()
    host = torch_mesh_ranks.spawn("mesh_cases", inp)
    card = torch_mesh_ranks.spawn("mesh_cases", inp, device_type="cuda")
    for h, c in zip(host, card):
        assert np.array_equal(h["coord"], c["coord"])
        for case in ("search_W1", "search_W4", "uneven"):
            for k in ("db", "graph", "entry"):
                assert np.array_equal(h[case][k], c[case][k]), (case, k)
            assert_same_ranking(c[case]["d"], c[case]["i"], h[case]["d"],
                                h[case]["i"])
        for shape in ((1, 4), (4, 1)):
            for path in ("plain", "kernel"):
                o, e = c[f"retrieval_{shape}"][path], \
                    h[f"retrieval_{shape}"]["plain"]
                assert_same_ranking(o["d"], o["i"], e["d"], e["i"])
        for case in ("moe_nodrop", "moe_default"):
            for k, v in h[case].items():
                _close(c[case][k], v, of_scale=GRAD_OF_SCALE
                       if k.startswith("grad:") else ATOL_OF_SCALE)
