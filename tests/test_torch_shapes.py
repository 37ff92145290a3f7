"""The shape layer (sharding/rules, launch/specs, launch/dryrun,
configs.all_cells) against the JAX package's on the production meshes.

The reference's cells are built on `jax.sharding.AbstractMesh`es (no
devices) and cached per arch and mesh; the port's on `DeviceMesh`es over
a `fake` process group of the mesh's size, which each test brings up and
destroys again. Every argument leaf of every cell, for the baseline and
every variant whose options touch the arch's family, must have the
reference's path, global shape, dtype, spec (both padded with None to the
leaf's rank, one-name tuples read as the name) and per-rank shape, the
last also from the DTensor placements; `kind`, `meta` and `cell_depth`
must be equal exactly. Each cell's step at depth 1 runs on meta tensors
with the output shapes and dtypes of the reference's `jax.eval_shape`.
"""
import contextlib
import functools
import json
import math

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh, PartitionSpec as P
from jax.sharding import NamedSharding as JaxSharding
from torch.distributed.tensor import Replicate, Shard
from torch.distributed.tensor._utils import \
    compute_local_shape_and_global_offset

from repro import configs as ref_configs
from repro.launch import mesh as ref_mesh
from repro.launch import specs as ref_specs
from repro.sharding import rules as ref_rules
from repro_torch import configs
from repro_torch.core.build import stable_topk_smallest
from repro_torch.launch import dryrun, specs
from repro_torch.launch.mesh import make_test_mesh, mesh_context
from repro_torch.layers.params import Leaf
from repro_torch.sharding import rules
from repro_torch.train.tree import leaves_with_path, path_key, tree_map

from torch_reference_cache import jax_maps_below_limit  # noqa: F401

MESHES = {"pod16x16": ((16, 16), ("data", "model")),
          "pod2x16x16": ((2, 16, 16), ("pod", "data", "model"))}
# the family each variant option changes a cell of
OPTION_FAMILY = {"moe_ep": "lm", "lm_loss": "lm", "remat_dots": "lm",
                 "moe_sm": "lm", "gnn_remat": "gnn", "gnn_shard_all": "gnn",
                 "retrieval_sharded": "recsys", "masked_loss": "recsys"}
# the keys of the reference's dry-run record (launch/dryrun.py run_cell)
RECORD_KEYS = {"arch", "shape", "mesh", "variant", "kind", "ok", "seconds",
               "devices", "memory_analysis", "cost_analysis",
               "cost_extrapolated", "collectives", "while_trip_counts",
               "meta"}
MEMORY_KEYS = {"argument_bytes", "output_bytes", "temp_bytes",
               "generated_code_bytes"}


def _variants(family):
    out = ["baseline"]
    out += [v for v, o in ref_specs.VARIANTS.items()
            if v not in ("baseline", "opt")
            and any(OPTION_FAMILY[k] == family for k in o)]
    return out + ["opt"]


def _norm(spec, rank):
    """A spec padded with None to the leaf's rank, one-name tuples read as
    the name."""
    parts = list(spec) + [None] * (rank - len(spec))
    return tuple(p[0] if isinstance(p, tuple) and len(p) == 1 else
                 (tuple(p) if isinstance(p, tuple) else p) for p in parts)


def _jax_path(path):
    return ref_rules._path_str(path)


@contextlib.contextmanager
def fake_world(n):
    from torch.testing._internal.distributed.fake_pg import FakeStore
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)
    try:
        yield
    finally:
        dist.destroy_process_group()


@contextlib.contextmanager
def port_mesh(mesh_name):
    with dryrun.production_mesh(mesh_name == "pod2x16x16", "cpu") as mesh:
        yield mesh


# ---------------------------------------------------------- reference -----
@functools.lru_cache(maxsize=None)
def ref_cells(arch, mesh_name):
    """{(shape, variant): (kind, meta, [(path, shape, dtype, spec, shard
    shape)])} of the reference's cells."""
    mesh = AbstractMesh(*MESHES[mesh_name])
    fam = ref_configs.get(arch).FAMILY
    out = {}
    for shape in ref_configs.get(arch).SHAPES:
        for v in _variants(fam):
            cell = ref_specs.build_cell(arch, shape, mesh, variant=v)
            args = jax.tree_util.tree_flatten_with_path(cell.args)[0]
            shs = jax.tree_util.tree_flatten_with_path(
                cell.in_shardings,
                is_leaf=lambda x: isinstance(x, JaxSharding))[0]
            assert len(args) == len(shs)
            rows = []
            for (path, x), (spath, sh) in zip(args, shs):
                assert path == spath
                rows.append((_jax_path(path), tuple(x.shape), str(x.dtype),
                             _norm(sh.spec, len(x.shape)),
                             tuple(sh.shard_shape(x.shape))))
            out[(shape, v)] = (cell.kind, cell.meta, rows)
    return out


@functools.lru_cache(maxsize=None)
def ref_outputs(arch, shape, variant):
    """[(path, shape, dtype)] of jax.eval_shape of the reference's cell at
    depth 1, unrolled, on the 16x16 mesh (the outputs are global arrays:
    their shapes do not depend on the mesh)."""
    mesh = AbstractMesh(*MESHES["pod16x16"])
    cell = ref_specs.build_cell(arch, shape, mesh, depth=1, unroll=True,
                                variant=variant)
    with jax.sharding.use_abstract_mesh(mesh):
        out = jax.eval_shape(cell.step_fn, *cell.args)
    return [(_jax_path(p), tuple(x.shape), str(x.dtype))
            for p, x in jax.tree_util.tree_flatten_with_path(out)[0]]


_LOCAL = {}


def _dtensor_local(mesh_name, mesh, shape, placements):
    """The DTensor local shape of rank 0 (memoized: the variants of a cell
    share most of their leaves)."""
    key = (mesh_name, shape, placements)
    if key not in _LOCAL:
        _LOCAL[key] = tuple(compute_local_shape_and_global_offset(
            shape, mesh, list(placements))[0])
    return _LOCAL[key]


def _port_outputs(out):
    return [(path_key(p), tuple(x.shape), str(x.dtype).replace("torch.", ""))
            for p, x in leaves_with_path(out)]


def _cells(arch):
    return list(ref_configs.get(arch).SHAPES)


ARCH_MESH = [(a, m) for a in ref_configs.ARCHS for m in MESHES]


# -------------------------------------------------------------- tests -----
def test_all_cells_match_reference():
    assert list(configs.all_cells()) == list(ref_configs.all_cells())
    assert len(list(configs.all_cells())) == 40


def test_variants_match_reference():
    assert specs.VARIANTS == ref_specs.VARIANTS
    assert specs.LM_SHAPE_PARAMS == ref_specs.LM_SHAPE_PARAMS
    assert specs.RECSYS_SHAPE_PARAMS == ref_specs.RECSYS_SHAPE_PARAMS


@pytest.mark.parametrize("arch,mesh_name", ARCH_MESH)
def test_cell_args_match_reference(arch, mesh_name):
    """Every arg leaf of every cell of the arch, baseline and the family's
    variants: path, global shape, dtype, spec and per-rank shape (from
    `.shard_shape` and from the DTensor placements); kind, meta and
    cell_depth exactly."""
    ref = ref_cells(arch, mesh_name)
    assert specs.cell_depth(arch) == ref_specs.cell_depth(arch)
    with port_mesh(mesh_name) as mesh:
        for (shape, v), (kind, meta, rows) in ref.items():
            cell = specs.build_cell(arch, shape, mesh, variant=v)
            tag = (arch, shape, v, mesh_name)
            assert cell.kind == kind, tag
            assert cell.meta == meta, tag
            for k, val in meta.items():
                assert type(cell.meta[k]) is type(val), (tag, k)
            pairs = dryrun.argument_leaves(cell)
            paths = [path_key(p) for p, _ in leaves_with_path(cell.args)]
            assert len(pairs) == len(rows), tag
            ref_bytes = 0
            for path, (x, sh), row in zip(paths, pairs, rows):
                rpath, rshape, rdtype, rspec, rshard = row
                got = (path, tuple(x.shape),
                       str(x.dtype).replace("torch.", ""),
                       _norm(sh.spec, x.dim()), sh.shard_shape(x.shape))
                assert got == row, (tag, got, row)
                assert _dtensor_local(mesh_name, mesh, tuple(x.shape),
                                      tuple(sh.placements())) == rshard, \
                    (tag, path)
                ref_bytes += math.prod(rshard) * np.dtype(
                    jax.numpy.dtype(rdtype)).itemsize
            assert dryrun.argument_bytes(cell) == ref_bytes, tag


@pytest.mark.parametrize("arch", ref_configs.ARCHS)
def test_cell_steps_run_on_meta(arch):
    """Each cell's baseline step at depth 1 on meta tensors: the outputs'
    paths, shapes and dtypes are jax.eval_shape's of the reference's."""
    with port_mesh("pod16x16") as mesh:
        for shape in _cells(arch):
            cell = specs.build_cell(arch, shape, mesh, depth=1, unroll=True)
            with mesh_context(mesh):
                out = cell.step_fn(*cell.args)
            assert _port_outputs(out) == ref_outputs(
                arch, shape, "baseline"), (arch, shape)


SHARDED_STEPS = ([(a, "train_4k", "moe_sm", m)
                  for a in ("kimi_k2_1t_a32b", "llama4_scout_17b_a16e")
                  for m in MESHES]
                 + [(a, "retrieval_cand", "retr_shard", m)
                    for a in ("deepfm", "bert4rec", "bst", "fm")
                    for m in MESHES])


@pytest.mark.parametrize("arch,shape,variant,mesh_name", SHARDED_STEPS)
def test_sharded_steps_run_on_rank_blocks(arch, shape, variant, mesh_name):
    """moe_sm's train step and retr_shard's retrieval on one rank's blocks
    under the fake group: the collectives run on meta blocks, and the
    outputs have the reference's eval_shape shapes and dtypes."""
    with port_mesh(mesh_name) as mesh:
        cell = specs.build_cell(arch, shape, mesh, depth=1, unroll=True,
                                variant=variant)
        with mesh_context(mesh):
            out = cell.step_fn(*cell.args)
    assert _port_outputs(out) == ref_outputs(arch, shape, variant)


def test_moe_sm_step_sees_rank_blocks(monkeypatch):
    """moe_sm hands moe_ffn_shardmap the rank's token rows and expert
    blocks (the reference's shard_map in_specs), not the global arrays."""
    from repro_torch.layers import moe as MOE
    seen = []
    real = MOE.moe_ffn_shardmap

    def spy(params, x, cfg):
        seen.append((tuple(x.shape), tuple(params["w_in"].shape),
                     tuple(params["w_out"].shape)))
        return real(params, x, cfg)

    monkeypatch.setattr("repro_torch.models.transformer.moe_ffn_shardmap",
                        spy)
    with port_mesh("pod2x16x16") as mesh:
        cell = specs.build_cell("llama4_scout_17b_a16e", "train_4k", mesh,
                                depth=1, variant="moe_sm")
        with mesh_context(mesh):
            cell.step_fn(*cell.args)
    lm = configs.get("llama4_scout_17b_a16e").full_config()
    E, d, f = lm.moe.n_experts, lm.d_model, lm.moe.d_ff_expert
    # 256 rows over pod x data = 8 rows of 4,096 tokens; E over data, d
    # (w_in) and f (w_out) over model
    assert seen and set(seen) == {((8 * 4096, d), (E // 16, d // 16, f),
                                   (E // 16, f // 16, d))}


def test_moe_sm_decode_fails_as_reference():
    """The reference's decode cells fail under moe_sm (its shard_map gets
    one token row, or gathers out of range); the port's do too."""
    mesh = AbstractMesh(*MESHES["pod16x16"])
    ref = ref_specs.build_cell("kimi_k2_1t_a32b", "decode_32k", mesh,
                               depth=1, variant="moe_sm")
    with pytest.raises(Exception), jax.sharding.use_abstract_mesh(mesh):
        jax.eval_shape(ref.step_fn, *ref.args)
    with port_mesh("pod16x16") as mesh:
        cell = specs.build_cell("kimi_k2_1t_a32b", "decode_32k", mesh,
                                depth=1, variant="moe_sm")
        with pytest.raises(RuntimeError), mesh_context(mesh):
            cell.step_fn(*cell.args)


# ------------------------------------------- rules on the (1, 1) mesh -----
@pytest.fixture
def test_mesh():
    with fake_world(1):
        yield make_test_mesh("cpu")


def test_lm_param_specs_divisibility_fallback(test_mesh):
    ref = ref_mesh.make_test_mesh()
    for shape in ((2, 64, 128), (2, 64, 127)):
        spec = rules.lm_param_spec("layers/wq", shape, test_mesh)
        assert spec == (None, None, "model")
        assert _norm(spec, 3) == _norm(
            ref_rules.lm_param_spec("layers/wq", shape, ref), 3)


def test_zero1_excludes_used_axes(test_mesh):
    s = rules.zero1_state_spec((None, "data", None, "model"),
                               (4, 16, 32, 64), test_mesh)
    named = [a for p in s for a in rules.entry_axes(p)]
    assert len(named) == len(set(named))
    ref = ref_rules.zero1_state_spec(P(None, "data", None, "model"),
                                     (4, 16, 32, 64),
                                     ref_mesh.make_test_mesh())
    assert _norm(s, 4) == _norm(ref, 4)


def test_param_tree_shardings_cover_all_leaves(test_mesh):
    from repro.models.transformer import init_params
    from repro_torch.models import transformer as T
    cfg = configs.get("kimi_k2_1t_a32b").smoke_config()
    p = tree_map(lambda s: torch.empty(s.shape, dtype=s.dtype,
                                       device="meta"),
                 T.param_spec(cfg), is_leaf=lambda x: isinstance(x, Leaf))
    sh = rules.tree_param_shardings(p, test_mesh, "lm")
    got = [(path_key(k), s) for k, s in leaves_with_path(sh)]
    assert len(got) == len(leaves_with_path(p))
    for (_, s), (_, x) in zip(got, leaves_with_path(p)):
        assert len(s.spec) <= x.dim()
    rcfg = ref_configs.get("kimi_k2_1t_a32b").smoke_config()
    rp = jax.eval_shape(lambda k: init_params(rcfg, k), jax.random.PRNGKey(0))
    rsh = ref_rules.tree_param_shardings(rp, ref_mesh.make_test_mesh(), "lm")
    rleaves = jax.tree_util.tree_flatten_with_path(
        rsh, is_leaf=lambda x: isinstance(x, JaxSharding))[0]
    assert [k for k, _ in got] == [_jax_path(k) for k, _ in rleaves]
    for (_, s), (_, r), (_, x) in zip(got, rleaves, leaves_with_path(p)):
        assert _norm(s.spec, x.dim()) == _norm(r.spec, x.dim())


def test_cache_shardings_long_context(test_mesh):
    meta = dict(device="meta")
    cache = {"k": torch.empty((4, 1, 512, 2, 16), dtype=torch.bfloat16,
                              **meta),
             "v": torch.empty((4, 1, 512, 2, 16), dtype=torch.bfloat16,
                              **meta),
             "len": torch.empty((1,), dtype=torch.int32, **meta)}
    sh = rules.lm_cache_shardings(cache, test_mesh)
    # B=1: sequence dim absorbs all axes
    assert sh["k"].spec[2] is not None
    ref = ref_rules.lm_cache_shardings(
        {k: jax.ShapeDtypeStruct(v.shape, jax.numpy.int32)
         for k, v in cache.items()}, ref_mesh.make_test_mesh())
    for k, v in cache.items():
        assert _norm(sh[k].spec, v.dim()) == _norm(ref[k].spec, v.dim())


def test_placements_mesh_order():
    with port_mesh("pod2x16x16") as mesh:
        ok = rules.NamedSharding(mesh, (("pod", "data"), None, "model"))
        assert ok.placements() == [Shard(0), Shard(0), Shard(2)]
        assert ok.shard_shape((64, 3, 32)) == (2, 3, 2)
        assert rules.NamedSharding(mesh, ()).placements() == [Replicate()] * 3
        for bad in ((("data", "pod"),), (("model", "data"), None),
                    ("data", "data")):
            with pytest.raises(ValueError):
                rules.NamedSharding(mesh, bad).placements()
        with pytest.raises(ValueError):
            rules.NamedSharding(mesh, ("model",)).shard_shape((24,))


# ---------------------------------------------------- the meta top-k -----
@pytest.mark.parametrize("rows,n,k", [(1, 1_000_000, 100), (3, 50, 100),
                                      (2, 400, 40), (4, 64, 64)])
def test_stable_topk_smallest_on_meta(rows, n, k):
    d = torch.empty((rows, n), dtype=torch.float32, device="meta")
    vals, idx = stable_topk_smallest(d, k)
    assert vals.device.type == idx.device.type == "meta"
    assert (tuple(vals.shape), vals.dtype) == ((rows, min(k, n)),
                                               torch.float32)
    assert (tuple(idx.shape), idx.dtype) == ((rows, min(k, n)), torch.int64)
    if k <= n:
        rv, ri = stable_topk_smallest(torch.zeros((rows, n)), k)
        assert rv.shape == vals.shape and ri.dtype == idx.dtype
        assert torch.equal(ri[0], torch.arange(k))        # ties: lower id


# ----------------------------------------------------------- the CLI -----
def test_dryrun_main_writes_record(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "ART_DIR", tmp_path)
    assert dryrun.main(["--arch", "dimenet", "--shape", "molecule",
                        "--multi-pod", "--device", "cpu"]) == 0
    assert not dist.is_initialized()
    rec = json.loads((tmp_path / "dimenet__molecule__pod2x16x16.json")
                     .read_text())
    assert set(rec) == RECORD_KEYS
    assert set(rec["memory_analysis"]) == MEMORY_KEYS
    assert rec["ok"] and rec["devices"] == 512 and rec["kind"] == "train"
    assert rec["memory_analysis"]["argument_bytes"] > 0
    assert rec["meta"] == ref_cells("dimenet", "pod2x16x16")[
        ("molecule", "baseline")][1]
