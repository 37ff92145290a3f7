"""Device meshes and their collectives over torch.distributed, the
counterpart of the JAX package's `launch/mesh.py`.

    with process_group("cpu", rank=r, world_size=4, init_file=path):
        mesh = init_device_mesh("cpu", (2, 2),
                                mesh_dim_names=("data", "model"))
        with mesh_context(mesh):
            out, aux = moe_ffn_shardmap(local_params, x_local, cfg)

A mesh is a `torch.distributed.device_mesh.DeviceMesh`: one process a
device, ranks laid out row-major over named axes. The builders are
functions, not constants: importing this module creates no process group.
Each builder needs the default group, which `process_group` makes (NCCL
for "cuda", one card a rank; gloo for "cpu") over a file store, so no
network address is needed. Entry points mean the card unless the caller
asks for "cpu".

`mesh_context(mesh)` sets the ambient mesh that `moe_ffn_shardmap` reads,
as `jax.set_mesh` does for the reference's `shard_map` calls without
`mesh=`; a call that needs a mesh outside one raises.

The collectives are the tiled ones of `jax.lax` that the reference's
`shard_map` bodies use (`all_to_all`, `psum_scatter`, `all_gather`,
`pmean`), over one mesh axis, with gradients. Each rank back-propagates
its own loss. A tensor held the same on every rank of an axis (a replica:
the tokens and the result of `all_gather` over the TP axis) gets the
cotangent of the one value: `all_gather` keeps the rank's own slice of
it, and `split`, the transpose, gathers the slices; `all_to_all` is its
own transpose and `psum_scatter`'s is `all_gather`; `pmean`'s is the
mean of the ranks' cotangents. The reference states its layouts in
`PartitionSpec`s; here each rank holds and passes its local block.

The reference's `compat.py` is a JAX-version shim (`shard_map` and
`set_mesh` across jax releases) with no torch counterpart, so it has no
file here.
"""
from __future__ import annotations

import contextlib
import contextvars
import datetime
import os
import tempfile
from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist

_MESH: contextvars.ContextVar = contextvars.ContextVar("repro_torch_mesh",
                                                       default=None)

# the single-tensor collectives under their current names (older torch:
# the *_into_tensor / *_tensor spellings, deprecated in newer releases)
_all_gather_single = getattr(dist, "all_gather_single", None) or \
    dist.all_gather_into_tensor
_reduce_scatter_single = getattr(dist, "reduce_scatter_single", None) or \
    dist.reduce_scatter_tensor


def backend(device_type: str) -> str:
    return "nccl" if device_type == "cuda" else "gloo"


@contextlib.contextmanager
def process_group(device_type: str = "cuda", *, rank: int = 0,
                  world_size: int = 1, init_file: Optional[str] = None,
                  timeout_s: Optional[float] = None):
    """The default process group for this rank over a `file://` store
    (NCCL for "cuda", gloo for "cpu"), destroyed on exit. Every rank of
    the world passes the same `init_file`, a path no earlier group used;
    at world size 1 it may be left out (a fresh temporary file). On the
    card rank r takes card r."""
    if device_type == "cuda":
        torch.cuda.set_device(rank)
    with contextlib.ExitStack() as stack:
        if init_file is None:
            if world_size != 1:
                raise ValueError("ranks of a world larger than 1 must share "
                                 "an init_file")
            init_file = os.path.join(
                stack.enter_context(tempfile.TemporaryDirectory()), "store")
        kw = {} if timeout_s is None else dict(
            timeout=datetime.timedelta(seconds=timeout_s))
        dist.init_process_group(backend(device_type),
                                init_method=f"file://{init_file}",
                                rank=rank, world_size=world_size, **kw)
        try:
            yield
        finally:
            dist.destroy_process_group()


def _mesh(device_type: str, shape: Tuple[int, ...],
          names: Tuple[str, ...]):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device_type, shape, axes)


def make_test_mesh(device_type: str = "cuda"):
    """A one-device mesh with the production axis names."""
    return _mesh(device_type, (1, 1), ("data", "model"))


@contextlib.contextmanager
def mesh_context(mesh):
    """Make `mesh` the ambient mesh inside the block."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def current_mesh():
    """The ambient mesh of `mesh_context`; raises outside one."""
    mesh = _MESH.get()
    if mesh is None:
        raise RuntimeError("this call runs on a device mesh: wrap it in "
                           "`with mesh_context(mesh):` "
                           "(repro_torch.launch.mesh)")
    return mesh


def mesh_device(mesh) -> torch.device:
    """The device this rank's blocks live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


class Axis(NamedTuple):
    """One axis of a mesh as this rank sees it: the group of the ranks
    that differ only along it, its size and this rank's index on it
    (which is its rank in the group)."""
    group: object
    size: int
    index: int


def mesh_axis(mesh, name: str) -> Axis:
    """The named axis. The reference's `axis_index` is the mesh
    coordinate; a group's collectives order their chunks by group rank:
    the two are checked equal."""
    dim = mesh.mesh_dim_names.index(name)
    group = mesh.get_group(name)
    index = mesh.get_coordinate()[dim]
    assert dist.get_rank(group) == index, (name, dist.get_rank(group), index)
    return Axis(group, mesh.shape[dim], index)


def mesh_flat(mesh) -> Axis:
    """All axes of the mesh flattened row-major, as the reference's
    `P(axis_names)` row sharding and its linear `axis_index` loop: the
    default group when the mesh spans the world, else a group of the
    mesh's ranks. Its rank order is checked against the linear index of
    `get_coordinate()`."""
    ranks = mesh.mesh.flatten().tolist()
    if ranks != sorted(ranks):
        raise ValueError("the mesh's ranks are not laid out row-major "
                         "(init_device_mesh's layout)")
    coord = mesh.get_coordinate()
    index = 0
    for c, n in zip(coord, mesh.shape):
        index = index * n + c
    assert ranks[index] == dist.get_rank(), (ranks, index, dist.get_rank())
    if len(ranks) == dist.get_world_size():
        group = dist.group.WORLD
    else:
        group = dist.new_group(ranks=ranks, use_local_synchronization=True)
    assert dist.get_rank(group) == index, (dist.get_rank(group), index)
    return Axis(group, len(ranks), index)


# --------------------------------------------------------------------------
# collectives with gradients, tiled along one dim
# --------------------------------------------------------------------------
class _AllToAll(torch.autograd.Function):
    """Equal chunks of dim 0 exchanged: its own transpose."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _exchange(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _exchange(g, ctx.axis), None


class _ReduceScatter(torch.autograd.Function):
    """Sum over the axis, this rank's chunk of dim 0 kept."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        x = x.contiguous()
        out = x.new_empty((x.shape[0] // axis.size,) + x.shape[1:])
        _reduce_scatter_single(out, x, group=axis.group)
        return out

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.axis), None


class _AllGather(torch.autograd.Function):
    """The chunks of dim 0 concatenated in axis order; the result is a
    replica, so the backward keeps this rank's slice of its cotangent."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis, ctx.rows = axis, x.shape[0]
        return _gather(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(0, ctx.axis.index * ctx.rows, ctx.rows), None


class _Split(torch.autograd.Function):
    """This rank's chunk of dim 0 of a replica; the transpose of
    `_AllGather`."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        rows = x.shape[0] // axis.size
        return x.narrow(0, axis.index * rows, rows).clone()

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.axis), None


class _Mean(torch.autograd.Function):
    """The mean over the axis; the backward is the mean of the ranks'
    cotangents (the cotangent itself when every rank holds the same)."""

    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        out = x.clone()
        dist.all_reduce(out, group=axis.group)
        return out / axis.size

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.axis.group)
        return g / ctx.axis.size, None


def _exchange(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=axis.group)
    return out


def _gather(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    x = x.contiguous()
    out = x.new_empty((x.shape[0] * axis.size,) + x.shape[1:])
    _all_gather_single(out, x, group=axis.group)
    return out


def all_to_all(x: torch.Tensor, axis: Axis, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """`jax.lax.all_to_all(x, axis, split_dim, concat_dim, tiled=True)`:
    split_dim cut into axis.size chunks, chunk j sent to rank j, the
    chunks received concatenated along concat_dim in rank order."""
    n = axis.size
    y = x.movedim(split_dim, 0)
    rest = y.shape[1:]
    y = _AllToAll.apply(y.reshape((n, y.shape[0] // n) + rest), axis)
    y = y.movedim(1, split_dim + 1).movedim(0, concat_dim)
    shape = list(y.shape)
    shape[concat_dim:concat_dim + 2] = [n * shape[concat_dim + 1]]
    return y.reshape(shape)


def psum_scatter(x: torch.Tensor, axis: Axis, dim: int) -> torch.Tensor:
    """`jax.lax.psum_scatter(x, axis, scatter_dimension=dim, tiled=True)`."""
    return _ReduceScatter.apply(x.movedim(dim, 0), axis).movedim(0, dim)


def all_gather(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """`jax.lax.all_gather(x, axis, axis=0, tiled=True)`, a replica."""
    return _AllGather.apply(x, axis)


def split(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """This rank's equal chunk of dim 0 of a replica."""
    return _Split.apply(x, axis)


def pmean(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """`jax.lax.pmean(x, axis)`."""
    return _Mean.apply(x, axis)


def gather_stack(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    """(axis.size, *x.shape): every rank's x in axis order, no gradient
    (the reference's untiled `all_gather`)."""
    return _gather(x, axis).reshape((axis.size,) + x.shape)
