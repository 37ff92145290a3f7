"""Parameter trees from specs, shared by the port's models.

A model describes its parameters as a nested dict (and list) of `Leaf`
specs keyed as the reference's pytree. From the spec:

  * `init_from_spec` draws seeded parameters on a generator's device, each
    leaf in its own dtype (a bf16 leaf never passes through an f32
    transient of its size);
  * `from_numpy` carries the reference's parameters (numpy arrays, the same
    nesting) across, holding shapes and dtypes to the spec: jax.random
    draws have no torch twin, so value parity goes through it;
  * `TreeModule` is the tree as an `nn.Module` whose parameter names are
    the tree's paths with "." for "/".
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
from torch import nn

from repro_torch.layers import common as L
from repro_torch.train.tree import leaves_with_path, to_tensor, tree_map


@dataclasses.dataclass(frozen=True)
class Leaf:
    """A parameter's shape, dtype and draw: zeros, or a normal times
    `scale` (None: 1/sqrt(fan_in), fan_in the first dim)."""
    shape: Tuple[int, ...]
    dtype: torch.dtype
    scale: Optional[float] = None
    zeros: bool = False


def _is_spec(x) -> bool:
    return isinstance(x, Leaf)


def init_from_spec(spec, generator: torch.Generator):
    """Seeded parameters of `spec` on the generator's device."""
    def draw(s: Leaf):
        if s.zeros:
            return torch.zeros(s.shape, dtype=s.dtype, device=generator.device)
        return L.dense_init(generator, s.shape, scale=s.scale, dtype=s.dtype)
    return tree_map(draw, spec, is_leaf=_is_spec)


def from_numpy(spec, tree, device=None):
    """The reference's params (numpy arrays, `spec`'s nesting) on `device`
    (None: the card). bf16 leaves are read from their raw 16 bits."""
    dev = torch.device("cuda" if device is None else device)

    def conv(s: Leaf, a):
        t = to_tensor(a, dev)
        if tuple(t.shape) != s.shape or t.dtype != s.dtype:
            raise ValueError(f"param {tuple(t.shape)} {t.dtype}, expected "
                             f"{s.shape} {s.dtype}")
        return t
    return tree_map(conv, spec, tree, is_leaf=_is_spec)


def n_params(params) -> int:
    return sum(t.numel() for _, t in leaves_with_path(params))


class _Node(nn.Module):
    """One dict level of a parameter tree as a module."""


def _module_of(tree) -> nn.Module:
    if isinstance(tree, list):
        return nn.ModuleList([_module_of(t) for t in tree])
    node = _Node()
    for k, v in sorted(tree.items()):
        if isinstance(v, torch.Tensor):
            node.register_parameter(k, nn.Parameter(v))
        else:
            node.add_module(k, _module_of(v))
    return node


def _tree_of(module: nn.Module):
    if isinstance(module, nn.ModuleList):
        return [_tree_of(m) for m in module]
    out = dict(module.named_parameters(recurse=False))
    out.update({k: _tree_of(m) for k, m in module.named_children()})
    return out


class TreeModule(nn.Module):
    """A parameter tree as an `nn.Module`: `named_parameters()` with "."
    read as "/" are the reference's tree paths (`mlp.0.w` is `mlp/0/w`).
    The parameters share storage with the tree it was made from."""

    def __init__(self, cfg, params: dict):
        super().__init__()
        self.cfg = cfg
        self.tree = _module_of(params)

    def params(self) -> dict:
        return _tree_of(self.tree)

    def named_paths(self):
        """(reference path, parameter) pairs."""
        return [(n[len("tree."):].replace(".", "/"), p)
                for n, p in self.named_parameters()]
