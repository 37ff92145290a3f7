"""Nested-container helpers the substrate uses in place of
`jax.tree_util`: parameters, gradients and optimizer states are nested
dicts and lists of tensors, walked in the reference's order (dict keys
sorted, list items by index), and a leaf's path joins its keys with "/" as
the reference's checkpoints do (`params/mlp/0/w`).
"""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Optional, Tuple

import numpy as np
import torch

_NODES = (dict, list, tuple)


def _is_leaf(x, is_leaf: Optional[Callable]) -> bool:
    return not isinstance(x, _NODES) or (is_leaf is not None and is_leaf(x))


def leaves_with_path(tree, is_leaf: Optional[Callable] = None
                     ) -> List[Tuple[Tuple, Any]]:
    """[(path, leaf)] in the reference's flattening order."""
    out: List[Tuple[Tuple, Any]] = []
    _walk(tree, (), is_leaf, out)
    return out


def _walk(t, path, is_leaf, out) -> None:
    # a module-level recursion: a nested function that calls itself is a
    # reference cycle, which would keep `out` (and every leaf in it, whole
    # parameter trees) alive until the cyclic collector runs
    if _is_leaf(t, is_leaf):
        out.append((path, t))
        return
    items = (sorted(t.items(), key=lambda kv: kv[0])
             if isinstance(t, dict) else enumerate(t))
    for k, v in items:
        _walk(v, path + (k,), is_leaf, out)


def leaves(tree, is_leaf: Optional[Callable] = None) -> list:
    return [leaf for _, leaf in leaves_with_path(tree, is_leaf)]


def tree_map_with_path(fn: Callable, tree):
    """fn(path, leaf) over the leaves of `tree`, in its structure."""
    return unflatten(tree, [fn(p, x) for p, x in leaves_with_path(tree)])


def path_key(path: Tuple) -> str:
    return "/".join(str(p) for p in path)


def tree_map(fn: Callable, tree, *rest, is_leaf: Optional[Callable] = None):
    """fn over the leaves of `tree`; each tree of `rest` has `tree`'s
    structure at least down to its leaves, and whatever it holds there
    (a leaf or a whole subtree) is passed on, as `jax.tree.map` does."""
    if _is_leaf(tree, is_leaf):
        return fn(tree, *rest)
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest), is_leaf=is_leaf)
                for k, v in tree.items()}
    out = [tree_map(fn, v, *(r[i] for r in rest), is_leaf=is_leaf)
           for i, v in enumerate(tree)]
    return tuple(out) if isinstance(tree, tuple) else out


def unflatten(like, new_leaves) -> Any:
    """`like`'s structure with its leaves replaced, in flattening order."""
    it: Iterator = iter(new_leaves)
    paths = [p for p, _ in leaves_with_path(like)]
    by_path = {p: next(it) for p in paths}
    return _rebuild(like, (), by_path)


def _rebuild(t, path, by_path):
    if _is_leaf(t, None):
        return by_path[path]
    if isinstance(t, dict):
        return {k: _rebuild(v, path + (k,), by_path) for k, v in t.items()}
    out = [_rebuild(v, path + (i,), by_path) for i, v in enumerate(t)]
    return tuple(out) if isinstance(t, tuple) else out


def to_numpy(x) -> np.ndarray:
    """A host copy of a leaf (never a view of a host tensor). bf16
    becomes f32 (exact): numpy has no bf16 without `ml_dtypes`."""
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            x = x.float()
        return x.to("cpu", copy=True).numpy()
    return np.array(x)


def to_tensor(a, device) -> torch.Tensor:
    """A numpy array (or anything `np.asarray` takes) as a tensor on
    `device`. A bf16 array, whether typed by `ml_dtypes` or read back as
    raw 2-byte voids, is taken from its 16 bits."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16" or (a.dtype.kind == "V"
                                      and a.dtype.itemsize == 2):
        t = torch.from_numpy(np.array(a, order="C").view(np.int16))
        return t.view(torch.bfloat16).to(device)
    return torch.from_numpy(np.array(a, order="C")).to(device)
