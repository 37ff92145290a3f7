"""Gradient compression for the data-parallel all-reduce, the counterpart
of the JAX package's `train/compress.py` (DESIGN.md §6).

int8 uniform quantization with a per-leaf scale and *error feedback*: the
residual of each quantization step is carried into the next step's
gradient (Seide et al. 1-bit SGD / EF-SGD), so convergence matches
uncompressed SGD up to higher-order terms while the all-reduce payload
shrinks 4x (fp32) or 2x (bf16). The residual lives beside the optimizer
state. Rounding is half to even in both packages (`torch.round`,
`jnp.round`).
"""
from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.train.tree import tree_map


def init_residual(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def _quant_leaf(g: torch.Tensor, r: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    gf = g.float() + r
    scale = torch.max(torch.abs(gf)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(gf / scale), -127, 127)
    deq = q * scale
    return deq, gf - deq        # value-to-sync, new residual


def compress_decompress(grads, residual):
    """Returns (dequantized grads to all-reduce, new residual tree)."""
    pairs = tree_map(_quant_leaf, grads, residual)
    is_pair = lambda x: isinstance(x, tuple)  # noqa: E731
    deq = tree_map(lambda t: t[0], pairs, is_leaf=is_pair)
    res = tree_map(lambda t: t[1], pairs, is_leaf=is_pair)
    return deq, res
