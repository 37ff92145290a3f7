"""Carry an index built by the JAX package over into the port.

`from_reference_arrays` takes the reference index's numpy state — `db`,
`graph` and `order`, and for the quantized kinds `pq_codebooks` and
`pq_codes` or `sq_scale`, `sq_zero` and `sq_codes` (the arrays its
format-2 save holds) — its `entry`, and its config as `dataclasses.asdict`
gives it, and returns a port `KBest` holding the same index, so both
packages search the same graph over the same codes.
`KBest.load` of a reference save is the second route to the same state.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

from repro_torch.core.index import KBest, _config_from_dict, _from_arrays


def from_reference_arrays(arrays: Dict[str, np.ndarray], entry: int,
                          config: dict, device=None) -> KBest:
    arrays = {k: np.asarray(v) for k, v in arrays.items() if v is not None}
    return _from_arrays(arrays, int(entry), _config_from_dict(config), device)
