"""Carry an index built by the JAX package over into the port.

`from_reference_arrays` takes the reference index's numpy state — the
arrays its format-2 save holds: for a graph index `db`, `graph` and
`order`, and for the quantized kinds `pq_codebooks` and `pq_codes` (pq
and pq4), `sq_scale`, `sq_zero` and `sq_codes`, or `bin_rot` and
`bin_codes`; for an IVF index `db`, `ivf_centroids`, `ivf_list_ids`,
`ivf_list_codes` and `ivf_codebooks` or `ivf_bin_rot` (bin words are
uint32 there; the port keeps their bits as int32) — its `entry`, and its
config as `dataclasses.asdict` gives it, and returns a port `KBest`
holding the same index, so both packages search the same graph or lists
over the same codes.
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
