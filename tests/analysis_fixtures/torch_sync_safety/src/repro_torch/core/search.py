"""Seeded violations for sync_safety: host syncs on device tensors, none
of them allowlisted (and the allowlisted loop exit is gone)."""
import torch


def search(graph: torch.Tensor, queries: torch.Tensor, k: int):
    d = queries @ queries.T
    if d.min() < 0:
        d = d.abs()
    assert d.shape[0] == k
    assert torch.isfinite(d).all()
    scale = float(d.max())
    first = d[0, 0].item()
    rows = torch.nonzero(d > scale / 2)
    return d / scale, first, rows
