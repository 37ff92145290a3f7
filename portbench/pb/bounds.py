"""The yardstick's roofline arithmetic: peaks, sectors and bound times.

The arithmetic of the port's on-card smoke test (its `bound`, `row_bytes`,
`table_sectors` and `scan_bytes`), frozen here so that a later change to
the program cannot change how a kernel's share of its roofline is
counted. Bytes count at the 32-byte sector, the least a gather reads from
HBM; each input byte is counted once a call and each output byte once.

The byte counts are returned as 0-dim tensors on the inputs' device, so
that counting a call inside a measured window never waits for the card;
`int()` them after the window.
"""
from __future__ import annotations

import torch

# NVIDIA H100 SXM data sheet: HBM3 bytes/s, float32 FLOP/s without tensor
# cores (the distance kernels use none)
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
SECTOR = 32


def bound(bytes_moved: float, flops: float):
    """(least milliseconds the card needs, "bytes" or "operations")."""
    t_b = bytes_moved / PEAK_BYTES * 1e3
    t_f = flops / PEAK_FP32 * 1e3
    return (t_b, "bytes") if t_b >= t_f else (t_f, "operations")


def row_sectors(n: int, width: int, device) -> torch.Tensor:
    """(n,) int64 bytes of the 32-byte sectors that each row of `width`
    bytes spans in a dense (n, width) array (a 12-byte row spans two where
    it straddles a sector boundary)."""
    i = torch.arange(n, device=device, dtype=torch.int64)
    first = i * width // SECTOR
    last = ((i + 1) * width - 1) // SECTOR
    return (last - first + 1) * SECTOR


def row_bytes(ids: torch.Tensor, width: int) -> torch.Tensor:
    """Bytes of the sectors that the rows of the valid (>= 0) ids span,
    each id counted as often as it occurs."""
    i = ids[ids >= 0].long()
    first = i * width // SECTOR
    last = ((i + 1) * width - 1) // SECTOR
    return (last - first + 1).sum() * SECTOR


def distinct_row_bytes(ids: torch.Tensor, spans: torch.Tensor) -> torch.Tensor:
    """Bytes of the sectors that the distinct valid ids' rows span (each
    row read once a call, however many queries need it); `spans` is
    `row_sectors` of the rows. No host sync."""
    n = spans.shape[0]
    mark = torch.zeros(n + 1, dtype=torch.bool, device=ids.device)
    flat = torch.where(ids >= 0, ids, torch.full_like(ids, n)).reshape(-1)
    mark[flat.long()] = True
    return (mark[:n].to(torch.int64) * spans).sum()


def valid_count(ids: torch.Tensor) -> torch.Tensor:
    return (ids >= 0).sum()


def table_mask(list_ids: torch.Tensor, list_codes: torch.Tensor,
               K: int) -> torch.Tensor:
    """(nlist, m, K*4/32) bool: the 32-byte sectors of each subspace's
    table row of K f32 entries that a list's valid codes hit (PQ4 codes,
    K = 16, unpacked)."""
    nlist = list_ids.shape[0]
    c = list_codes.long()
    if K == 16:                       # byte j: subspace 2j low, 2j+1 high
        c = torch.stack([c & 15, c >> 4], dim=-1).flatten(-2)
    m, nsec = c.shape[-1], K * 4 // SECTOR
    mask = torch.zeros((nlist, m, nsec), dtype=torch.bool,
                       device=list_ids.device)
    li, _ = torch.nonzero(list_ids >= 0, as_tuple=True)
    cv = c[list_ids >= 0]                                   # (valid, m)
    j = torch.arange(m, device=list_ids.device)[None]
    mask.view(-1)[((li[:, None] * m + j) * nsec + cv * 4 // SECTOR)
                  .flatten()] = True
    return mask


def table_bytes(mask: torch.Tensor, probes: torch.Tensor,
                per_probe: bool) -> torch.Tensor:
    """Bytes of the table sectors a list scan must read: per (query,
    probe) with a table per probe, per query over the union of its probed
    lists otherwise."""
    hit = mask[probes.long()]                               # (Q, P, m, nsec)
    if not per_probe:
        hit = hit.any(dim=1)
    return hit.sum() * SECTOR


def scan_bytes(list_ids: torch.Tensor, n_valid: torch.Tensor, width: int,
               probes: torch.Tensor, L: int, lead_bytes: int) -> torch.Tensor:
    """The list scans' bytes besides tables: each distinct probed list's
    ids (all slots: the kernel reads them to find the valid ones) and the
    code rows of its valid slots (`width` bytes each; `n_valid` (nlist,)
    the valid slots of each list) once a call, the probes, the query words
    or bias-free lead operand, and the (Q, P, L) outputs."""
    nlist, max_len = list_ids.shape
    used = torch.zeros(nlist, dtype=torch.bool, device=probes.device)
    used[probes.reshape(-1).long()] = True
    Q, P = probes.shape
    return (used.sum() * max_len * 4
            + (used.to(torch.int64) * n_valid).sum() * width
            + Q * P * 4 + lead_bytes + Q * P * L * 8)


def scanned_codes(n_valid: torch.Tensor, probes: torch.Tensor) -> torch.Tensor:
    """Valid codes a scan reads over all (query, probe) pairs."""
    return n_valid[probes.long()].sum()
