"""The traversal's candidate filter, `beam_filter`, on the card (`cuda`-
marked; each test skips without a CUDA device, and this file imports no
JAX).

The kernel against its plain version (kernels/ref.py) bit for bit: flat
ids, n_new and the visited bitmap, at the graph cell's shape (Q=10,000,
W=4, M=24, L=320), at queues longer than one shared-memory tile, at a warp
a row (W*M <= 32) and at more ids than threads a block, in both visited
modes. Then whole searches through `KBest.search` with the kernel against
the same searches with the plain filter: ids, distances and SearchStats
equal, and one `beam_filter` launch an iteration. `filter_case` also
feeds the CPU test of the plain version against the JAX package's
filter (tests/test_torch_queue.py).
"""
import numpy as np
import pytest
import torch

from repro_torch.core.index import KBest
from repro_torch.core.types import BuildConfig, IndexConfig, SearchConfig
from repro_torch.data.vectors import make_dataset
from repro_torch.kernels import ops, ref


def filter_case(seed, Q, W, M, L, n, bitmap):
    """numpy (v (Q, W), graph (n, M), queue_ids (Q, L) int32, bitmap
    (Q, nwords) int64 or None). A banded graph (neighbours within 16 rows;
    the second neighbour repeats the first in about a third of the rows),
    expanded nodes within 4 rows of one another (row 0 expands none, row 1
    one node twice) and queue ids within max(64, L) rows, so ids repeat
    within and across expansions and many are queued; 10% of the
    adjacency, 20% of the lanes and 30% of the queue slots are -1; in
    bitmap mode a quarter of the bits are set."""
    r = np.random.default_rng(seed)
    graph = (np.arange(n)[:, None] + r.integers(-16, 17, size=(n, M))) % n
    if M > 1:
        dup = r.random(n) < 0.3
        graph[dup, 1] = graph[dup, 0]
    graph[r.random((n, M)) < 0.1] = -1
    base = r.integers(0, n, size=(Q, 1))
    v = (base + r.integers(-4, 5, size=(Q, W))) % n
    v[r.random((Q, W)) < 0.2] = -1
    v[0] = -1
    if W > 1 and Q > 1:
        v[1, 1] = v[1, 0]
    span = max(64, L)
    qids = (base + r.integers(-span, span + 1, size=(Q, L))) % n
    qids[r.random((Q, L)) < 0.3] = -1
    bm = None
    if bitmap:
        shape = (Q, (n + 31) // 32)
        bm = r.integers(0, 2 ** 32, size=shape) & r.integers(0, 2 ** 32,
                                                            size=shape)
    return (v.astype(np.int32), graph.astype(np.int32),
            qids.astype(np.int32), bm)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


# (Q, W, M, L, n): the graph cell's shape; one and three queue tiles (the
# last ragged); a warp a row (C = 30, the build's search pass; C = 7 with
# Q not a multiple of the block's rows); C = 1,152, four ids a thread
FILTER_SHAPES = [(10_000, 4, 24, 320, 1_000_000), (64, 4, 24, 1024, 5000),
                 (64, 4, 24, 2049, 5000), (37, 1, 30, 48, 5000),
                 (9, 1, 7, 12, 300), (16, 48, 24, 320, 5000)]


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["queue", "bitmap"])
@pytest.mark.parametrize("shape", FILTER_SHAPES, ids=str)
def test_cuda_beam_filter_equals_plain(cuda, shape, mode):
    Q, W, M, L, n = shape
    if mode == "bitmap" and n > 5000:
        n = 100_000               # a (Q, n/32) bitmap of 250 MB otherwise
    v, graph, qids, bm = (None if a is None else torch.as_tensor(a,
                                                                 device=cuda)
                          for a in filter_case(Q + W + M + L, Q, W, M, L, n,
                                               mode == "bitmap"))
    bm_k = None if bm is None else bm.clone()
    before = ops.launch_counts()["beam_filter"]
    flat, n_new = ops.beam_filter(v, graph, qids, bm_k)
    exp_flat, exp_new = ref.beam_filter_ref(v, graph, qids, bm)
    torch.cuda.synchronize()
    assert ops.launch_counts()["beam_filter"] == before + 1
    assert torch.equal(flat, exp_flat)
    assert torch.equal(n_new, exp_new)
    if bm is not None:
        assert torch.equal(bm_k, bm)
    # the case exercises every mask: repeats, queued ids, seen bits
    gathered = torch.where(v[..., None] >= 0, graph[v.clamp(min=0).long()],
                           -1).reshape(Q, -1)
    assert int((gathered >= 0).sum()) > int(exp_new.sum()) \
        > int((exp_flat >= 0).sum()) > 0


@pytest.mark.cuda
def test_cuda_beam_filter_refuses_bad_operands(cuda):
    v, graph, qids, _ = (None if a is None else torch.as_tensor(a,
                                                                device=cuda)
                         for a in filter_case(0, 4, 2, 8, 16, 100, False))
    with pytest.raises(ValueError):
        ops.beam_filter(v.long(), graph, qids)
    with pytest.raises(ValueError):
        ops.beam_filter(v, graph, qids[:3])
    with pytest.raises(ValueError):
        ops.beam_filter(v[:, :1].expand(4, 600).contiguous(), graph, qids)


@pytest.fixture(scope="module")
def deep_card():
    """A graph index on the card over 5,000 deep_like rows, 256 queries."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    ds = make_dataset("deep_like", n=5000, n_queries=256, k=10,
                      device="cpu")
    cfg = IndexConfig(dim=ds.base.shape[1], metric=ds.metric,
                      build=BuildConfig(M=24, knn_k=32, builder="brute"),
                      search=SearchConfig(L=64, k=10, beam_width=4,
                                          dist_impl="kernel"))
    return KBest(cfg, device="cuda").add(ds.base), ds.queries


@pytest.mark.cuda
@pytest.mark.parametrize("mode", ["queue", "bitmap"])
@pytest.mark.parametrize("W", [1, 4])
def test_cuda_search_with_filter_kernel_equals_plain(deep_card, monkeypatch,
                                                     W, mode):
    idx, queries = deep_card
    scfg = SearchConfig(L=64, k=10, beam_width=W, visited_mode=mode,
                        dist_impl="kernel")
    before = ops.launch_counts()["beam_filter"]
    d0, i0, s0 = idx.search(queries, search_cfg=scfg, with_stats=True)
    torch.cuda.synchronize()
    launched = ops.launch_counts()["beam_filter"] - before
    monkeypatch.setattr(ops, "beam_filter", ref.beam_filter_ref)
    d1, i1, s1 = idx.search(queries, search_cfg=scfg, with_stats=True)
    assert torch.equal(i0, i1) and torch.equal(d0, d1)
    for name in s0._fields:
        assert torch.equal(getattr(s0, name), getattr(s1, name)), name
    assert launched == int(s0.iters) > 0
