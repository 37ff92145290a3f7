"""dimenet [gnn]: n_blocks=6 d_hidden=128 n_bilinear=8 n_spherical=7
n_radial=6. [arXiv:2003.03123]

Per-shape input parameters (assigned):
  full_graph_sm : n_nodes=2708   n_edges=10556      d_feat=1433 (full-batch)
  minibatch_lg  : n_nodes=232965 n_edges=114615892  batch_nodes=1024
                  fanout 15-10 (sampled; d_feat=602, Reddit's)
  ogb_products  : n_nodes=2449029 n_edges=61859140  d_feat=100 (full-batch)
  molecule      : n_nodes=30 n_edges=64 batch=128 (batched small graphs)

Triplet expansion is capped at TRIPLET_CAP per edge on the big graphs
(DESIGN.md §Arch-applicability: full expansion of 61.9M edges would be
~1.5G triplets).
"""
from repro_torch.configs import GNN_SHAPES
from repro_torch.models.dimenet import DimeNetConfig

ARCH_ID = "dimenet"
FAMILY = "gnn"
SHAPES = GNN_SHAPES
TRIPLET_CAP = 8

SHAPE_PARAMS = {
    "full_graph_sm": dict(n_nodes=2708, n_edges=10556, d_feat=1433,
                          task="node_clf", n_out=7),
    "minibatch_lg": dict(n_nodes=232_965, n_edges=114_615_892,
                         batch_nodes=1024, fanouts=(15, 10), d_feat=602,
                         task="node_clf", n_out=41),
    "ogb_products": dict(n_nodes=2_449_029, n_edges=61_859_140, d_feat=100,
                         task="node_clf", n_out=47),
    "molecule": dict(n_nodes=30, n_edges=64, batch=128, d_feat=32,
                     task="graph_reg", n_out=1),
}


def full_config(shape: str = "full_graph_sm") -> DimeNetConfig:
    sp = SHAPE_PARAMS[shape]
    return DimeNetConfig(
        name=ARCH_ID, n_blocks=6, d_hidden=128, n_bilinear=8, n_spherical=7,
        n_radial=6, d_feat=sp["d_feat"], n_out=sp["n_out"], task=sp["task"],
        dtype="float32")


def smoke_config() -> DimeNetConfig:
    return DimeNetConfig(
        name=ARCH_ID + "-smoke", n_blocks=2, d_hidden=32, n_bilinear=4,
        n_spherical=3, n_radial=4, d_feat=16, n_out=4, task="node_clf",
        dtype="float32")
