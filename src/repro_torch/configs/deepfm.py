"""deepfm [recsys]: n_sparse=39 embed_dim=10 mlp=400-400-400 interaction=fm.
[arXiv:1703.04247]"""
from repro_torch.configs import RECSYS_SHAPES
from repro_torch.models.recsys import RecsysConfig

ARCH_ID = "deepfm"
FAMILY = "recsys"
SHAPES = RECSYS_SHAPES


def full_config() -> RecsysConfig:
    return RecsysConfig(
        name=ARCH_ID, kind="deepfm", n_sparse=39, vocab_per_field=1_000_000,
        embed_dim=10, mlp_dims=(400, 400, 400), dtype="float32")


def smoke_config() -> RecsysConfig:
    return RecsysConfig(
        name=ARCH_ID + "-smoke", kind="deepfm", n_sparse=6,
        vocab_per_field=1000, embed_dim=8, mlp_dims=(32, 16),
        dtype="float32")
