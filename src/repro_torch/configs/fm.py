"""fm [recsys]: n_sparse=39 embed_dim=10, pairwise <vi,vj>xixj via the
O(nk) sum-square trick. [Rendle ICDM'10]"""
from repro_torch.configs import RECSYS_SHAPES
from repro_torch.models.recsys import RecsysConfig

ARCH_ID = "fm"
FAMILY = "recsys"
SHAPES = RECSYS_SHAPES


def full_config() -> RecsysConfig:
    return RecsysConfig(
        name=ARCH_ID, kind="fm", n_sparse=39, vocab_per_field=1_000_000,
        embed_dim=10, dtype="float32")


def smoke_config() -> RecsysConfig:
    return RecsysConfig(
        name=ARCH_ID + "-smoke", kind="fm", n_sparse=6, vocab_per_field=1000,
        embed_dim=8, dtype="float32")
