"""bert4rec [recsys]: embed_dim=64 n_blocks=2 n_heads=2 seq_len=200,
bidirectional encoder with masked-item prediction. [arXiv:1904.06690]"""
from repro_torch.configs import RECSYS_SHAPES
from repro_torch.models.recsys import RecsysConfig

ARCH_ID = "bert4rec"
FAMILY = "recsys"
SHAPES = RECSYS_SHAPES


def full_config() -> RecsysConfig:
    return RecsysConfig(
        name=ARCH_ID, kind="bert4rec", n_items=1_000_000, seq_len=200,
        n_blocks=2, n_heads=2, d_model=64, dtype="float32")


def smoke_config() -> RecsysConfig:
    return RecsysConfig(
        name=ARCH_ID + "-smoke", kind="bert4rec", n_items=500, seq_len=12,
        n_blocks=1, n_heads=2, d_model=16, dtype="float32")
