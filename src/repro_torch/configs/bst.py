"""bst [recsys]: Behavior Sequence Transformer (Alibaba): embed_dim=32
seq_len=20 n_blocks=1 n_heads=8 mlp=1024-512-256. [arXiv:1905.06874]"""
from repro_torch.configs import RECSYS_SHAPES
from repro_torch.models.recsys import RecsysConfig

ARCH_ID = "bst"
FAMILY = "recsys"
SHAPES = RECSYS_SHAPES


def full_config() -> RecsysConfig:
    return RecsysConfig(
        name=ARCH_ID, kind="bst", n_items=1_000_000, seq_len=20,
        n_blocks=1, n_heads=8, d_model=32, mlp_dims=(1024, 512, 256),
        dtype="float32")


def smoke_config() -> RecsysConfig:
    return RecsysConfig(
        name=ARCH_ID + "-smoke", kind="bst", n_items=500, seq_len=8,
        n_blocks=1, n_heads=4, d_model=16, mlp_dims=(64, 32),
        dtype="float32")
