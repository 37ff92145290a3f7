"""gemma-2b [dense]: 18L d_model=2048 8H (MQA kv=1) d_ff=16384 vocab=256000
— GeGLU, head_dim=256, tied embeddings, embedding scaling. [arXiv:2403.08295]"""
from repro_torch.configs import LM_SHAPES
from repro_torch.models.transformer import LMConfig

ARCH_ID = "gemma-2b"
FAMILY = "lm"
SHAPES = LM_SHAPES


def full_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID, n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1,
        d_ff=16384, vocab=256_000, head_dim=256,
        act="geglu", gated_mlp=True, tie_embeddings=True,
        dtype="bfloat16", remat=True)


def smoke_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=1, d_ff=256, vocab=512, head_dim=64,
        act="geglu", gated_mlp=True, tie_embeddings=True,
        dtype="float32", remat=False)
