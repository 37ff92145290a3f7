"""chatglm3-6b [dense]: 28L d_model=4096 32H (GQA kv=2) d_ff=13696
vocab=65024 — RoPE 2d (rotary on half the head dim), GQA. [arXiv:2406.12793]"""
from repro_torch.configs import LM_SHAPES
from repro_torch.models.transformer import LMConfig

ARCH_ID = "chatglm3-6b"
FAMILY = "lm"
SHAPES = LM_SHAPES


def full_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID, n_layers=28, d_model=4096, n_heads=32, n_kv_heads=2,
        d_ff=13696, vocab=65024, head_dim=128, qkv_bias=True,
        rotary_frac=0.5,                       # ChatGLM 2-d RoPE
        act="silu", gated_mlp=True, dtype="bfloat16", remat=True)


def smoke_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=2, d_ff=256, vocab=512, head_dim=32, qkv_bias=True,
        rotary_frac=0.5, act="silu", gated_mlp=True, dtype="float32",
        remat=False)
