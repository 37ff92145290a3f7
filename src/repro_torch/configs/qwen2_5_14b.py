"""qwen2.5-14b [dense]: 48L d_model=5120 40H (GQA kv=8) d_ff=13824
vocab=152064 — GQA, QKV bias. [hf:Qwen/Qwen2.5-14B]"""
from repro_torch.configs import LM_SHAPES
from repro_torch.models.transformer import LMConfig

ARCH_ID = "qwen2.5-14b"
FAMILY = "lm"
SHAPES = LM_SHAPES


def full_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID, n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=13824, vocab=152064, head_dim=128, qkv_bias=True,
        act="silu", gated_mlp=True, rope_base=1_000_000.0,
        dtype="bfloat16", remat=True)


def smoke_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=2, d_ff=256, vocab=512, head_dim=32, qkv_bias=True,
        act="silu", gated_mlp=True, dtype="float32", remat=False)
