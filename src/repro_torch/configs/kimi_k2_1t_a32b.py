"""kimi-k2-1t-a32b [moe]: 61L d_model=7168 64H (GQA kv=8) d_ff=2048
vocab=163840, MoE 384 experts top-8 (+1 shared, DeepSeek-style) — trillion-
param MoE. [arXiv:2501.kimi2; paper-table]

Total params ~= 61 * 384 * 3*7168*2048 ~= 1.03e12; active ~32B/token.
"""
from repro_torch.configs import LM_SHAPES
from repro_torch.layers.moe import MoEConfig
from repro_torch.models.transformer import LMConfig

ARCH_ID = "kimi-k2-1t-a32b"
FAMILY = "lm"
SHAPES = LM_SHAPES


def full_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID, n_layers=61, d_model=7168, n_heads=64, n_kv_heads=8,
        d_ff=2048, vocab=163_840, head_dim=112,
        act="silu", gated_mlp=True, dtype="bfloat16", remat=True,
        moe=MoEConfig(n_experts=384, top_k=8, d_ff_expert=2048,
                      n_shared_experts=1, capacity_factor=1.25))


def smoke_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=2, d_ff=128, vocab=512, head_dim=32,
        act="silu", gated_mlp=True, dtype="float32", remat=False,
        moe=MoEConfig(n_experts=8, top_k=2, d_ff_expert=64,
                      n_shared_experts=1))
