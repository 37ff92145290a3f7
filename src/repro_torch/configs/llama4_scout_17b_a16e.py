"""llama4-scout-17b-a16e [moe]: 48L d_model=5120 40H (GQA kv=8) d_ff=8192
vocab=202048, MoE 16 experts top-1 (+1 shared) — the assignment specifies
the text backbone; early-fusion multimodal frontend is out of scope
(modality stub). [hf:meta-llama/Llama-4-Scout-17B-16E]"""
from repro_torch.configs import LM_SHAPES
from repro_torch.layers.moe import MoEConfig
from repro_torch.models.transformer import LMConfig

ARCH_ID = "llama4-scout-17b-a16e"
FAMILY = "lm"
SHAPES = LM_SHAPES


def full_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID, n_layers=48, d_model=5120, n_heads=40, n_kv_heads=8,
        d_ff=8192, vocab=202_048, head_dim=128,
        act="silu", gated_mlp=True, dtype="bfloat16", remat=True,
        moe=MoEConfig(n_experts=16, top_k=1, d_ff_expert=8192,
                      n_shared_experts=1, capacity_factor=1.25))


def smoke_config() -> LMConfig:
    return LMConfig(
        name=ARCH_ID + "-smoke", n_layers=2, d_model=128, n_heads=4,
        n_kv_heads=2, d_ff=256, vocab=512, head_dim=32,
        act="silu", gated_mlp=True, dtype="float32", remat=False,
        moe=MoEConfig(n_experts=4, top_k=1, d_ff_expert=128,
                      n_shared_experts=1))
