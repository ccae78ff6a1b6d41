"""arctic-480b — 128-expert top-2 MoE with a parallel dense residual MLP.
[hf:Snowflake/snowflake-arctic-base; hf]
35L d_model=7168 56H (GQA kv=8) d_ff=4864 vocab=32000, MoE 128e top-2 + dense residual
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="arctic-480b",
    family="moe",
    num_layers=35,
    d_model=7168,
    num_heads=56,
    num_kv_heads=8,
    d_ff=4864,
    vocab_size=32000,
    num_experts=128,
    experts_per_token=2,
    moe_residual=True,  # dense FFN in parallel with the MoE (dense-MoE hybrid)
    tie_embeddings=False,
    act="swiglu",
)
