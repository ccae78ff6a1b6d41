"""granite-moe-3b-a800m — fine-grained MoE LM.
[hf:ibm-granite (3.0 MoE family); hf]
32L d_model=1536 24H (GQA kv=8) d_ff=512/expert vocab=49155, 40 experts top-8.

40 experts, top-8, as the reference's configuration (the smaller
granite-1b-a400m has 32).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="granite-moe-3b-a800m",
    family="moe",
    num_layers=32,
    d_model=1536,
    num_heads=24,
    num_kv_heads=8,
    d_ff=512,
    vocab_size=49155,
    num_experts=40,
    experts_per_token=8,
    tie_embeddings=True,
    act="swiglu",
)
