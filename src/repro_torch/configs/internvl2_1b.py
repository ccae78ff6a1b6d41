"""internvl2-1b — VLM: InternViT frontend STUB + Qwen2-0.5B-like LM backbone.
[arXiv:2404.16821; hf]
24L d_model=896 14H (GQA kv=2) d_ff=4864 vocab=151655

The vision frontend is a stub, as in the reference: the caller passes
precomputed patch embeddings (B, vision_patches, d_model) as
``batch["vision"]``, which are prepended to the token embeddings.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="internvl2-1b",
    family="vlm",
    num_layers=24,
    d_model=896,
    num_heads=14,
    num_kv_heads=2,
    d_ff=4864,
    vocab_size=151655,
    vision_patches=256,  # one 448x448 tile -> 256 patch embeddings
    tie_embeddings=True,
    use_bias=True,  # qwen2 uses qkv bias
    act="swiglu",
)
