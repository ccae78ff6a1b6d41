"""smollm-135m — llama-arch small dense LM.
[hf:HuggingFaceTB/SmolLM-135M; hf]
30L d_model=576 9H (GQA kv=3) d_ff=1536 vocab=49152
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="smollm-135m",
    family="dense",
    num_layers=30,
    d_model=576,
    num_heads=9,
    num_kv_heads=3,
    d_ff=1536,
    vocab_size=49152,
    tie_embeddings=True,
    act="swiglu",
)
