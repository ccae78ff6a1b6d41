"""command-r-35b — dense GQA LM, no-bias, 256k vocab.
[hf:CohereForAI/c4ai-command-r-v01; unverified]
40L d_model=8192 64H (GQA kv=8) d_ff=22528 vocab=256000
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="command-r-35b",
    family="dense",
    num_layers=40,
    d_model=8192,
    num_heads=64,
    num_kv_heads=8,
    d_ff=22528,
    vocab_size=256000,
    tie_embeddings=True,  # command-r ties input/output embeddings
    use_bias=False,
    act="swiglu",
    rope_theta=8000000.0,
)
