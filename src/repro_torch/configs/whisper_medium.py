"""whisper-medium — encoder-decoder audio transformer (conv frontend STUB).
[arXiv:2212.04356; unverified]
24L d_model=1024 16H (GQA kv=16) d_ff=4096 vocab=51865

The audio/conv frontend is a stub, as in the reference: the caller passes
precomputed frame embeddings (B, encoder_seq, d_model) as ``batch["frames"]``.
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="whisper-medium",
    family="encdec",
    num_layers=24,  # decoder layers
    encoder_layers=24,
    encoder_seq=1500,
    d_model=1024,
    num_heads=16,
    num_kv_heads=16,  # whisper is MHA
    d_ff=4096,
    vocab_size=51865,
    tie_embeddings=True,
    act="gelu",
)
