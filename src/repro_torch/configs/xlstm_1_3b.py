"""xlstm-1.3b — sLSTM + mLSTM recurrent LM (attention-free).
[arXiv:2405.04517; unverified]
48L d_model=2048 4H (GQA kv=4) d_ff=0 vocab=50304

d_ff=0: no separate FFN — the xLSTM blocks carry their own projections.
Pattern: one sLSTM block per ``slstm_every`` (=8) layers, mLSTM otherwise.
Sub-quadratic: O(1)-size recurrent state -> long_500k RUNS.
"""
from .base import ModelConfig

_PATTERN = tuple(["mlstm"] * 7 + ["slstm"])  # repeated 6x -> 48 layers

CONFIG = ModelConfig(
    name="xlstm-1.3b",
    family="ssm",
    num_layers=48,
    d_model=2048,
    num_heads=4,
    num_kv_heads=4,
    d_ff=0,
    vocab_size=50304,
    layer_pattern=_PATTERN,
    slstm_every=8,
    tie_embeddings=False,
    act="gelu",
)
