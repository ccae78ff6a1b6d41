"""recurrentgemma-2b — Griffin-style hybrid: RG-LRU + local attention, 2:1.
[arXiv:2402.19427; hf]
26L d_model=2560 10H (GQA kv=1, i.e. MQA) d_ff=7680 vocab=256000

Pattern (recurrent, recurrent, local-attention) repeated; 26 = 8*3 + 2, the
two remainder layers are recurrent (matches Griffin's tail).  Local attention
window 2048 + O(1) RG-LRU state -> long_500k RUNS (window-bounded cache).
"""
from .base import ModelConfig

CONFIG = ModelConfig(
    name="recurrentgemma-2b",
    family="hybrid",
    num_layers=26,
    d_model=2560,
    num_heads=10,
    num_kv_heads=1,
    d_ff=7680,
    vocab_size=256000,
    layer_pattern=("rglru", "rglru", "localattn"),
    local_window=2048,
    tie_embeddings=True,
    act="geglu",
    logit_softcap=30.0,
)
