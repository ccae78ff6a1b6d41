"""The assigned input-shape set (same four for every LM-family architecture).

A copy of the reference's ``repro.configs.shapes``.
"""
from __future__ import annotations

from typing import Dict, List

from .base import ModelConfig, ShapeConfig

TRAIN_4K = ShapeConfig("train_4k", seq_len=4096, global_batch=256, kind="train")
PREFILL_32K = ShapeConfig("prefill_32k", seq_len=32768, global_batch=32, kind="prefill")
DECODE_32K = ShapeConfig("decode_32k", seq_len=32768, global_batch=128, kind="decode")
LONG_500K = ShapeConfig("long_500k", seq_len=524288, global_batch=1, kind="decode")

ALL_SHAPES: List[ShapeConfig] = [TRAIN_4K, PREFILL_32K, DECODE_32K, LONG_500K]
SHAPES: Dict[str, ShapeConfig] = {s.name: s for s in ALL_SHAPES}


def applicable(model: ModelConfig, shape: ShapeConfig) -> bool:
    """long_500k needs sub-quadratic decode (SSM/hybrid); others always apply.

    Full-attention architectures skip long_500k (O(seq) KV cache at 524288
    positions is architecturally quadratic-cost serving).
    """
    if shape.name == "long_500k":
        return model.is_subquadratic
    return True
