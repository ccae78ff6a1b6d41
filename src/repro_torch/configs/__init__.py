"""Architecture registry of the port: ``--arch <id>`` resolves here.

Every architecture of the reference is registered: the dense, hybrid, MoE,
encoder-decoder, vision and ssm families.
"""
from __future__ import annotations

from typing import Dict

from . import (
    arctic_480b,
    command_r_35b,
    granite_moe_3b,
    internvl2_1b,
    recurrentgemma_2b,
    smollm_135m,
    tinyllama_1_1b,
    whisper_medium,
    xlstm_1_3b,
    yi_9b,
)
from .base import ModelConfig, RunConfig, ShapeConfig, reduced
from .shapes import ALL_SHAPES, SHAPES, applicable

ARCHS: Dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (whisper_medium, granite_moe_3b, arctic_480b, command_r_35b, smollm_135m,
              tinyllama_1_1b, yi_9b, xlstm_1_3b, internvl2_1b, recurrentgemma_2b)
}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"arch {name!r} is not ported; ported archs: {sorted(ARCHS)}")
    return ARCHS[name]


def get_shape(name: str) -> ShapeConfig:
    if name not in SHAPES:
        raise KeyError(f"unknown shape {name!r}; available: {sorted(SHAPES)}")
    return SHAPES[name]


__all__ = ["ARCHS", "ALL_SHAPES", "SHAPES", "ModelConfig", "RunConfig", "ShapeConfig",
           "applicable", "get_arch", "get_shape", "reduced"]
