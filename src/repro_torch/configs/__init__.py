"""Architecture registry of the port: ``--arch <id>`` resolves here.

Only the architectures whose block kinds the port runs are registered (the
dense, hybrid and MoE families); the reference's other archs wait for their
families to be ported.
"""
from __future__ import annotations

from typing import Dict

from . import arctic_480b, granite_moe_3b, recurrentgemma_2b, smollm_135m, tinyllama_1_1b
from .base import ModelConfig, ShapeConfig, reduced

ARCHS: Dict[str, ModelConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (tinyllama_1_1b, recurrentgemma_2b, smollm_135m, granite_moe_3b, arctic_480b)
}


def get_arch(name: str) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"arch {name!r} is not ported; ported archs: {sorted(ARCHS)}")
    return ARCHS[name]


__all__ = ["ARCHS", "ModelConfig", "ShapeConfig", "get_arch", "reduced"]
