"""Config dataclasses: model architecture and input shapes.

A copy of the reference's ``ModelConfig``, ``ShapeConfig`` and ``reduced``
(``repro.configs.base``), field for field, so a configuration means the same
model in both packages.  The run settings (``RunConfig``) wait for training.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    """Architecture description. One instance per assigned architecture."""

    name: str
    family: str  # dense | moe | encdec | ssm | vlm | hybrid
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0  # 0 -> d_model // num_heads

    # --- MoE ---
    num_experts: int = 0
    experts_per_token: int = 0
    moe_residual: bool = False  # arctic: dense FFN in parallel with MoE
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01

    # --- attention ---
    local_window: int = 0  # >0 for local (sliding-window) attention layers
    rope_theta: float = 10000.0

    # --- layer pattern (hybrid / ssm families) ---
    # Cycle of block kinds, repeated num_layers//len(pattern) times with the
    # remainder unrolled.  Empty -> homogeneous ("dense" or "moe" by family).
    layer_pattern: Tuple[str, ...] = ()

    # --- encoder-decoder (whisper) ---
    encoder_layers: int = 0
    encoder_seq: int = 1500  # precomputed audio-frame embeddings (stub frontend)

    # --- vlm (internvl) ---
    vision_patches: int = 0  # precomputed patch embeddings (stub frontend)

    # --- ssm (xlstm) ---
    slstm_every: int = 8  # one sLSTM block per this many layers

    # --- misc ---
    norm_eps: float = 1e-5
    tie_embeddings: bool = True
    use_bias: bool = False
    act: str = "swiglu"  # swiglu | gelu | geglu
    dtype: str = "bfloat16"
    # logit softcap (gemma-style); 0 disables
    logit_softcap: float = 0.0

    @property
    def resolved_head_dim(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    @property
    def pattern(self) -> Tuple[str, ...]:
        if self.layer_pattern:
            return self.layer_pattern
        if self.family == "encdec":
            return ("xdec",)
        return ("moe",) if self.num_experts > 0 else ("dense",)

    @property
    def is_subquadratic(self) -> bool:
        """True if decode cost is O(1)/window-bounded in context length."""
        quad = {"dense", "moe", "xdec", "enc"}
        return not (set(self.pattern) & quad)

    def param_count(self) -> int:
        """Exact parameter count of the ported families (``model_zoo``)."""
        from repro_torch.models import model_zoo

        return model_zoo.param_count(self)


@dataclasses.dataclass(frozen=True)
class ShapeConfig:
    """One benchmark input shape: what gets lowered in the dry-run."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode

    @property
    def is_serving(self) -> bool:
        return self.kind in ("prefill", "decode")


def reduced(cfg: ModelConfig, **overrides) -> ModelConfig:
    """A tiny same-family variant for CPU smoke tests."""
    base = dict(
        num_layers=max(2, len(cfg.pattern)),
        d_model=64,
        num_heads=max(2, min(cfg.num_heads, 4)),
        num_kv_heads=1,
        d_ff=128 if cfg.d_ff else 0,
        vocab_size=256,
        head_dim=16,
        encoder_layers=2 if cfg.encoder_layers else 0,
        encoder_seq=16 if cfg.encoder_layers else cfg.encoder_seq,
        vision_patches=8 if cfg.vision_patches else 0,
        num_experts=4 if cfg.num_experts else 0,
        experts_per_token=min(2, cfg.experts_per_token) if cfg.num_experts else 0,
        # effectively dropless at smoke scale so prefill/decode token routing
        # matches teacher-forced training exactly
        capacity_factor=4.0 if cfg.num_experts else cfg.capacity_factor,
        local_window=8 if cfg.local_window else 0,
        slstm_every=cfg.slstm_every,
        dtype="float32",
    )
    # keep the structural pattern (e.g. rglru/localattn cycle) intact
    base.update(overrides)
    return dataclasses.replace(cfg, name=cfg.name + "-smoke", **base)
