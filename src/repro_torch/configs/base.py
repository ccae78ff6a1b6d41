"""Config dataclasses: model architecture, input shapes and run settings.

A copy of the reference's ``ModelConfig``, ``ShapeConfig``, ``RunConfig``
and ``reduced`` (``repro.configs.base``), field for field with the same
defaults, so a configuration means the same model and run in both packages.
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Tuple


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


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """Training/serving run settings (driver-level)."""

    model: ModelConfig
    shape: ShapeConfig
    microbatch_per_device: int = 1
    learning_rate: float = 3e-4
    warmup_steps: int = 100
    total_steps: int = 1000
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    remat: str = "full"  # none | full | dots | outs (models.layers.ApplyCtx.remat)
    # AdamW moment dtype: bfloat16 for 100B+ models (HBM-fitting trade)
    optimizer_dtype: str = "float32"
    # gradient accumulation dtype (bfloat16 halves grad buffers; error is
    # bounded by the later f32 optimizer math)
    grad_dtype: str = "float32"
    seed: int = 0
    # distribution
    multi_pod: bool = False
    # partitioner (the paper's feature)
    partitioner_enabled: bool = True
    partitioner_risk_aversion: float = 0.0
    partitioner_refit_every: int = 16  # drain cadence (steps per ring drain)
    # propose cadence (repro_torch.serve drift gate): re-solve the split only
    # when the posterior moved more than the threshold since the last solve,
    # or after max_staleness drains, whichever comes first.  None opts into
    # the self-calibrating EWMA gate (repro_torch.serve.gate).
    partitioner_drift_threshold: Optional[float] = 0.02
    partitioner_max_staleness: int = 4
    # fault tolerance
    checkpoint_every: int = 100
    checkpoint_dir: str = "/tmp/repro_ckpt"
    keep_checkpoints: int = 3
    straggler_threshold_sigma: float = 3.0
    # gradient compression: none | int8_ef | topk_ef
    grad_compression: str = "none"


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
