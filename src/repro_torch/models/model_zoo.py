"""Model zoo: config -> spec, parameters, apply, and parameter counts.

The port's counterpart of ``repro.models.model_zoo`` for the families it
runs (dense, vision, hybrid, MoE and encoder-decoder).  A batch holds
``tokens`` and, by family, ``vision`` (B, vision_patches, d_model) patch
embeddings or ``frames`` (B, encoder_seq, d_model) for the encoder.
``init_model_params`` and ``init_cache`` are entry points: they run on the
card unless a device is named.  ``abstract_model_params``, ``model_axes``,
``input_specs`` and ``abstract_cache`` give shapes (tensors on the ``meta``
device) and logical axes for the sharding rules.
"""
from __future__ import annotations

import math
from typing import Any, Dict, Optional

import torch
from torch import Tensor

from ..configs.base import ModelConfig, ShapeConfig
from ..device import resolve_device
from . import encdec, transformer
from .layers import ApplyCtx, mesh_scope
from .params import (
    abstract_params,
    axes_tree,
    init_params,
    leaves,
    param_count as spec_param_count,
)


def model_spec(cfg: ModelConfig) -> Dict[str, Any]:
    spec = transformer.lm_spec(cfg)
    if cfg.family == "encdec":
        spec["encoder"] = encdec.encoder_spec(cfg)
    return spec


def model_dtype(cfg: ModelConfig) -> torch.dtype:
    return {"bfloat16": torch.bfloat16, "float32": torch.float32}[cfg.dtype]


def init_model_params(cfg: ModelConfig, *, seed: int, device=None):
    """Random parameters in the model dtype, drawn on ``device`` from a
    generator seeded with ``seed``."""
    device = resolve_device(device)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    return init_params(model_spec(cfg), gen, model_dtype(cfg), device)


def abstract_model_params(cfg: ModelConfig):
    return abstract_params(model_spec(cfg), model_dtype(cfg))


def model_axes(cfg: ModelConfig):
    return axes_tree(model_spec(cfg))


def param_count(cfg: ModelConfig, active_only: bool = False) -> int:
    """Exact parameter count from the spec tree.

    active_only: count each MoE expert tensor at k/E of its size (the
    parameters one token uses), as the reference does.
    """
    spec = model_spec(cfg)
    if not active_only or cfg.num_experts == 0:
        return spec_param_count(spec)
    frac = cfg.experts_per_token / cfg.num_experts
    return int(sum(math.prod(p.shape) * (frac if "experts" in p.axes else 1)
                   for p in leaves(spec)))


def _encode(cfg: ModelConfig, params, batch: Dict[str, Tensor], ctx: ApplyCtx) -> Optional[Tensor]:
    if cfg.family != "encdec":
        return None
    return encdec.encode(cfg, params["encoder"], batch["frames"], ctx=ctx)


def forward_train(cfg: ModelConfig, params, batch: Dict[str, Tensor], *, ctx: ApplyCtx):
    """(logits, aux_loss) for a batch dict; differentiable."""
    with mesh_scope(ctx):
        return transformer.forward_train(cfg, params, batch["tokens"], ctx=ctx,
                                         vision=batch.get("vision"),
                                         enc_out=_encode(cfg, params, batch, ctx))


def prefill(cfg: ModelConfig, params, batch: Dict[str, Tensor], cache, *, ctx: ApplyCtx):
    with mesh_scope(ctx):
        return transformer.prefill(cfg, params, batch["tokens"], cache, ctx=ctx,
                                   vision=batch.get("vision"),
                                   enc_out=_encode(cfg, params, batch, ctx))


def decode_step(cfg: ModelConfig, params, token: Tensor, cache, *, ctx: ApplyCtx):
    return transformer.decode_step(cfg, params, token, cache, ctx=ctx)


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype: Optional[torch.dtype] = None,
               *, device=None):
    return transformer.init_cache(cfg, batch, max_len, dtype or model_dtype(cfg),
                                  resolve_device(device))


# ---------------------------------------------------------------------------
# input specs (shape-only tensors: the sharding rules' and the dry run's)
# ---------------------------------------------------------------------------


def input_specs(cfg: ModelConfig, shape: ShapeConfig, num_microbatches: int = 1) -> Dict[str, Any]:
    """Shape-only inputs (``meta`` tensors) for one (arch, shape) cell.

    train:   {tokens, labels[, vision][, frames]}, shaped (M, B/M, ...) (dim 1
             is the data-sharded batch dim).
    prefill: {tokens[, vision][, frames]}
    decode:  {token} (the cache: ``abstract_cache``)
    """
    b, t = shape.global_batch, shape.seq_len
    meta = lambda *dims, dtype=torch.int32: torch.empty(dims, dtype=dtype, device="meta")
    specs: Dict[str, Any] = {}
    if shape.kind == "decode":
        specs["token"] = meta(b, 1)
        return specs
    if shape.kind == "train":
        m = num_microbatches
        if b % m:
            raise ValueError(f"batch {b} not divisible into {m} microbatches")
        lead = (m, b // m)
    elif shape.kind == "prefill":
        lead = (b,)
    else:
        raise ValueError(shape.kind)
    text = t
    if cfg.vision_patches:
        text = t - cfg.vision_patches
        specs["vision"] = meta(*lead, cfg.vision_patches, cfg.d_model, dtype=torch.float32)
    if cfg.family == "encdec":
        specs["frames"] = meta(*lead, cfg.encoder_seq, cfg.d_model, dtype=torch.float32)
    specs["tokens"] = meta(*lead, text)
    if shape.kind == "train":
        specs["labels"] = meta(*lead, text)
    return specs


def abstract_cache(cfg: ModelConfig, shape: ShapeConfig):
    """Shape-only decode cache (``seq_len`` deep) for the decode cells."""
    return init_cache(cfg, shape.global_batch, shape.seq_len, device="meta")
