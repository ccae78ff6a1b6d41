"""Encoder-decoder assembly (whisper-style).

The port's counterpart of ``repro.models.encdec``.  The audio/conv frontend
is a stub, as in the reference: the encoder takes precomputed frame
embeddings (B, encoder_seq, d_model).  Encoder = ``enc`` blocks (roped,
non-causal self-attention, no cache); decoder = causal self-attention plus
cross-attention (the ``xdec`` blocks of ``transformer``).
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict

import torch
from torch import Tensor

from ..configs.base import ModelConfig
from .layers import ApplyCtx, rmsnorm, rmsnorm_spec
from .params import P, stack_spec
from .transformer import _run_stack, block_spec


def encoder_cfg(cfg: ModelConfig) -> ModelConfig:
    return dataclasses.replace(cfg, num_layers=cfg.encoder_layers, layer_pattern=("enc",))


def encoder_spec(cfg: ModelConfig) -> Dict[str, Any]:
    ecfg = encoder_cfg(cfg)
    d = cfg.d_model
    return {
        "in_proj": P((d, d), ("embed", None)),
        "cycles": [stack_spec(block_spec(ecfg, "enc"), ecfg.num_layers)],
        "rest": [],
        "final_norm": rmsnorm_spec(d),
    }


def encode(cfg: ModelConfig, enc_params: Dict[str, Any], frames: Tensor, *,
           ctx: ApplyCtx) -> Tensor:
    """frames (B, encoder_seq, d_model) -> enc_out (B, encoder_seq, d_model).
    The encoder always runs the full sequence in train mode, whatever
    ``ctx.mode`` (prefill calls it), so it launches no decode kernel."""
    ecfg = encoder_cfg(cfg)
    x = frames.to(enc_params["in_proj"].dtype) @ enc_params["in_proj"]
    positions = torch.arange(x.shape[1], device=x.device)
    x, _ = _run_stack(ecfg, enc_params, x, ctx=dataclasses.replace(ctx, mode="train"),
                      positions=positions, length=None, cache=None)
    return rmsnorm(enc_params["final_norm"], x, cfg.norm_eps)
