"""Serving steps: prefill (build the cache) and decode (one token vs cache).

The port's counterpart of ``repro.train.serve_step``; sampling is greedy
argmax of the last-position logits.
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
from torch import Tensor

from ..configs.base import ModelConfig
from ..models import model_zoo
from ..models.layers import ApplyCtx


def make_prefill_step(cfg: ModelConfig, *, ctx: ApplyCtx) -> Callable:
    def prefill_fn(params, batch: Dict[str, Tensor], cache):
        logits, cache = model_zoo.prefill(cfg, params, batch, cache, ctx=ctx)
        return torch.argmax(logits, dim=-1).to(torch.int32)[:, None], cache

    return prefill_fn


def make_decode_step(cfg: ModelConfig, *, ctx: ApplyCtx) -> Callable:
    def decode_fn(params, token: Tensor, cache):
        logits, cache = model_zoo.decode_step(cfg, params, token, cache, ctx=ctx)
        return torch.argmax(logits, dim=-1).to(torch.int32)[:, None], cache

    return decode_fn


def generate(cfg: ModelConfig, params, batch: Dict[str, Tensor], max_len: int, steps: int, *,
             ctx_prefill: ApplyCtx, ctx_decode: ApplyCtx) -> Tensor:
    """Greedy generation of ``steps`` tokens (B, steps) on the tokens' device,
    with a float32 cache as the reference.  ``max_len`` counts text rows: the
    cache holds ``cfg.vision_patches`` rows more for a vision prefix (the
    reference's cache is ``max_len`` deep and its prefill fails when the
    prefix does not fit)."""
    tokens = batch["tokens"]
    cache = model_zoo.init_cache(cfg, tokens.shape[0], cfg.vision_patches + max_len,
                                 torch.float32, device=tokens.device)
    token, cache = make_prefill_step(cfg, ctx=ctx_prefill)(params, batch, cache)
    outs = [token]
    decode_fn = make_decode_step(cfg, ctx=ctx_decode)
    for _ in range(steps - 1):
        token, cache = decode_fn(params, token, cache)
        outs.append(token)
    return torch.cat(outs, dim=1)
