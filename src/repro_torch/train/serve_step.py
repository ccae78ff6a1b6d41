"""Serving steps: prefill (build the cache) and decode (one token vs cache).

The port's counterpart of ``repro.train.serve_step``; sampling is greedy
argmax of the last-position logits (``greedy``: on a mesh that splits the
vocab, shard by shard and merged by two all-reduces).
"""
from __future__ import annotations

from typing import Callable, Dict

import torch
from torch import Tensor

from ..configs.base import ModelConfig
from ..device import is_dtensor
from ..models import model_zoo
from ..models.layers import ApplyCtx


def greedy(logits: Tensor) -> Tensor:
    """``torch.argmax(logits, dim=-1)`` as int32 (B, 1).  Of a DTensor whose
    vocab (the last dim) one mesh dim splits, shard by shard under
    ``local_map``: each shard's maximum and the first global index that
    reaches it, then a max all-reduce of the maxima and a min all-reduce of
    the indices that reach the greatest, over that mesh dim: the first
    maximum, as torch's argmax of the whole row.  DTensor's own argmax
    gathers the row, or the shards' pairs, by a path that differs by torch
    version and fails on some layouts (a batch of one)."""
    last = logits.ndim - 1
    split = [m for m, p in enumerate(logits.placements) if p.is_shard(last)] \
        if is_dtensor(logits) else []
    if len(split) != 1:
        return torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    mesh, dim = logits.device_mesh, split[0]
    group, n = mesh.get_group(dim), logits.shape[last] // mesh.size(dim)
    lo = mesh.get_local_rank(dim) * n

    def first_max(x):
        top, idx = torch.max(x, dim=-1)
        best = top.clone()
        dist.all_reduce(best, dist.ReduceOp.MAX, group=group)
        idx = torch.where(top == best, idx + lo, logits.shape[last])
        dist.all_reduce(idx, dist.ReduceOp.MIN, group=group)
        return idx

    pl = logits.placements
    out = tuple(Replicate() if p.is_shard(last) else p for p in pl)
    idx = local_map(first_max, out_placements=(out,), in_placements=(pl,), device_mesh=mesh)(logits)
    return idx.to(torch.int32)[:, None]


def make_prefill_step(cfg: ModelConfig, *, ctx: ApplyCtx) -> Callable:
    def prefill_fn(params, batch: Dict[str, Tensor], cache):
        logits, cache = model_zoo.prefill(cfg, params, batch, cache, ctx=ctx)
        return greedy(logits), cache

    return prefill_fn


def make_decode_step(cfg: ModelConfig, *, ctx: ApplyCtx) -> Callable:
    def decode_fn(params, token: Tensor, cache):
        logits, cache = model_zoo.decode_step(cfg, params, token, cache, ctx=ctx)
        return greedy(logits), cache

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
