"""Mixture-of-Experts FFN with capacity-based dispatch, on one device.

The port's counterpart of ``repro.models.moe`` without a mesh (its
``mesh_info is None`` path): a softmax router with top-k selection
renormalised over the k gates, then k slot-wise top-1 dispatches into an
(E, C, D) capacity buffer (GShard semantics: exact, deterministic, tokens
beyond an expert's capacity dropped), a batched SwiGLU expert FFN, and the
gate-weighted combine.  The reference's expert- and tensor-parallel
``shard_map`` paths wait for the sharding item of ROADMAP.md.

Two choices keep the port on the reference's tokens:

* the top-k is a stable descending sort, so equal probabilities go to the
  lower expert index first, as ``lax.top_k`` (``torch.topk`` promises no
  order);
* a dropped (token, slot) pair adds a zero row at position 0 of its expert
  (``index_add_`` on the (E * C) rows, as the reference's ``.at[].add``),
  where an assignment would overwrite the row kept there.

Nothing here reads the device.  The expert products are plain batched
matrix products (``torch.bmm``), which the reference leaves to XLA too.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

from ..configs.base import ModelConfig
from .params import P


def moe_spec(cfg: ModelConfig) -> Dict[str, P]:
    d, f, e = cfg.d_model, cfg.d_ff, cfg.num_experts
    spec = {
        "router": P((d, e), ("embed", "experts"), scale=0.01),
        "wi": P((e, d, f), ("experts", "embed", "mlp")),
        "wg": P((e, d, f), ("experts", "embed", "mlp")),
        "wo": P((e, f, d), ("experts", "mlp", "embed")),
    }
    if cfg.moe_residual:
        spec["res_wi"] = P((d, f), ("embed", "mlp"))
        spec["res_wg"] = P((d, f), ("embed", "mlp"))
        spec["res_wo"] = P((f, d), ("mlp", "embed"))
    return spec


def _capacity(tokens: int, cfg: ModelConfig) -> int:
    """Rows of each expert's buffer for a call of ``tokens`` tokens."""
    cap = int(tokens * cfg.experts_per_token * cfg.capacity_factor / cfg.num_experts)
    return max(cap, 1)


def _dispatch_local(
    x: Tensor,  # (T, D)
    gates: Tensor,  # (T, k) combine weights
    experts: Tensor,  # (T, k) int32 expert ids
    num_experts: int,
    capacity: int,
) -> Tuple[Tensor, Tensor, Tensor, Tensor]:
    """Scatter tokens into per-expert capacity buffers.

    Returns (buffers (E, C, D), expert_ids (T, k), slot_pos (T, k) int32,
    keep (T, k) bool).  A (token, slot) pair's position is the count of
    earlier pairs sent to its expert in slot-major order (slot 0 of every
    token first: it carries the largest gate, so it wins capacity).
    """
    t, k = gates.shape
    e_flat = experts.T.reshape(-1)  # (k T,) slot-major
    onehot = (e_flat[:, None] == torch.arange(num_experts, device=x.device)).to(torch.int32)
    pos_flat = torch.cumsum(onehot, dim=0, dtype=torch.int32) - 1  # (k T, E)
    pos_flat = pos_flat.gather(1, e_flat[:, None].long())[:, 0]
    pos = pos_flat.reshape(k, t).T  # (T, k)
    keep = pos < capacity

    buffers = torch.zeros((num_experts * capacity, x.shape[-1]), dtype=x.dtype, device=x.device)
    for slot in range(k):
        contrib = torch.where(keep[:, slot, None], x, 0.0)
        rows = experts[:, slot] * capacity + torch.where(keep[:, slot], pos[:, slot], 0)
        buffers.index_add_(0, rows, contrib)
    return buffers.view(num_experts, capacity, -1), experts, pos, keep


def _combine_local(
    y_buffers: Tensor,  # (E, C, D)
    gates: Tensor,  # (T, k)
    experts: Tensor,  # (T, k)
    pos: Tensor,  # (T, k)
    keep: Tensor,  # (T, k)
) -> Tensor:
    """Each token's gate-weighted sum of its kept slots' expert outputs; a
    dropped slot gathers row 0 of its expert at weight 0."""
    t, k = gates.shape
    e, c, d = y_buffers.shape
    flat = y_buffers.reshape(e * c, d)
    out = torch.zeros((t, d), dtype=y_buffers.dtype, device=y_buffers.device)
    for slot in range(k):
        got = flat.index_select(0, experts[:, slot] * c + torch.where(keep[:, slot], pos[:, slot], 0))
        w = torch.where(keep[:, slot], gates[:, slot], 0.0)
        out = out + got * w[:, None].to(got.dtype)
    return out


def _expert_ffn(cfg: ModelConfig, wi: Tensor, wg: Tensor, wo: Tensor, xs: Tensor) -> Tensor:
    """xs (E, C, D) -> (E, C, D); weights (E, D, F) and (E, F, D)."""
    up = torch.bmm(xs, wi)
    gate = torch.bmm(xs, wg)
    return torch.bmm(F.silu(gate) * up, wo)


def _route(cfg: ModelConfig, router_w: Tensor, x_flat: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    """Softmax, then top-k renormalised (the Mixtral convention), in float32.
    Returns (probs (T, E) float32, gates (T, k) in x's dtype, experts (T, k)
    int32); equal probabilities go to the lower expert index first."""
    logits = x_flat.float() @ router_w.float()  # (T, E)
    probs = torch.softmax(logits, dim=-1)
    top = torch.sort(probs, dim=-1, descending=True, stable=True)
    k = cfg.experts_per_token
    gates, experts = top.values[:, :k], top.indices[:, :k]
    gates = gates / torch.clamp(gates.sum(dim=-1, keepdim=True), min=1e-9)
    return probs, gates.to(x_flat.dtype), experts.to(torch.int32)


def _moe_local(cfg: ModelConfig, params, x_flat: Tensor) -> Tuple[Tensor, Tensor]:
    """Route, dispatch, experts, combine.  Returns (y (T, D), router probs)."""
    probs, gates, experts = _route(cfg, params["router"], x_flat)
    cap = _capacity(x_flat.shape[0], cfg)
    buffers, e_ids, pos, keep = _dispatch_local(x_flat, gates, experts, cfg.num_experts, cap)
    y_buf = _expert_ffn(cfg, params["wi"], params["wg"], params["wo"], buffers)
    return _combine_local(y_buf, gates, e_ids, pos, keep), probs


def moe_ffn(cfg: ModelConfig, params: Dict[str, Tensor], x: Tensor) -> Tuple[Tensor, Tensor]:
    """MoE FFN sublayer over all B * T tokens of x (B, T, D) at once (the
    capacity counts them all).  With ``cfg.moe_residual`` a dense SwiGLU FFN
    runs in parallel (arctic).  Returns (y (B, T, D), router probs (B T, E))."""
    b, t, d = x.shape
    y, probs = _moe_local(cfg, params, x.reshape(b * t, d))
    y = y.reshape(b, t, d)
    if cfg.moe_residual:
        up = x @ params["res_wi"]
        gate = x @ params["res_wg"]
        y = y + (F.silu(gate) * up) @ params["res_wo"]
    return y, probs


def load_balance_loss(cfg: ModelConfig, probs: Tensor) -> Tensor:
    """Switch-style auxiliary loss from router probabilities (T, E): E times
    the sum over experts of mean router mass x share of top-1 dispatches."""
    probs = probs.float()
    e = cfg.num_experts
    mean_probs = probs.mean(dim=0)
    top1 = torch.argmax(probs, dim=-1)  # the first of equal maxima, as jnp.argmax
    frac = (top1[:, None] == torch.arange(e, device=probs.device)).float().mean(dim=0)
    return e * torch.sum(mean_probs * frac)
