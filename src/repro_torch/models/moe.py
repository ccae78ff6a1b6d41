"""Mixture-of-Experts FFN with capacity-based dispatch.

The port's counterpart of ``repro.models.moe``: a softmax router with top-k
selection renormalised over the k gates, then k slot-wise top-1 dispatches
into an (E, C, D) capacity buffer (GShard semantics: exact, deterministic,
tokens beyond an expert's capacity dropped), a batched SwiGLU expert FFN,
and the gate-weighted combine.

On a mesh the distribution is explicit, as the reference's ``shard_map``:
the sharded bodies run under ``local_map`` on each rank's tokens (the batch
over the data axes), with collectives on the mesh's sub-groups.

  * EP (the experts divide the data axes): expert blocks live on the data
    shards; the capacity buffers go out and back by two all-to-alls over the
    data axes, and each expert's d_ff is split over the model axis where it
    divides, its down-projection's partial sums summed over model.
  * TP (otherwise): every shard holds all experts but a 1/M slice of d_ff;
    the partial sums are summed over the model axis.

The capacity counts a rank's own tokens, as inside the reference's
``shard_map``, so a sharded MoE that drops slots differs from the unsharded
one, in both packages.

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

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

from ..configs.base import ModelConfig
from .layers import ApplyCtx, MeshInfo, checkpoint_name
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


class _SumOverGroup(torch.autograd.Function):
    """The reference's psum inside ``shard_map``: the partial sums of a group
    added on every rank.  Its output is replicated over the group, and the
    gradient arriving there is the loss's (the same on every rank), so each
    partial's gradient is that gradient itself."""

    @staticmethod
    def forward(ctx, x: Tensor, group) -> Tensor:
        out = x.clone()
        torch.distributed.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: Tensor):
        return grad, None


class _CopyToGroup(torch.autograd.Function):
    """The partner of ``_SumOverGroup`` at the input of a d_ff-split product:
    the identity forward; backward, each rank's gradient covers its slice of
    d_ff only, so the group's gradients are summed (Megatron's "f")."""

    @staticmethod
    def forward(ctx, x: Tensor, group) -> Tensor:
        ctx.group = group
        return x

    @staticmethod
    def backward(ctx, grad: Tensor):
        grad = grad.clone()
        torch.distributed.all_reduce(grad, group=ctx.group)
        return grad, None


def _all_to_all(x: Tensor, group) -> Tensor:
    """Chunk i of x's dim 0 goes to the group's rank i; the received chunks
    are stacked along dim 0 in rank order.  Differentiable (the gradient
    goes back by the inverse exchange)."""
    from torch.distributed._functional_collectives import all_to_all_single_autograd

    return all_to_all_single_autograd(x.contiguous(), None, None, group)


def _moe_ep_shard(cfg: ModelConfig, data_group, n_data: int, model_group,
                  ctx: ApplyCtx, router_w, wi, wg, wo, x_flat):
    """EP over the data axes x TP (d_ff) over the model axis, on one rank's
    tokens: route and dispatch locally; (E, C, D) -> (E / n, n C, D) by an
    all-to-all over the data axes, so every data shard receives the buffers
    of its expert block; the experts (d_ff sliced), summed over model; the
    inverse exchange; the combine."""
    probs, gates, experts = _route(cfg, router_w, x_flat)
    cap = _capacity(x_flat.shape[0], cfg)
    buffers, e_ids, pos, keep = _dispatch_local(x_flat, gates, experts, cfg.num_experts, cap)
    e, c, d = buffers.shape
    # chunk j of the experts to data shard j; the received (n, E/n, C, D)
    # laid out (E/n, n C, D), the senders' buffers side by side
    recv = _all_to_all(buffers, data_group).view(n_data, e // n_data, c, d)
    recv = checkpoint_name(recv.transpose(0, 1).reshape(e // n_data, n_data * c, d), "moe_recv", ctx)
    if model_group is None:
        y_loc = _expert_ffn(cfg, wi, wg, wo, recv)
    else:
        y_loc = _expert_ffn(cfg, wi, wg, wo, _CopyToGroup.apply(recv, model_group))
        y_loc = _SumOverGroup.apply(y_loc, model_group)
    # back: (E/n, n C, D) -> (n, E/n, C, D), chunk j to data shard j
    back = y_loc.view(e // n_data, n_data, c, d).transpose(0, 1)
    back = checkpoint_name(_all_to_all(back, data_group).reshape(e, c, d), "moe_back", ctx)
    return _combine_local(back, gates, e_ids, pos, keep), probs


def _moe_tp_shard(cfg: ModelConfig, model_group, router_w, wi, wg, wo, x_flat):
    """Experts replicated, d_ff sliced over the model axis on one rank's
    tokens; the down-projection's partial sums summed over model."""
    probs, gates, experts = _route(cfg, router_w, x_flat)
    cap = _capacity(x_flat.shape[0], cfg)
    buffers, e_ids, pos, keep = _dispatch_local(x_flat, gates, experts, cfg.num_experts, cap)
    if model_group is None:
        y_buf = _expert_ffn(cfg, wi, wg, wo, buffers)
    else:
        y_buf = _expert_ffn(cfg, wi, wg, wo, _CopyToGroup.apply(buffers, model_group))
        y_buf = _SumOverGroup.apply(y_buf, model_group)
    return _combine_local(y_buf, gates, e_ids, pos, keep), probs


def _group(mi: MeshInfo, axes):
    """The process group of one mesh axis or of several flattened together."""
    if len(axes) == 1:
        return mi.mesh.get_group(axes[0])
    return mi.mesh[tuple(axes)]._flatten().get_group()


def moe_path(cfg: ModelConfig, mi: Optional[MeshInfo]) -> str:
    """The reference's choice of path: "local" without a mesh (or on a
    one-shard one), "ep" when the experts divide the data axes, else "tp"."""
    if mi is None:
        return "local"
    n_data = mi.size(mi.batch_axes)
    if mi.model_axis is None and n_data == 1:
        return "local"
    return "ep" if n_data > 1 and cfg.num_experts % n_data == 0 else "tp"


def _moe_on_mesh(cfg: ModelConfig, params, x: Tensor, ctx: ApplyCtx, path: str):
    """The sharded body under ``local_map``: x (B, T, D) with the batch over
    the data axes.  Returns (y (B, T, D), probs (B T, E)), the batch over the
    data axes, both replicated over model.  A rank's gradient of a weight
    that other ranks' tokens also reach is a partial sum over the data axes:
    the router's, and the experts' on the TP path, where every data shard
    holds every expert.  x's gradient is whole (``_CopyToGroup``)."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    mi = ctx.mesh_info
    n_model = mi.size(mi.model_axis) if mi.model_axis else 1
    d = x.shape[-1]
    names = mi.mesh.mesh_dim_names
    over_data = lambda pl: tuple(Partial() if names[m] in mi.batch_axes else p
                                 for m, p in enumerate(pl))
    if path == "ep":  # d_ff over model where it divides
        f_ax = mi.model_axis if n_model > 1 and cfg.d_ff % n_model == 0 else None
        e_ax = mi.batch_axes
    else:
        f_ax, e_ax = (mi.model_axis if n_model > 1 else None), None
    model_group = None if f_ax is None else _group(mi, (f_ax,))
    w_pl = (mi.placements(e_ax, None, f_ax), mi.placements(e_ax, None, f_ax),
            mi.placements(e_ax, f_ax, None))
    if path == "ep":
        data_group, n_data = _group(mi, mi.batch_axes), mi.size(mi.batch_axes)
        body = lambda *a: _moe_ep_shard(cfg, data_group, n_data, model_group, ctx, *a)
        w_grad = w_pl
    else:
        body = lambda *a: _moe_tp_shard(cfg, model_group, *a)
        w_grad = tuple(over_data(pl) for pl in w_pl)

    def wrapped(router_w, wi, wg, wo, xb):
        y, probs = body(router_w, wi, wg, wo, xb.reshape(-1, d))
        return y.reshape(xb.shape), probs

    x_pl = mi.placements(mi.batch_axes, None, None)
    router_pl = mi.placements(None, None)
    return local_map(
        wrapped, out_placements=(x_pl, mi.placements(mi.batch_axes, None)),
        in_placements=(router_pl, *w_pl, x_pl),
        in_grad_placements=(over_data(router_pl), *w_grad, x_pl),
        device_mesh=mi.mesh, redistribute_inputs=True,
    )(params["router"], params["wi"], params["wg"], params["wo"], x)


def moe_ffn(cfg: ModelConfig, params: Dict[str, Tensor], x: Tensor,
            ctx: Optional[ApplyCtx] = None) -> Tuple[Tensor, Tensor]:
    """MoE FFN sublayer.  Without a mesh over all B * T tokens of x (B, T, D)
    at once (the capacity counts them all); on a mesh (``ctx.mesh_info``) by
    the path ``moe_path`` picks, each rank over its own tokens.  With
    ``cfg.moe_residual`` a dense SwiGLU FFN runs in parallel (arctic).
    Returns (y (B, T, D), router probs (B T, E))."""
    b, t, d = x.shape
    mi = None if ctx is None else ctx.mesh_info
    path = moe_path(cfg, mi)
    if path == "local":
        y, probs = _moe_local(cfg, params, x.reshape(b * t, d))
        y = y.reshape(b, t, d)
    else:
        y, probs = _moe_on_mesh(cfg, params, x, ctx, path)
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
