"""Recurrent sequence mixers: mLSTM and sLSTM (xLSTM), and the RG-LRU block
(Griffin / RecurrentGemma).

The port's counterpart of ``repro.models.recurrent``.

  * mLSTM: train and prefill run the stabilised parallel (quadratic) form,
    chunked over queries as attention is; prefill then fills the decode
    cache (C, n, m) from the whole sequence; decode is the one-step
    stabilised recurrence.
  * sLSTM: the recurrent h feeds the gates, so train and prefill loop over
    time on the device (no host read inside the loop); decode is one step.
  * RG-LRU: prefill and train run the linear recurrence h_t = a_t h_{t-1} +
    b_t through ``kernels.ops.lru_scan`` (K3); decode is its one elementwise
    step on the float32 state.  On a mesh K3 runs under ``local_map`` on each
    shard's (batch, channel) block: the recurrence is per channel, so each
    shard's scan is exact.

Every block writes its cache's state in place in prefill and decode; the
states are float32 whatever the parameters' dtype.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

from ..configs.base import ModelConfig
from ..kernels import ops
from ..device import is_dtensor
from .layers import (
    NEG_INF,
    ApplyCtx,
    MeshInfo,
    _seq_shard,
    constrain,
    heads_product,
    pin_heads,
    write_state,
)
from .params import P

# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------


def mlstm_spec(cfg: ModelConfig) -> Dict[str, P]:
    d, h = cfg.d_model, cfg.num_heads
    hd = d // h  # cell width == d_model (projection factor 1)
    return {
        "wq": P((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": P((d, h, hd), ("embed", "heads", "head_dim")),
        "wv": P((d, h, hd), ("embed", "heads", "head_dim")),
        "wif": P((d, 2 * h), ("embed", None), scale=0.01),  # i, f gate pre-activations
        "wog": P((d, h, hd), ("embed", "heads", "head_dim"), scale=0.01),
        "wo": P((h, hd, d), ("heads", "head_dim", "embed")),
        "bif": P((2 * h,), (None,), init="zeros"),
    }


def _log_sigmoid(x: Tensor) -> Tensor:
    """``F.logsigmoid``; a DTensor's on each shard under ``local_map`` (a
    partial sum first made whole), because DTensor registers no sharding
    strategy for its forward or its backward in some torch versions.  It is
    elementwise, so each shard's is exact."""
    if not is_dtensor(x):
        return F.logsigmoid(x)
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    pl = tuple(Replicate() if p.is_partial() else p for p in x.placements)
    return local_map(F.logsigmoid, out_placements=(pl,), in_placements=(pl,),
                     device_mesh=x.device_mesh, redistribute_inputs=True)(x)


def _mlstm_qkv(cfg: ModelConfig, params, x: Tensor, mi: Optional[MeshInfo] = None):
    """q, k, v and the output gate o (B, H, T, hd) in x's dtype; log i and
    log f (B, H, T) in float32, cast after the gates are computed in x's
    dtype, as the reference casts them.  On a mesh each head's q, k, v and
    gates lie on one shard (the heads over the model axis where they divide
    it): the products run shard by shard (``heads_product``) and the gates
    are pinned before their slices."""
    h = cfg.num_heads
    hd = x.shape[-1] // h
    eq = "btd,dhk->bhtk"
    if mi is None:
        proj = lambda w: torch.einsum(eq, x, w)
    else:
        proj = lambda w: heads_product(eq, x, w, mi, 1, out_dim=1)
    q = proj(params["wq"])
    # the scale is cast to the activations' dtype first, as JAX's weak scalar is
    k = proj(params["wk"]) * torch.tensor(hd**-0.5, dtype=x.dtype, device=x.device)
    v = proj(params["wv"])
    gates = x @ params["wif"] + params["bif"]  # (B, T, 2H)
    if mi is not None:
        gates = constrain(gates, mi, (mi.split(mi.batch_axes, x.shape[0]), None, None))
    log_i = gates[..., :h].transpose(1, 2).float()
    log_f = _log_sigmoid(gates[..., h:]).transpose(1, 2).float()
    o = torch.sigmoid(proj(params["wog"]))
    if mi is not None:
        log_i, log_f = (pin_heads(a, mi, 1, h) for a in (log_i, log_f))
    return q, k, v, log_i, log_f, o


def _mlstm_parallel(cfg: ModelConfig, params, x: Tensor, ctx: ApplyCtx):
    """The stabilised quadratic form, chunked over queries by ``ctx.q_chunk``
    (one chunk of T when T is not a multiple of it).  Returns (y, (k, v,
    log_i, fcum)), what ``mlstm_final_state`` needs."""
    t = x.shape[1]
    q, k, v, log_i, log_f, o = _mlstm_qkv(cfg, params, x, ctx.mesh_info)
    fcum = torch.cumsum(log_f, dim=-1)  # (B, H, T): F_t = sum_{s <= t} log f_s
    k32, v32 = k.float(), v.float()
    pos = torch.arange(t, device=x.device)

    def chunk_out(q_c, fcum_c, tpos_c):
        q_c = _seq_shard(q_c, ctx, 2)
        # the decay matrix D~[t, s] = F_t - F_s + log i_s for s <= t
        dmat = fcum_c[..., :, None] - fcum[..., None, :] + log_i[..., None, :]
        dmat = torch.where(tpos_c[:, None] >= pos[None, :], dmat, NEG_INF)
        m = torch.clamp(dmat.amax(dim=-1, keepdim=True), min=-1e30)  # (B, H, qc, 1)
        scores = torch.einsum("bhqk,bhsk->bhqs", q_c.float(), k32) * torch.exp(dmat - m)
        norm = torch.maximum(scores.sum(dim=-1, keepdim=True).abs(), torch.exp(-m))
        return _seq_shard(torch.einsum("bhqs,bhsk->bhqk", scores / norm, v32), ctx, 2)

    chunk = min(ctx.q_chunk, t)
    if t % chunk != 0:
        chunk = t
    hh = torch.cat([chunk_out(q[:, :, s:s + chunk], fcum[..., s:s + chunk], pos[s:s + chunk])
                    for s in range(0, t, chunk)], dim=2)
    hh = (o.float() * hh).to(x.dtype)  # (B, H, T, hd)
    eq = "bhtk,hkd->btd"
    if ctx.mesh_info is None:
        y = torch.einsum(eq, hh, params["wo"])
    else:
        y = heads_product(eq, hh, params["wo"], ctx.mesh_info, 0, x_dim=1)
    return y, (k32, v32, log_i, fcum)


def mlstm_final_state(k32: Tensor, v32: Tensor, log_i: Tensor, fcum: Tensor) -> Dict[str, Tensor]:
    """The state (C, n, m) after a parallel pass, from its float32 k and v:
    what a prefill leaves in the decode cache."""
    w_log = fcum[..., -1:] - fcum + log_i  # (B, H, T): the weight of step s in C_T
    m = w_log.amax(dim=-1)  # (B, H)
    w = torch.exp(w_log - m[..., None])
    c = torch.einsum("bht,bhtk,bhtl->bhkl", w, v32, k32)
    n = torch.einsum("bht,bhtk->bhk", w, k32)
    return {"C": c, "n": n, "m": m}


def init_mlstm_cache(cfg: ModelConfig, batch: int, device) -> Dict[str, Tensor]:
    h = cfg.num_heads
    hd = cfg.d_model // h
    return {
        "C": torch.zeros((batch, h, hd, hd), dtype=torch.float32, device=device),
        "n": torch.zeros((batch, h, hd), dtype=torch.float32, device=device),
        "m": torch.full((batch, h), -1e30, dtype=torch.float32, device=device),
    }


def _mlstm_step(cfg: ModelConfig, params, x: Tensor, cache: Dict[str, Tensor],
                mi: Optional[MeshInfo] = None):
    """One stabilised recurrent step of x (B, 1, D) from the cache's state.
    Returns (y, the new state)."""
    q, k, v, log_i, log_f, o = _mlstm_qkv(cfg, params, x, mi)  # T == 1
    q1, k1, v1 = (a[:, :, 0].float() for a in (q, k, v))  # (B, H, hd)
    li, lf = log_i[..., 0], log_f[..., 0]  # (B, H)
    m_prev = cache["m"]
    m_new = torch.maximum(lf + m_prev, li)
    i_p = torch.exp(li - m_new)[..., None]
    f_p = torch.exp(lf + m_prev - m_new)[..., None]
    c_new = f_p[..., None] * cache["C"] + i_p[..., None] * (v1[..., :, None] * k1[..., None, :])
    n_new = f_p * cache["n"] + i_p * k1
    num = torch.einsum("bhkl,bhl->bhk", c_new, q1)
    den = torch.maximum(torch.einsum("bhk,bhk->bh", n_new, q1).abs()[..., None],
                        torch.exp(-m_new)[..., None])
    hh = (o[:, :, 0].float() * num / den).to(x.dtype)  # (B, H, hd)
    y = torch.einsum("bhk,hkd->bd", hh, params["wo"])[:, None, :]
    return y, {"C": c_new, "n": n_new, "m": m_new}


def mlstm_block(
    cfg: ModelConfig,
    params: Dict[str, Tensor],
    x: Tensor,
    *,
    ctx: ApplyCtx,
    cache: Optional[Dict[str, Tensor]] = None,
) -> Tuple[Tensor, Optional[Dict[str, Tensor]]]:
    """Returns (y, cache).  Prefill starts from the zero state whatever the
    cache holds, as the reference does, and leaves the final state in the
    cache; decode advances the cache's state one step.  Both write in place."""
    if ctx.mode == "decode":
        assert cache is not None
        y, state = _mlstm_step(cfg, params, x, cache, ctx.mesh_info)
    else:
        y, (k32, v32, log_i, fcum) = _mlstm_parallel(cfg, params, x, ctx)
        if ctx.mode != "prefill" or cache is None:
            return y, cache
        state = mlstm_final_state(k32, v32, log_i, fcum)
    for key, value in state.items():
        write_state(cache[key], value)
    return y, cache


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------


def slstm_spec(cfg: ModelConfig) -> Dict[str, P]:
    d, h = cfg.d_model, cfg.num_heads
    hd = d // h
    return {
        "wx": P((d, 4, h, hd), ("embed", None, "heads", "head_dim")),
        "r": P((4, h, hd, hd), (None, "heads", "head_dim", None), scale=0.01),
        "b": P((4, h, hd), (None, "heads", "head_dim"), init="zeros"),
        "wo": P((h, hd, d), ("heads", "head_dim", "embed")),
    }


_SLSTM_STATE = ("c", "n", "h", "m")


def init_slstm_cache(cfg: ModelConfig, batch: int, device) -> Dict[str, Tensor]:
    h = cfg.num_heads
    shape = (batch, h, cfg.d_model // h)
    cache = {key: torch.zeros(shape, dtype=torch.float32, device=device) for key in "cnh"}
    cache["m"] = torch.full(shape, -1e30, dtype=torch.float32, device=device)
    return cache


def _slstm_step(r_rows: Tensor, b32: Tensor, state: Tuple[Tensor, ...], xt: Tensor):
    """One sLSTM step.  xt: (B, 4, H, hd) float32 pre-activations from the
    input; r_rows: the recurrent weights in float32 as (H, hd, 4 hd), one
    block-diagonal product per head; b32: the biases (4, H, hd) in float32.
    Returns the new (c, n, h, m)."""
    c, n, h_prev, m_prev = state
    b, heads, hd = h_prev.shape
    rec = torch.bmm(h_prev.transpose(0, 1), r_rows).view(heads, b, 4, hd).permute(1, 2, 0, 3)
    pre = xt + rec + b32  # (B, 4, H, hd)
    z = torch.tanh(pre[:, 0])
    log_i = pre[:, 1]
    log_f = F.logsigmoid(pre[:, 2])
    o = torch.sigmoid(pre[:, 3])
    m_new = torch.maximum(log_f + m_prev, log_i)
    i_p = torch.exp(log_i - m_new)
    f_p = torch.exp(log_f + m_prev - m_new)
    c_new = f_p * c + i_p * z
    n_new = torch.clamp(f_p * n + i_p, min=1e-6)
    return c_new, n_new, o * (c_new / n_new), m_new


def _slstm_loop(r_rows: Tensor, b32: Tensor, pre: Tensor, *state: Tensor):
    """The step over pre's T positions from ``state`` (c, n, h, m).  Returns
    the h of every step (B, T, H, hd) in float32 and the last state."""
    hs = []
    for i in range(pre.shape[1]):
        state = _slstm_step(r_rows, b32, state, pre[:, i])
        hs.append(state[2])
    return (torch.stack(hs, dim=1), *state)


def _slstm_loop_on_mesh(mi: MeshInfo, heads: int, r_rows: Tensor, b32: Tensor, pre: Tensor,
                        state: Tuple[Tensor, ...]):
    """``_slstm_loop`` shard by shard under ``local_map``: each shard steps
    its batch rows (over the data axes where they divide them) and its heads
    (over the model axis where they divide it).  A step mixes nothing
    across rows or heads, so each shard's loop is exact, and DTensor
    dispatches nothing inside it.  The weights' gradients are partial sums
    over the data axes that split the batch."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    batch, split = mi.split(mi.batch_axes, pre.shape[0]), mi.split(mi.model_axis, heads)
    rows, seq = mi.placements(batch, split, None), mi.placements(batch, None, None, split, None)
    out = mi.placements(batch, None, split, None)
    weights = (mi.placements(split, None, None), mi.placements(None, split, None))
    grads = tuple(tuple(Partial() if q.is_shard(0) else p for p, q in zip(pl, rows))
                  for pl in weights)
    r_rows, b32, pre, *state = (a if is_dtensor(a) else constrain(a, mi, spec)
                                for a, spec in zip((r_rows, b32, pre, *state),
                                                   ((split, None, None), (None, split, None),
                                                    (batch, None, None, split, None))
                                                   + ((batch, split, None),) * len(state)))
    return local_map(_slstm_loop, out_placements=(out,) + (rows,) * len(state),
                     in_placements=weights + (seq,) + (rows,) * len(state),
                     in_grad_placements=grads + (seq,) + (rows,) * len(state),
                     device_mesh=mi.mesh, redistribute_inputs=True)(r_rows, b32, pre, *state)


def slstm_block(
    cfg: ModelConfig,
    params: Dict[str, Tensor],
    x: Tensor,
    *,
    ctx: ApplyCtx,
    cache: Optional[Dict[str, Tensor]] = None,
) -> Tuple[Tensor, Optional[Dict[str, Tensor]]]:
    """Returns (y, cache).  Every mode runs the step over x's T positions from
    the cache's state (the zero state without a cache), in a loop on the
    device that reads nothing back; decode is the loop at T = 1.  Prefill
    and decode leave the last state in the cache, in place.  On a mesh the
    input product and the loop run shard by shard (``heads_product``,
    ``_slstm_loop_on_mesh``), each head on one shard where the heads divide
    the model axis."""
    b, t, _ = x.shape
    mi = ctx.mesh_info
    eq = "btd,dghk->btghk"
    if mi is None:
        pre = torch.einsum(eq, x, params["wx"]).float()  # (B, T, 4, H, hd)
    else:
        pre = heads_product(eq, x, params["wx"], mi, 2, out_dim=3).float()
    r = params["r"].float()  # (4, H, hd, hd): the reference promotes it to h's float32
    r_rows = r.permute(1, 2, 0, 3).reshape(r.shape[1], r.shape[2], -1)
    b32 = params["b"].float()
    start = init_slstm_cache(cfg, b, x.device) if cache is None else cache
    state = tuple(start[key] for key in _SLSTM_STATE)
    if mi is None:
        hh, *state = _slstm_loop(r_rows, b32, pre, *state)
    else:
        hh, *state = _slstm_loop_on_mesh(mi, cfg.num_heads, r_rows, b32, pre, state)
    hh = hh.to(x.dtype)  # (B, T, H, hd)
    eq = "bthk,hkd->btd"
    y = torch.einsum(eq, hh, params["wo"]) if mi is None else \
        heads_product(eq, hh, params["wo"], mi, 0, x_dim=2)
    if cache is not None and ctx.mode != "train":
        for key, value in zip(_SLSTM_STATE, state):
            write_state(cache[key], value)
    return y, cache


# ---------------------------------------------------------------------------
# RG-LRU (Griffin / RecurrentGemma)
# ---------------------------------------------------------------------------

_RGLRU_C = 8.0
_CONV_W = 4


def rglru_spec(cfg: ModelConfig) -> Dict[str, P]:
    d = cfg.d_model
    r = d  # lru width == d_model for recurrentgemma
    return {
        "w_in": P((d, r), ("embed", "rnn")),
        "w_gate": P((d, r), ("embed", "rnn")),
        "conv_w": P((_CONV_W, r), (None, "rnn"), scale=0.1),
        "conv_b": P((r,), ("rnn",), init="zeros"),
        "w_a": P((r, r), ("rnn", None), scale=0.01),
        "w_x": P((r, r), ("rnn", None), scale=0.01),
        "lam": P((r,), ("rnn",), init="ones"),  # softplus(lam) -> decay
        "w_out": P((r, d), ("rnn", "embed")),
    }


def init_rglru_cache(cfg: ModelConfig, batch: int, device) -> Dict[str, Tensor]:
    """The recurrent state and the conv history, float32 whatever the cache dtype."""
    r = cfg.d_model
    return {
        "h": torch.zeros((batch, r), dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, _CONV_W - 1, r), dtype=torch.float32, device=device),
    }


def _rglru_gates(params, u: Tensor) -> Tuple[Tensor, Tensor]:
    """a_t (decay) and b_t (input) of the linear recurrence from u (B, T, R), f32."""
    r_gate = torch.sigmoid(u @ params["w_a"])  # recurrence gate
    i_gate = torch.sigmoid(u @ params["w_x"])  # input gate
    log_a = -_RGLRU_C * F.softplus(params["lam"]) * r_gate.float()
    a = torch.exp(log_a)
    mult = torch.sqrt(torch.clamp(1.0 - torch.exp(2.0 * log_a), min=1e-12))
    return a, mult * (i_gate.float() * u.float())


def _causal_conv(params, u: Tensor, state: Optional[Tensor]) -> Tuple[Tensor, Tensor]:
    """Depthwise causal conv of width 4 over u (B, T, R) after the history
    ``state`` (B, 3, R).  Returns the output in u's dtype and the new history
    in float32."""
    b, t, r = u.shape
    if state is None:
        hist = torch.zeros((b, _CONV_W - 1, r), dtype=u.dtype, device=u.device)
    else:
        hist = state.to(u.dtype)
    ext = torch.cat([hist, u], dim=1)  # (B, T+3, R)
    out = torch.zeros_like(u)
    for w in range(_CONV_W):
        out = out + ext[:, w : w + t] * params["conv_w"][_CONV_W - 1 - w]
    out = out + params["conv_b"]
    return out, ext[:, -(_CONV_W - 1):].float()


def _scan(a: Tensor, b: Tensor, h0: Optional[Tensor], ctx: ApplyCtx) -> Tensor:
    """K3 over (B, T, R).  On a mesh it runs under ``local_map`` with the
    batch over the data axes and the channels over the model axis, each
    where it divides, forward and backward (``LruScan``)."""
    mi = ctx.mesh_info
    if mi is None:
        return ops.lru_scan(a, b, h0)
    from torch.distributed.tensor.experimental import local_map

    batch, rnn = mi.split(mi.batch_axes, a.shape[0]), mi.split(mi.model_axis, a.shape[2])
    seq = mi.placements(batch, None, rnn)
    state = None if h0 is None else mi.placements(batch, rnn)
    return local_map(ops.lru_scan, out_placements=(seq,), in_placements=(seq, seq, state),
                     device_mesh=mi.mesh, redistribute_inputs=True)(a, b, h0)


def rglru_block(
    cfg: ModelConfig,
    params: Dict[str, Tensor],
    x: Tensor,
    *,
    ctx: ApplyCtx,
    cache: Optional[Dict[str, Tensor]] = None,
) -> Tuple[Tensor, Optional[Dict[str, Tensor]]]:
    """Returns (y, cache); the cache's state is written in place in prefill
    and decode."""
    u = x @ params["w_in"]  # (B, T, R)
    gate = F.gelu(x @ params["w_gate"], approximate="tanh")

    u, new_conv = _causal_conv(params, u, None if cache is None else cache["conv"])
    a, bb = _rglru_gates(params, u)  # (B, T, R) f32

    if ctx.mode == "decode":
        assert cache is not None
        h_last = a[:, 0] * cache["h"] + bb[:, 0]
        y_rnn = h_last[:, None, :]
    else:
        y_rnn = _scan(a, bb, None if cache is None else cache["h"], ctx)
        h_last = y_rnn[:, -1]
    if cache is not None and ctx.mode in ("prefill", "decode"):
        write_state(cache["h"], h_last)
        write_state(cache["conv"], new_conv)

    y = (gate.float() * y_rnn).to(x.dtype) @ params["w_out"]
    return y, cache
