"""Shared transformer layers: RMSNorm, RoPE, MLPs (with optional biases) and
GQA attention (causal, local, full or cross; train, prefill and decode).

The port's counterpart of ``repro.models.layers``, differentiable by
autograd.  Layouts are
the reference's: activations (B, T, D), ``wq`` (D, H, hd), caches
(B, S, KVH, hd).  Prefill and train attention is plain einsum and softmax over
query chunks, as the reference computes it outside Pallas; decode attention,
over the self cache and over the cross cache alike, goes through
``kernels.ops.decode_attention`` (K2).  Caches are updated in place and
returned, which spares a copy of every cache per step.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

from ..configs.base import ModelConfig
from ..kernels import ops
from .params import P

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class ApplyCtx:
    """Per-call context: execution mode, the query chunk of attention, and
    the layer-cycle rematerialisation of training (``transformer._run_stack``)."""

    mode: str = "train"  # train | prefill | decode
    q_chunk: int = 2048
    # layer-cycle remat in train mode: none | full (recompute the cycle) | dots
    # (keep the weight products) | outs (keep the attention and FFN outputs)
    remat: str = "none"


# ---------------------------------------------------------------------------
# norms / activations / rope
# ---------------------------------------------------------------------------


def rmsnorm_spec(d: int) -> Dict[str, P]:
    return {"scale": P((d,), ("embed",), init="ones")}


def rmsnorm(params: Dict[str, Tensor], x: Tensor, eps: float) -> Tensor:
    """Math in float32, output in the activation dtype."""
    x32 = x.float()
    inv = torch.rsqrt(torch.mean(x32 * x32, dim=-1, keepdim=True) + eps)
    return (x32 * inv * params["scale"].float()).to(x.dtype)


def rope(x: Tensor, positions: Tensor, theta: float) -> Tensor:
    """Rotary embedding in float32. x: (..., T, H, hd); positions: (..., T) or (T,)."""
    half = x.shape[-1] // 2
    freq = theta ** (-torch.arange(0, half, dtype=torch.float32, device=x.device) / half)
    ang = positions.float()[..., None] * freq  # (..., T, half)
    cos = torch.cos(ang)[..., None, :]  # (..., T, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def activate(act: str, gate: Tensor, up: Tensor) -> Tensor:
    # jax.nn.gelu is the tanh approximation by default
    if act == "swiglu":
        return F.silu(gate) * up
    if act == "geglu":
        return F.gelu(gate, approximate="tanh") * up
    if act == "gelu":
        return F.gelu(gate, approximate="tanh")  # non-gated: 'up' unused by caller
    raise ValueError(act)


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------


def mlp_spec(cfg: ModelConfig) -> Dict[str, P]:
    d, f = cfg.d_model, cfg.d_ff
    spec = {"wi": P((d, f), ("embed", "mlp")), "wo": P((f, d), ("mlp", "embed"))}
    if cfg.act in ("swiglu", "geglu"):
        spec["wg"] = P((d, f), ("embed", "mlp"))
    if cfg.use_bias:
        spec["bi"] = P((f,), ("mlp",), init="zeros")
        spec["bo"] = P((d,), ("embed",), init="zeros")
    return spec


def mlp(cfg: ModelConfig, params: Dict[str, Tensor], x: Tensor) -> Tensor:
    up = x @ params["wi"]
    if cfg.use_bias:
        up = up + params["bi"]
    if cfg.act in ("swiglu", "geglu"):
        h = activate(cfg.act, x @ params["wg"], up)
    else:
        h = activate(cfg.act, up, up)
    y = h @ params["wo"]
    return y + params["bo"] if cfg.use_bias else y


# ---------------------------------------------------------------------------
# attention
# ---------------------------------------------------------------------------


def attention_spec(cfg: ModelConfig) -> Dict[str, P]:
    """Self and cross attention share one layout."""
    d, h, kvh, hd = cfg.d_model, cfg.num_heads, cfg.num_kv_heads, cfg.resolved_head_dim
    spec = {
        "wq": P((d, h, hd), ("embed", "heads", "head_dim")),
        "wk": P((d, kvh, hd), ("embed", "kv_heads", "head_dim")),
        "wv": P((d, kvh, hd), ("embed", "kv_heads", "head_dim")),
        "wo": P((h, hd, d), ("heads", "head_dim", "embed")),
    }
    if cfg.use_bias:
        spec["bq"] = P((h, hd), ("heads", "head_dim"), init="zeros")
        spec["bk"] = P((kvh, hd), ("kv_heads", "head_dim"), init="zeros")
        spec["bv"] = P((kvh, hd), ("kv_heads", "head_dim"), init="zeros")
    return spec


def _project(cfg: ModelConfig, params: Dict[str, Tensor], x: Tensor, name: str) -> Tensor:
    """(B, T, D) -> (B, T, heads, hd) by ``w<name>``, plus ``b<name>`` under
    ``use_bias``."""
    y = torch.einsum("btd,dhk->bthk", x, params["w" + name])
    return y + params["b" + name] if cfg.use_bias else y


def _attn_chunk(q: Tensor, k: Tensor, v: Tensor, mask: Tensor) -> Tensor:
    """q (B, qc, KVH, G, hd) f32 pre-scaled; k (B, S, KVH, hd) f32; v in the
    model dtype; mask (qc, S) additive.  Returns (B, qc, KVH, G, hd)."""
    logits = torch.einsum("bqkgd,bskd->bkgqs", q, k) + mask
    w = torch.softmax(logits, dim=-1)
    return torch.einsum("bkgqs,bskd->bqkgd", w.to(v.dtype), v)


def _full_attention(
    cfg: ModelConfig, q: Tensor, k: Tensor, v: Tensor, *, causal: bool, window: int,
    q_positions: Tensor, kv_positions: Tensor, ctx: ApplyCtx,
) -> Tensor:
    """Chunked-query attention, causal or not: q (B, T, H, hd), k, v
    (B, S, KVH, hd) post-rope.  Returns (B, T, H, hd)."""
    b, t, h, hd = q.shape
    kvh = cfg.num_kv_heads
    qg = (q * hd**-0.5).reshape(b, t, kvh, h // kvh, hd).float()
    k32 = k.float()

    def mask_for(qpos: Tensor) -> Tensor:
        rel = qpos[:, None] - kv_positions[None, :]  # (qc, S)
        ok = torch.ones(rel.shape, dtype=torch.bool, device=rel.device)
        if causal:
            ok &= rel >= 0
        if window > 0:
            ok &= rel < window
        return torch.where(ok, 0.0, NEG_INF).float()

    chunk = min(ctx.q_chunk, t)
    if t % chunk != 0:
        chunk = t  # one chunk for ragged lengths, as the reference
    outs = [
        _attn_chunk(qg[:, i : i + chunk], k32, v, mask_for(q_positions[i : i + chunk]))
        for i in range(0, t, chunk)
    ]
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return out.reshape(b, t, h, hd).to(q.dtype)


def init_attention_cache(
    cfg: ModelConfig, batch: int, max_len: int, dtype, device, window: int = 0
) -> Dict[str, Tensor]:
    s = min(window, max_len) if window > 0 else max_len
    shape = (batch, s, cfg.num_kv_heads, cfg.resolved_head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def attention(
    cfg: ModelConfig,
    params: Dict[str, Tensor],
    x: Tensor,  # (B, T, D)
    *,
    ctx: ApplyCtx,
    causal: bool = True,
    window: int = 0,
    positions: Optional[Tensor] = None,  # (T,) absolute positions
    length: Optional[Tensor] = None,  # 0-d int32: tokens already in the cache
    cache: Optional[Dict[str, Tensor]] = None,
    kv_x: Optional[Tensor] = None,  # cross attention's source (B, S_enc, D)
    is_cross: bool = False,  # decode reads the prefilled cross cache
) -> Tuple[Tensor, Optional[Dict[str, Tensor]]]:
    """GQA attention for all modes.  Returns (y, cache), the cache written in
    place in prefill and decode.

    Cross attention (``kv_x`` given, or ``is_cross``) projects k and v from
    ``kv_x``, ropes neither q nor k, and is not causal; prefill writes the whole
    cross cache, and a decode step reads all of it and writes nothing."""
    b, t, _ = x.shape
    cross = is_cross or kv_x is not None
    if ctx.mode != "decode" and cross and kv_x is None:
        raise ValueError("cross attention outside decode requires kv_x (enc_out)")
    q = _project(cfg, params, x, "q")
    k = v = None  # a decode step's cross attention makes no new k, v
    if not (cross and kv_x is None):
        src = x if kv_x is None else kv_x
        k, v = _project(cfg, params, src, "k"), _project(cfg, params, src, "v")
    if positions is None:
        positions = torch.arange(t, device=x.device)
    if not cross:  # cross attention keeps the encoder's own representation
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)

    if ctx.mode in ("train", "prefill"):
        kv_pos = torch.arange(k.shape[1], device=x.device)
        out = _full_attention(cfg, q, k, v, causal=causal and not cross, window=window,
                              q_positions=positions, kv_positions=kv_pos, ctx=ctx)
        if ctx.mode == "prefill" and cache is not None:
            s = cache["k"].shape[1]
            if cross:
                cache["k"].copy_(k)
                cache["v"].copy_(v)
            elif window > 0 and t > s:
                # keep the trailing window, placed at ring slots pos % s
                shift = (t - s) % s
                cache["k"].copy_(torch.roll(k[:, -s:], shift, dims=1))
                cache["v"].copy_(torch.roll(v[:, -s:], shift, dims=1))
            else:
                for name, new in (("k", k), ("v", v)):
                    cache[name][:, t:].zero_()
                    cache[name][:, :t].copy_(new)
    elif ctx.mode == "decode":
        assert cache is not None and length is not None
        s = cache["k"].shape[1]
        if cross:  # every row of the cross cache is valid
            valid = torch.full((b,), s, dtype=torch.int32, device=x.device)
        else:
            # the ring slot of a window, else the next row; a device index, no sync
            slot = (length % s if window > 0 else length).long().reshape(1)
            cache["k"].index_copy_(1, slot, k.to(cache["k"].dtype))
            cache["v"].index_copy_(1, slot, v.to(cache["v"].dtype))
            # The valid rows are a prefix of the cache: rows 0..length before a
            # ring wraps, all s after; softmax ignores their order, and the
            # cached keys carry their RoPE already.
            valid = torch.clamp(length + 1, max=s).to(torch.int32).reshape(1).expand(b)
        out = ops.decode_attention(q[:, 0], cache["k"], cache["v"], valid)[:, None]
    else:
        raise ValueError(ctx.mode)

    y = torch.einsum("bthk,hkd->btd", out.to(x.dtype), params["wo"])
    return y, cache
