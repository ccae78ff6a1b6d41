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

On a mesh (``ApplyCtx.mesh_info``) the tensors are ``DTensor``s of
``torch.distributed.tensor`` where the reference's are GSPMD-sharded arrays:
``constrain_batch`` and ``_seq_shard`` redistribute to the spec they name,
as ``with_sharding_constraint`` does, and K2 runs under ``local_map`` on each
shard of the cache (``_decode_on_mesh``).  Without a mesh every function
dispatches what it did before the mesh existed.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import Tensor

from ..configs.base import ModelConfig
from ..device import is_dtensor
from ..distributed.sharding import PartitionSpec, axes_size, placements
from ..kernels import ops
from .params import P

NEG_INF = -1e30


class MeshInfo(NamedTuple):
    """Distribution context threaded through the model (None on one device)."""

    mesh: Any  # torch.distributed.device_mesh.DeviceMesh with named dims
    batch_axes: Tuple[str, ...]  # ("pod", "data") or ("data",)
    model_axis: Optional[str]  # "model"

    def size(self, axes) -> int:
        """The number of shards over ``axes`` (a name or names)."""
        return axes_size(self.mesh, (axes,) if isinstance(axes, str) else axes)

    def split(self, axes, n: int):
        """``axes`` when they split ``n`` evenly, else None (replicated): the
        spec entry of a dim of size ``n``."""
        return axes if axes and n % self.size(axes) == 0 else None

    def placements(self, *spec) -> tuple:
        """The DTensor placements of a spec given as its entries."""
        return placements(PartitionSpec(*spec), self.mesh)


@dataclasses.dataclass(frozen=True)
class ApplyCtx:
    """Per-call context: execution mode, distribution info, the query chunk
    of attention, and the layer-cycle rematerialisation of training
    (``transformer._run_stack``)."""

    mode: str = "train"  # train | prefill | decode
    mesh_info: Optional[MeshInfo] = None
    q_chunk: int = 2048
    # layer-cycle remat in train mode: none | full (recompute the cycle) | dots
    # (keep the weight products) | outs (keep the attention and FFN outputs)
    remat: str = "none"
    # The reference's perf options for a mesh.  seq_shard_attention shards
    # attention's (and the mLSTM's) query chunks over the model axis
    # (context parallelism) where the heads do not divide it; seq_parallel
    # shards the residual stream between blocks over (data, model) on the
    # sequence; fuse_projections runs q/k/v (and the MLP's gate and up) as
    # one product on concatenated weights.
    seq_shard_attention: bool = False
    seq_parallel: bool = False
    fuse_projections: bool = False


@contextlib.contextmanager
def mesh_scope(ctx: Optional[ApplyCtx]):
    """Around a model call on a mesh: plain tensors made inside it (positions,
    masks, rope's frequencies, scalars) count as replicated ``DTensor``s.
    Re-entrant; without a mesh it does nothing."""
    if ctx is None or ctx.mesh_info is None or torch._C._get_dtensor_allow_implicit_replication():
        yield
        return
    from torch.distributed.tensor.experimental import implicit_replication

    with implicit_replication():
        yield


def constrain(x: Tensor, mi: MeshInfo, spec) -> Tensor:
    """``x`` redistributed to ``spec``; a plain tensor, which every rank holds
    whole, becomes a DTensor of it with no communication."""
    pl = mi.placements(*spec)
    if is_dtensor(x):
        # A redistribution (ours, or one inside an earlier operation) leaves
        # the local shard contiguous while the DTensor may keep other
        # strides; a later reshape decided on those strides would then fail
        # on the shard.  Made contiguous, the two agree.
        return x.redistribute(mi.mesh, pl).contiguous()
    from torch.distributed.tensor import distribute_tensor

    return distribute_tensor(x, mi.mesh, pl, src_data_rank=None)


def constrain_batch(x: Tensor, ctx: ApplyCtx, tail=None) -> Tensor:
    """Pin the batch dim to the data axes, the rest replicated unless ``tail``
    names their mesh axes (the activations' sharding constraint).  Without a
    mesh, ``x`` itself."""
    mi = ctx.mesh_info
    if mi is None or not mi.batch_axes:
        return x
    tail = tail if tail is not None else [None] * (x.ndim - 1)
    # a batch the data axes do not divide (long_500k's one sequence) is
    # replicated: an uneven split leaves shards that later reshapes refuse
    return constrain(x, mi, (mi.split(mi.batch_axes, x.shape[0]), *tail))


def zero_gathered(w: Tensor, mi: Optional[MeshInfo]) -> Tensor:
    """A weight whole over the data axes (a ZeRO split gathered, as
    ``heads_product`` gathers its weight), its other placements kept; its
    gradient comes back as a reduce-scatter.  Left to DTensor, a product of
    batch-split activations and a weight split on the contracted dim may
    move the activations by an all-to-all instead, which gloo runs as an
    all-gather: the two device types would count different collectives."""
    if mi is None or not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate

    names = mi.mesh.mesh_dim_names
    pl = tuple(Replicate() if p.is_shard() and names[m] in mi.batch_axes else p
               for m, p in enumerate(w.placements))
    return w if pl == tuple(w.placements) else w.redistribute(w.device_mesh, pl)


def write_state(dst: Tensor, src: Tensor) -> None:
    """``dst.copy_(src)``; on a mesh ``src`` is first redistributed to
    ``dst``'s placements, so the copy is each shard's own."""
    if is_dtensor(dst):
        src = src.redistribute(dst.device_mesh, dst.placements)
    dst.copy_(src)


@torch.library.custom_op("repro_torch::checkpoint_name", mutates_args=())
def _checkpoint_name(x: Tensor, name: str) -> Tensor:
    """A named identity that the "outs" policy can see: one copy of x."""
    return x.clone()


_checkpoint_name.register_autograd(lambda ctx, grad: (grad, None),
                                   setup_context=lambda ctx, inputs, output: None)


def checkpoint_name(x: Tensor, name: str, ctx: ApplyCtx) -> Tensor:
    """Name ``x`` for remat "outs"; under any other setting ``x`` itself, with
    no operation dispatched.  ``transformer._run_stack`` hands the blocks a
    ctx whose remat is "outs" only inside a checkpointed cycle.  A DTensor
    is named shard by shard, under ``local_map``."""
    if ctx.remat != "outs":
        return x
    if is_dtensor(x):
        from torch.distributed.tensor.experimental import local_map

        return local_map(_checkpoint_name, out_placements=(x.placements,),
                         in_placements=(x.placements, None), device_mesh=x.device_mesh)(x, name)
    return _checkpoint_name(x, name)


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


def mlp(cfg: ModelConfig, params: Dict[str, Tensor], x: Tensor,
        ctx: Optional[ApplyCtx] = None) -> Tensor:
    gated = cfg.act in ("swiglu", "geglu")
    mi = None if ctx is None else ctx.mesh_info
    w = {k: zero_gathered(params[k], mi) for k in ("wi", "wg", "wo") if k in params}
    if ctx is not None and ctx.fuse_projections and gated:
        f = cfg.d_ff
        both = x @ torch.cat([w["wi"], w["wg"]], dim=1)
        up, gate = both[..., :f], both[..., f:]
        if cfg.use_bias:
            up = up + params["bi"]
        h = activate(cfg.act, gate, up)
    else:
        up = x @ w["wi"]
        if cfg.use_bias:
            up = up + params["bi"]
        h = activate(cfg.act, x @ w["wg"], up) if gated else activate(cfg.act, up, up)
    y = h @ w["wo"]
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


def _project(cfg: ModelConfig, params: Dict[str, Tensor], x: Tensor, name: str,
             mi: Optional[MeshInfo] = None) -> Tensor:
    """(B, T, D) -> (B, T, heads, hd) by ``w<name>``, plus ``b<name>`` under
    ``use_bias``.  On a mesh the product runs shard by shard
    (``heads_product``), the heads over the model axis only where they
    divide it.  Left to DTensor's propagation, heads x hd may be split
    through a head (3 KV heads of 64 over 2 shards), and the view that
    splits the heads out, or folds their gradient back, is refused."""
    w = params["w" + name]
    eq = "btd,dhk->bthk"
    y = torch.einsum(eq, x, w) if mi is None else heads_product(eq, x, w, mi, 1, out_dim=2)
    return y + params["b" + name] if cfg.use_bias else y


def heads_product(eq: str, x: Tensor, w: Tensor, mi: MeshInfo, w_dim: int,
                  out_dim: Optional[int] = None, x_dim: Optional[int] = None) -> Tensor:
    """``torch.einsum(eq, x, w)`` of activations x (B, ...) and a weight w
    whose dim ``w_dim`` holds heads, on a mesh: shard by shard under
    ``local_map``, x with its batch over the data axes where they divide it,
    w whole over the data axes (a ZeRO split is gathered) and its heads over
    the model axis where they divide it, the output's batch (dim 0) placed
    likewise.  A projection (``out_dim``: the output's heads dim) places the
    output's heads as w's; a contraction over the heads (``x_dim``: x's
    heads dim, placed as w's) returns a partial sum over the model axis
    where the heads split.  Each shard's product is the unsharded one on its
    rows and heads, so no product or reshape of a head axis is left to
    DTensor's propagation (which splits a flattened head axis unevenly, or
    refuses a view of its gradient).  In the backward, w's gradient is a
    partial sum over the data axes that split the batch, and a projection's
    x's over the model axis that splits the heads."""
    from torch.distributed.tensor import Partial
    from torch.distributed.tensor.experimental import local_map

    batch = mi.split(mi.batch_axes, x.shape[0])
    heads = mi.split(mi.model_axis, w.shape[w_dim])
    x_spec, w_spec = [batch] + [None] * (x.ndim - 1), [None] * w.ndim
    out_spec = [batch] + [None] * (len(eq.split("->")[1]) - 1)
    w_spec[w_dim] = heads
    for spec, dim in ((x_spec, x_dim), (out_spec, out_dim)):
        if dim is not None:
            spec[dim] = heads
    x_pl, w_pl, out_pl = (mi.placements(*spec) for spec in (x_spec, w_spec, out_spec))
    split = [q.is_shard(w_dim) for q in w_pl]  # the mesh dims that split the heads
    if out_dim is None:
        out_pl = tuple(Partial() if h else p for p, h in zip(out_pl, split))
    x_grad = x_pl if x_dim is not None else tuple(
        Partial() if h else p for p, h in zip(x_pl, split))
    w_grad = tuple(Partial() if q.is_shard(0) else p for p, q in zip(w_pl, x_pl))
    return local_map(lambda a, b: torch.einsum(eq, a, b), out_placements=(out_pl,),
                     in_placements=(x_pl, w_pl), in_grad_placements=(x_grad, w_grad),
                     device_mesh=mi.mesh, redistribute_inputs=True)(
        x if is_dtensor(x) else constrain(x, mi, x_spec),
        w if is_dtensor(w) else constrain(w, mi, w_spec))


def _seq_shard(x: Tensor, ctx: ApplyCtx, dim: int) -> Tensor:
    """Shard ``dim`` over the model axis (context parallelism) when
    ``seq_shard_attention`` is on and it divides; the batch over the data
    axes when it divides them."""
    mi = ctx.mesh_info
    if not ctx.seq_shard_attention or mi is None or mi.split(mi.model_axis, x.shape[dim]) is None:
        return x
    spec = [None] * x.ndim
    spec[0] = mi.split(mi.batch_axes, x.shape[0])
    spec[dim] = mi.model_axis
    return constrain(x, mi, spec)


def _attn_chunk(q: Tensor, k: Tensor, v: Tensor, mask: Tensor, ctx: ApplyCtx) -> Tensor:
    """q (B, qc, KVH, G, hd) f32 pre-scaled; k (B, S, KVH, hd) f32; v in the
    model dtype; mask (qc, S) additive.  Returns (B, qc, KVH, G, hd)."""
    q = _seq_shard(q, ctx, 1)
    logits = torch.einsum("bqkgd,bskd->bkgqs", q, k) + mask
    w = torch.softmax(logits, dim=-1)
    return _seq_shard(torch.einsum("bkgqs,bskd->bqkgd", w.to(v.dtype), v), ctx, 1)


def _full_attention(
    cfg: ModelConfig, q: Tensor, k: Tensor, v: Tensor, *, causal: bool, window: int,
    q_positions: Tensor, kv_positions: Tensor, ctx: ApplyCtx,
) -> Tensor:
    """Chunked-query attention, causal or not: q (B, T, H, hd), k, v
    (B, S, KVH, hd) post-rope.  Returns (B, T, H, hd)."""
    b, t, h, hd = q.shape
    kvh = k.shape[2]
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
        _attn_chunk(qg[:, i : i + chunk], k32, v, mask_for(q_positions[i : i + chunk]), ctx)
        for i in range(0, t, chunk)
    ]
    out = outs[0] if len(outs) == 1 else torch.cat(outs, dim=1)
    return out.reshape(b, t, h, hd).to(q.dtype)


def pin_heads(x: Tensor, mi: MeshInfo, dim: int, n: int) -> Tensor:
    """``x`` with the batch (dim 0) over the data axes and its head axis
    ``dim`` over the model axis when ``n`` (the heads that must stay
    together: attention's KV heads) divides it, else replicated.  Pinned
    here, no reshape or product of a sharded head axis is left to DTensor's
    propagation (which can fail, or gather silently)."""
    spec = [None] * x.ndim
    spec[0] = mi.split(mi.batch_axes, x.shape[0])
    spec[dim] = mi.split(mi.model_axis, n)
    return constrain(x, mi, spec)


def _full_attention_by_heads(cfg: ModelConfig, q: Tensor, k: Tensor, v: Tensor, *,
                             ctx: ApplyCtx, **kw) -> Tensor:
    """``_full_attention`` on a mesh whose model axis splits the KV heads:
    each shard attends with its own heads, under ``local_map`` (every query
    head is on its KV head's shard, ``pin_heads``)."""
    from torch.distributed.tensor.experimental import local_map

    inner = dataclasses.replace(ctx, mesh_info=None)
    fn = lambda q, k, v: _full_attention(cfg, q, k, v, ctx=inner, **kw)
    return local_map(fn, out_placements=(q.placements,),
                     in_placements=(q.placements, k.placements, v.placements),
                     device_mesh=ctx.mesh_info.mesh)(q, k, v)


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
    h, kvh = cfg.num_heads, cfg.num_kv_heads
    cross = is_cross or kv_x is not None
    if ctx.mode != "decode" and cross and kv_x is None:
        raise ValueError("cross attention outside decode requires kv_x (enc_out)")
    k = v = None  # a decode step's cross attention makes no new k, v
    if ctx.fuse_projections and not cross and params["wq"].shape[-1] == params["wk"].shape[-1]:
        # one product on the concatenated weights (D, H + 2 KVH, hd)
        wqkv = torch.cat([params["wq"], params["wk"], params["wv"]], dim=1)
        qkv = torch.einsum("btd,dhk->bthk", x, wqkv)
        q, k, v = qkv[:, :, :h], qkv[:, :, h:h + kvh], qkv[:, :, h + kvh:]
        if cfg.use_bias:
            q, k, v = q + params["bq"], k + params["bk"], v + params["bv"]
    else:
        q = _project(cfg, params, x, "q", ctx.mesh_info)
        if not (cross and kv_x is None):
            src = x if kv_x is None else kv_x
            k, v = (_project(cfg, params, src, "k", ctx.mesh_info),
                    _project(cfg, params, src, "v", ctx.mesh_info))
    if positions is None:
        positions = torch.arange(t, device=x.device)
    if not cross:  # cross attention keeps the encoder's own representation
        q = rope(q, positions, cfg.rope_theta)
        k = rope(k, positions, cfg.rope_theta)
    mi = ctx.mesh_info
    if mi is not None:  # every query head on the shard of its KV head
        q = pin_heads(q, mi, 2, kvh)
        if k is not None:
            k, v = pin_heads(k, mi, 2, kvh), pin_heads(v, mi, 2, kvh)

    if ctx.mode in ("train", "prefill"):
        kv_pos = torch.arange(k.shape[1], device=x.device)
        full = _full_attention_by_heads if mi is not None and mi.split(mi.model_axis, kvh) \
            else _full_attention
        out = full(cfg, q, k, v, causal=causal and not cross, window=window,
                   q_positions=positions, kv_positions=kv_pos, ctx=ctx)
        if ctx.mode == "prefill" and cache is not None:
            if mi is not None:
                _prefill_cache_on_mesh(cache, k, v, t, window, cross)
            else:
                _prefill_cache(cache, k, v, t, window, cross)
    elif ctx.mode == "decode":
        assert cache is not None and length is not None
        if mi is not None:
            out = _decode_on_mesh(q[:, 0], k, v, cache, length, window, cross, mi)[:, None]
        else:
            out = _decode(q[:, 0], k, v, cache, length, window, cross)[:, None]
    else:
        raise ValueError(ctx.mode)

    eq = "bthk,hkd->btd"
    if mi is None:
        y = torch.einsum(eq, out.to(x.dtype), params["wo"])
    else:
        y = heads_product(eq, out.to(x.dtype), params["wo"], mi, 0, x_dim=2)
    return y, cache


def _cache_rows(k: Tensor, s: int, t: int, window: int, cross: bool):
    """How a prefill of ``t`` rows fills an ``s``-row cache: (rows, shift) with
    rows the part of k kept and shift its roll onto the ring's slots pos %
    s; (k, None) when the rows fill a prefix of the cache."""
    if not cross and window > 0 and t > s:
        return k[:, -s:], (t - s) % s  # the trailing window
    return k, None


def _prefill_cache(cache, k: Tensor, v: Tensor, t: int, window: int, cross: bool) -> None:
    s = cache["k"].shape[1]
    for name, new in (("k", k), ("v", v)):
        rows, shift = _cache_rows(new, s, t, window, cross)
        if cross:
            cache[name].copy_(rows)
        elif shift is not None:
            cache[name].copy_(torch.roll(rows, shift, dims=1))
        else:
            cache[name][:, t:].zero_()
            cache[name][:, :t].copy_(rows)


def _prefill_cache_on_mesh(cache, k: Tensor, v: Tensor, t: int, window: int,
                           cross: bool) -> None:
    """The prefill's cache write on a mesh: the whole (B, S, KVH, hd) content
    is built as the unsharded path writes it, then each shard copies its
    part (a cache sharded over seq takes its own rows)."""
    s = cache["k"].shape[1]
    for name, new in (("k", k), ("v", v)):
        rows, shift = _cache_rows(new.to(cache[name].dtype), s, t, window, cross)
        if shift is not None:
            rows = torch.roll(rows, shift, dims=1)
        elif rows.shape[1] < s:
            pad = torch.zeros((rows.shape[0], s - rows.shape[1], *rows.shape[2:]),
                              dtype=rows.dtype, device=rows.device)
            rows = torch.cat([rows, pad], dim=1)
        write_state(cache[name], rows)


def _decode(q: Tensor, k: Optional[Tensor], v: Optional[Tensor], cache, length: Tensor,
            window: int, cross: bool) -> Tensor:
    """One decode step's attention on one device: the new row written at its
    slot, then K2 over the valid rows.  q (B, H, hd); returns (B, H, hd)."""
    b = q.shape[0]
    s = cache["k"].shape[1]
    if cross:  # every row of the cross cache is valid
        valid = torch.full((b,), s, dtype=torch.int32, device=q.device)
    else:
        # the ring slot of a window, else the next row; a device index, no sync
        slot = (length % s if window > 0 else length).long().reshape(1)
        cache["k"].index_copy_(1, slot, k.to(cache["k"].dtype))
        cache["v"].index_copy_(1, slot, v.to(cache["v"].dtype))
        # The valid rows are a prefix of the cache: rows 0..length before a
        # ring wraps, all s after; softmax ignores their order, and the
        # cached keys carry their RoPE already.
        valid = torch.clamp(length + 1, max=s).to(torch.int32).reshape(1).expand(b)
    return ops.decode_attention(q, cache["k"], cache["v"], valid)


def _decode_on_mesh(q: Tensor, k: Optional[Tensor], v: Optional[Tensor], cache,
                    length: Tensor, window: int, cross: bool, mi: MeshInfo) -> Tensor:
    """One decode step's attention over a sharded cache (B, S, KVH, hd).

    Each shard writes the new row if it owns its slot, then runs K2 under
    ``local_map`` on its own rows: with the KV heads over the model axis on
    its heads; with the seq dim over it (the flash-decode fallback) on its
    S / m rows, of which clamp(min(length + 1, S) - r S / m, 0, S / m) are
    valid, and the shards' outputs are merged by their log-sum-exps over the
    seq group (one max and one sum all-reduce).  A head_dim split (the last
    resort of ``cache_rules``) is gathered for the kernel."""
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    ck, cv = cache["k"], cache["v"]
    s = ck.shape[1]
    pl = tuple(Replicate() if p.is_shard(3) else p for p in ck.placements)
    # the mesh dim that splits the rows (cache_rules: the model axis), if any
    seq = next((m for m, p in enumerate(pl) if p.is_shard(1)), None)
    s_loc = s if seq is None else s // int(mi.mesh.shape[seq])
    lo = 0 if seq is None else mi.mesh.get_local_rank(seq) * s_loc
    group = None if seq is None else mi.mesh.get_group(seq)
    # q (B, H, hd): the cache's batch split, its kv heads' split on the heads
    q_pl = tuple(Shard(1) if p.is_shard(2) else p if p.is_shard(0) else Replicate() for p in pl)
    row_pl = tuple(Replicate() if p.is_shard(1) else p for p in ck.placements)
    scalar = (Replicate(),) * len(pl)

    if not cross:
        slot = length % s if window > 0 else length

        def write(c, new, slot):  # the shard that owns the slot writes it
            idx = slot.long().reshape(1) - lo
            own = (idx >= 0) & (idx < s_loc)
            idx = torch.clamp(idx, 0, s_loc - 1)
            c.index_copy_(1, idx, torch.where(own, new, c.index_select(1, idx)))
            return c

        for c, new in ((ck, k), (cv, v)):
            local_map(write, out_placements=(c.placements,),
                      in_placements=(c.placements, row_pl, scalar),
                      device_mesh=mi.mesh, redistribute_inputs=True)(
                c, new.to(c.dtype), slot)
        total = torch.clamp(length + 1, max=s)
    else:
        total = torch.full((), s, dtype=torch.int32, device=q.device)

    def attend(q, k, v, total):
        valid = torch.clamp(total - lo, 0, s_loc).to(torch.int32).reshape(1).expand(q.shape[0])
        if group is None:
            return ops.decode_attention(q, k, v, valid)
        out, lse = ops.decode_attention(q, k, v, valid, return_lse=True)
        top = lse.clone()
        torch.distributed.all_reduce(top, torch.distributed.ReduceOp.MAX, group=group)
        w = torch.exp(lse - top)[..., None]  # 0 for a shard with no valid row
        acc = torch.cat([w * out.float(), w], dim=-1)
        torch.distributed.all_reduce(acc, group=group)
        return (acc[..., :-1] / acc[..., -1:]).to(q.dtype)

    return local_map(attend, out_placements=(q_pl,),
                     in_placements=(q_pl, pl, pl, scalar),
                     device_mesh=mi.mesh, redistribute_inputs=True)(q, ck, cv, total)
