"""LM assembly: embed -> layer-pattern cycles -> norm -> head.

The port's counterpart of ``repro.models.transformer`` for every family of
the reference: dense, vision (patch embeddings prepended), hybrid (RG-LRU +
local attention), MoE, encoder-decoder (``enc`` and ``xdec`` blocks; the
encoder's assembly is ``encdec``) and ssm (mLSTM + sLSTM, attention-free, no
FFN).  Parameters and caches keep the
reference's layout: one stacked tree per pattern position with a leading
``n_cycles`` axis, plus the unrolled remainder layers.  The layer loop is a
Python loop over cycles; caches are written in place through views of the
stacked tensors, and ``cache["length"]`` stays on the device, so a decode
step never reads the device.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Optional, Tuple

import torch
from torch import Tensor
from torch.utils.checkpoint import (
    CheckpointPolicy,
    checkpoint,
    create_selective_checkpoint_contexts,
)

from ..configs.base import ModelConfig
from ..device import is_dtensor, local
from . import moe as moe_lib
from . import recurrent as rec
from .layers import (
    ApplyCtx,
    attention,
    attention_spec,
    checkpoint_name,
    constrain,
    constrain_batch,
    init_attention_cache,
    mesh_scope,
    mlp,
    mlp_spec,
    rmsnorm,
    rmsnorm_spec,
    zero_gathered,
)
from .params import P, leaves, stack_spec, tree_map

PORTED_KINDS = ("dense", "moe", "localattn", "enc", "xdec", "rglru", "mlstm", "slstm")
# the recurrent mixers' (spec, cache, block) by kind: the blocks that attend to nothing
MIXERS = {
    "rglru": (rec.rglru_spec, rec.init_rglru_cache, rec.rglru_block),
    "mlstm": (rec.mlstm_spec, rec.init_mlstm_cache, rec.mlstm_block),
    "slstm": (rec.slstm_spec, rec.init_slstm_cache, rec.slstm_block),
}


# ---------------------------------------------------------------------------
# layer-cycle remat (train mode): what a checkpointed cycle keeps for backward
# ---------------------------------------------------------------------------

REMATS = ("none", "full", "dots", "outs")
# "outs" keeps the tensors of these names, the reference's
# save_only_these_names; moe_recv and moe_back are set on the MoE's
# expert-parallel path (a mesh) only
SAVED_NAMES = ("attn_out", "mlp_out", "moe_recv", "moe_back")


def _storage(t: Tensor) -> int:
    """The data pointer of the storage under ``t``: a DTensor's local shard's
    (a DTensor has no storage of its own), read without a dispatch."""
    return local(t).untyped_storage().data_ptr()


def remat_policy(remat: str, weights) -> Any:
    """The selective-checkpoint policy of "dots" or "outs" over one cycle
    whose parameters live in the storages ``weights`` (``_storage``).

    "dots" keeps a product whose operands share no batch dimension, the
    reference's dots_with_no_batch_dims_saveable: every ``aten.mm`` (x @ W,
    the MoE router's product on its weight cast to float32 included), and a
    weight einsum, which reaches ``aten.bmm`` at batch 1.  The batch alone
    cannot tell such a bmm from attention's, which is at batch 1 too at one
    sequence and one KV head: a bmm is kept only when an operand is a
    weight, and never at a batch above 1 (the MoE's per-expert products,
    recomputed as in the reference).  "outs" keeps what ``checkpoint_name``
    named in ``SAVED_NAMES``.  Every other operation is recomputed, the
    kernels' custom ops (K3's ``repro_torch::lru_scan``) among them."""

    def policy(ctx, op, *args, **kwargs):
        if remat == "outs":
            save = op is torch.ops.repro_torch.checkpoint_name.default and args[1] in SAVED_NAMES
        else:
            save = op is torch.ops.aten.mm.default or (
                op is torch.ops.aten.bmm.default and args[0].shape[0] == 1
                and any(_storage(t) in weights for t in args[:2]))
        return CheckpointPolicy.MUST_SAVE if save else CheckpointPolicy.PREFER_RECOMPUTE

    return policy


def _check_kind(kind: str) -> None:
    if kind not in PORTED_KINDS:
        raise ValueError(f"block kind {kind!r} is not ported; ported kinds: {PORTED_KINDS}")


# ---------------------------------------------------------------------------
# per-block spec / apply / cache
# ---------------------------------------------------------------------------


def block_spec(cfg: ModelConfig, kind: str) -> Dict[str, Any]:
    _check_kind(kind)
    d = cfg.d_model
    if kind in ("mlstm", "slstm"):  # the xLSTM blocks carry their own projections: no FFN
        return {"ln1": rmsnorm_spec(d), "mix": MIXERS[kind][0](cfg)}
    if kind == "rglru":
        spec = {"ln1": rmsnorm_spec(d), "mix": rec.rglru_spec(cfg)}
    else:
        spec = {"ln1": rmsnorm_spec(d), "attn": attention_spec(cfg)}
    if kind == "xdec":
        spec["lnx"] = rmsnorm_spec(d)
        spec["xattn"] = attention_spec(cfg)
    if kind == "moe":
        spec["ln2"] = rmsnorm_spec(d)
        spec["ffn"] = moe_lib.moe_spec(cfg)
    elif cfg.d_ff > 0:
        spec["ln2"] = rmsnorm_spec(d)
        spec["ffn"] = mlp_spec(cfg)
    return spec


def init_block_cache(cfg: ModelConfig, kind: str, batch: int, max_len: int, dtype,
                     device) -> Dict[str, Any]:
    """A block's decode cache; an ``xdec`` block's is {"self", "cross"}, the
    cross part ``encoder_seq`` rows deep."""
    _check_kind(kind)
    if kind in MIXERS:
        return MIXERS[kind][1](cfg, batch, device)
    if kind == "xdec":
        return {"self": init_attention_cache(cfg, batch, max_len, dtype, device),
                "cross": init_attention_cache(cfg, batch, cfg.encoder_seq, dtype, device)}
    window = cfg.local_window if kind == "localattn" else 0
    return init_attention_cache(cfg, batch, max_len, dtype, device, window=window)


def block_apply(
    cfg: ModelConfig,
    kind: str,
    params: Dict[str, Any],
    x: Tensor,
    *,
    ctx: ApplyCtx,
    positions: Tensor,
    length: Optional[Tensor],
    cache: Optional[Dict[str, Any]],
    enc_out: Optional[Tensor] = None,
) -> Tuple[Tensor, Optional[Tensor]]:
    """One block; its cache, if any, is updated in place.  Returns (x, aux):
    an MoE block's load-balance loss in train mode, else None (prefill and
    decode discard it, as the reference's jitted calls drop it).  An ``enc``
    block attends without a causal mask; an ``xdec`` block then attends to
    ``enc_out`` (train and prefill) or to its prefilled cross cache
    (decode, ``enc_out`` None), without rope."""
    h = rmsnorm(params["ln1"], x, cfg.norm_eps)
    if kind in MIXERS:
        y, _ = MIXERS[kind][2](cfg, params["mix"], h, ctx=ctx, cache=cache)
    else:
        window = cfg.local_window if kind == "localattn" else 0
        self_cache = cache["self"] if kind == "xdec" and cache is not None else cache
        y, _ = attention(cfg, params["attn"], h, ctx=ctx, causal=kind != "enc", window=window,
                         positions=positions, length=length, cache=self_cache)
        y = checkpoint_name(y, "attn_out", ctx)
    x = x + y
    if kind == "xdec":
        h = rmsnorm(params["lnx"], x, cfg.norm_eps)
        y, _ = attention(cfg, params["xattn"], h, ctx=ctx, causal=False, positions=positions,
                         length=length, cache=cache["cross"] if cache is not None else None,
                         kv_x=enc_out if ctx.mode != "decode" else None, is_cross=True)
        x = x + y
    aux = None
    if "ffn" in params:
        h = rmsnorm(params["ln2"], x, cfg.norm_eps)
        if kind == "moe":
            y, probs = moe_lib.moe_ffn(cfg, params["ffn"], h, ctx)
            if ctx.mode == "train":
                aux = moe_lib.load_balance_loss(cfg, probs)
        else:
            y = mlp(cfg, params["ffn"], h, ctx)
        x = x + checkpoint_name(y, "mlp_out", ctx)
    return x, aux


# ---------------------------------------------------------------------------
# full-model spec
# ---------------------------------------------------------------------------


def _cycles_and_rest(cfg: ModelConfig) -> Tuple[int, Tuple[str, ...]]:
    pattern = cfg.pattern
    return cfg.num_layers // len(pattern), pattern[: cfg.num_layers % len(pattern)]


def layer_kinds(cfg: ModelConfig) -> Tuple[str, ...]:
    """The block kind of every layer, in order."""
    n_cycles, rest = _cycles_and_rest(cfg)
    return cfg.pattern * n_cycles + rest


def lm_spec(cfg: ModelConfig) -> Dict[str, Any]:
    """The decoder's spec (an encdec model's encoder is ``encdec.encoder_spec``)."""
    d, v = cfg.d_model, cfg.vocab_size
    n_cycles, rest = _cycles_and_rest(cfg)
    spec: Dict[str, Any] = {
        "embed": P((v, d), ("vocab", "embed"), scale=1.0 / (d**0.5)),
        "final_norm": rmsnorm_spec(d),
        "cycles": [stack_spec(block_spec(cfg, kind), n_cycles) for kind in cfg.pattern],
        "rest": [block_spec(cfg, kind) for kind in rest],
    }
    if not cfg.tie_embeddings:
        spec["head"] = P((d, v), ("embed", "vocab"), scale=0.02)
    if cfg.vision_patches:
        spec["vision_proj"] = P((d, d), ("embed", None))
    return spec


# ---------------------------------------------------------------------------
# full-model apply
# ---------------------------------------------------------------------------


def _lookup(emb: Tensor, tokens: Tensor, ctx: Optional[ApplyCtx]) -> Tensor:
    """``emb[tokens]``, on a mesh shard by shard on the local tokens.  Where
    the model axis splits the table's vocab and nothing its rows (the
    serving layout, ``default_rules(fsdp=False)``) the lookup is GSPMD's if
    it moves fewer bytes: each shard looks up the tokens that fall in its
    rows [lo, hi) and zeroes the rest, and one all-reduce of (B, T, D) over
    the model axis sums the shards' outputs; each sum adds one row to
    zeros, so the result is bitwise the whole table's lookup.  Otherwise
    (a long prefill, where twice a rank's B x T rows outnumber the V rows
    of the table; a ZeRO split of the rows in training) the whole table is
    gathered on every rank.  Either way the table's gradient is a partial
    sum over the data axes that split the tokens; DTensor's own lookup
    gathers the table too, but its backward fails on some torch versions."""
    mi = None if ctx is None else ctx.mesh_info
    if mi is None or not is_dtensor(emb) or not is_dtensor(tokens):
        return emb[tokens]
    from torch.distributed.tensor import DTensor, Partial, Replicate

    pl, tok_pl, idx = emb.placements, tokens.placements, local(tokens)
    grad = lambda table: tuple(Partial() if q.is_shard(0) else p for p, q in zip(table, tok_pl))
    split = [m for m, p in enumerate(pl) if p.is_shard(0)]
    if len(split) == 1 and not any(p.is_shard(1) for p in pl) and 2 * idx.numel() < emb.shape[0]:
        dim = split[0]
        n = emb.shape[0] // mi.mesh.size(dim)
        idx = idx - mi.mesh.get_local_rank(dim) * n
        own = (idx >= 0) & (idx < n)
        rows = emb.to_local(grad_placements=grad(pl))[torch.where(own, idx, 0)]
        rows = torch.where(own[..., None], rows, 0)
        out_pl = tuple(Partial() if m == dim else p for m, p in enumerate(tok_pl))
    else:
        whole = emb.redistribute(emb.device_mesh, (Replicate(),) * len(pl))
        rows = whole.to_local(grad_placements=grad(whole.placements))[idx]
        out_pl = tok_pl
    shape = (*tokens.shape, emb.shape[1])
    # the output's strides are given: those DTensor would infer from the local
    # shard's give a (B, 1, D) decode batch an unusual layout, on which a
    # later product dispatches a batched copy of its weight
    out = DTensor.from_local(rows, mi.mesh, out_pl, run_check=False, shape=shape,
                             stride=torch.empty(shape, device="meta").stride())
    return constrain(out, mi, (mi.split(mi.batch_axes, out.shape[0]),) + (None,) * (out.ndim - 1))


def _embed(cfg: ModelConfig, params, tokens: Tensor, vision: Optional[Tensor] = None,
           ctx: Optional[ApplyCtx] = None) -> Tensor:
    """Token embeddings, after the projected patch embeddings ``vision``
    (B, P, D) when given; on a mesh the batch is pinned to the data axes."""
    # the scale is cast to the embedding's dtype first: 50.5, not 50.596, in bf16
    emb = params["embed"]
    if ctx is not None:
        tokens = constrain_batch(tokens, ctx)
    x = _lookup(emb, tokens, ctx) * torch.tensor(cfg.d_model**0.5, dtype=emb.dtype,
                                                 device=emb.device)
    if vision is not None:
        x = torch.cat([vision.to(x.dtype) @ params["vision_proj"], x], dim=1)
    return x if ctx is None else constrain_batch(x, ctx)


def _head(cfg: ModelConfig, params, x: Tensor, ctx: Optional[ApplyCtx] = None) -> Tensor:
    """Logits; on a mesh the batch over the data axes and the vocab over the
    model axis where it divides."""
    mi = None if ctx is None else ctx.mesh_info
    if cfg.tie_embeddings:
        logits = torch.einsum("btd,vd->btv", x, zero_gathered(params["embed"], mi))
    else:
        logits = torch.einsum("btd,dv->btv", x, zero_gathered(params["head"], mi))
    if cfg.logit_softcap > 0:
        c = cfg.logit_softcap
        logits = torch.tanh(logits / c) * c
    if mi is not None:
        vocab = mi.split(mi.model_axis, cfg.vocab_size)
        logits = constrain_batch(logits, ctx, tail=[None] * (logits.ndim - 2) + [vocab])
    return logits


def _at(tree, i: int):
    """Cycle ``i`` of a stacked tree: views, so in-place writes reach the stack."""
    return tree_map(lambda t: t[i], tree)


def apply_cycle(cfg: ModelConfig, cycle_params, x: Tensor, *, ctx: ApplyCtx, positions: Tensor,
                length: Optional[Tensor] = None, caches=None, enc_out: Optional[Tensor] = None,
                aux: Optional[Tensor] = None) -> Tuple[Tensor, Optional[Tensor]]:
    """One pattern cycle: ``cycle_params`` and ``caches`` (or None) hold one
    entry a block of ``cfg.pattern``.  Its first step pins the residual
    stream: on a mesh the batch over the data axes, and with
    ``seq_parallel`` the sequence over the model axis where it divides.
    Returns (x, aux), the blocks' aux losses added to ``aux`` (None while no
    block has one)."""
    mi = ctx.mesh_info
    seq = mi.split(mi.model_axis, x.shape[1]) if ctx.seq_parallel and mi is not None else None
    x = constrain_batch(x, ctx, tail=[seq, None] if seq else None)
    for j, kind in enumerate(cfg.pattern):
        x, a = block_apply(cfg, kind, cycle_params[j], x, ctx=ctx, positions=positions,
                           length=length, cache=None if caches is None else caches[j],
                           enc_out=enc_out)
        if a is not None:
            aux = a if aux is None else aux + a
    return x, aux


def _run_stack(cfg: ModelConfig, params, x: Tensor, *, ctx: ApplyCtx, positions: Tensor,
               length: Optional[Tensor], cache: Optional[Dict[str, Any]],
               enc_out: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """The layer loop: every cycle of the pattern (``apply_cycle``), then the
    remainder.  Returns (x, the sum of the blocks' aux losses).  In train
    mode with a gradient, ``ctx.remat`` other than "none" runs each cycle
    under activation checkpointing, as the reference wraps its cycle in
    ``jax.checkpoint``: "full" recomputes all of it in the backward pass,
    "dots" and "outs" keep what ``remat_policy`` saves.  The remainder is
    not wrapped, and runs as under "none"."""
    n_cycles, rest = _cycles_and_rest(cfg)
    use = cache is not None
    train = ctx.mode == "train"
    if train and ctx.remat not in REMATS:
        raise ValueError(f"remat {ctx.remat!r}: {' | '.join(REMATS)}")
    remat = ctx.remat if train and torch.is_grad_enabled() else "none"
    plain = ctx if ctx.remat == "none" else dataclasses.replace(ctx, remat="none")

    def cycle(cycle_params, caches, x, aux, ctx=plain):
        return apply_cycle(cfg, cycle_params, x, ctx=ctx, positions=positions, length=length,
                           caches=caches, enc_out=enc_out, aux=aux)

    saving = {}
    if remat in ("dots", "outs"):
        weights = {_storage(t) for t in leaves(params["cycles"])}
        saving["context_fn"] = functools.partial(create_selective_checkpoint_contexts,
                                                 remat_policy(remat, weights))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(n_cycles):
        cycle_params = [_at(params["cycles"][j], i) for j in range(len(cfg.pattern))]
        caches = [_at(cache["cycles"][j], i) for j in range(len(cfg.pattern))] if use else None
        if remat == "none":
            x, aux = cycle(cycle_params, caches, x, aux)
        else:
            x, aux = checkpoint(cycle, cycle_params, caches, x, aux, ctx, use_reentrant=False,
                                **saving)
    for j, kind in enumerate(rest):
        x, a = block_apply(cfg, kind, params["rest"][j], x, ctx=plain, positions=positions,
                           length=length, cache=cache["rest"][j] if use else None,
                           enc_out=enc_out)
        if a is not None:
            aux = aux + a
    return x, aux


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype, device) -> Dict[str, Any]:
    """Decode cache for the whole stack and the position counter."""
    n_cycles, rest = _cycles_and_rest(cfg)

    def stacked(kind):
        one = init_block_cache(cfg, kind, batch, max_len, dtype, device)
        return tree_map(lambda t: t[None].repeat(n_cycles, *([1] * t.ndim)), one)

    return {
        "length": torch.zeros((), dtype=torch.int32, device=device),
        "cycles": [stacked(kind) for kind in cfg.pattern],
        "rest": [init_block_cache(cfg, kind, batch, max_len, dtype, device) for kind in rest],
    }


def forward_train(cfg: ModelConfig, params, tokens: Tensor, *, ctx: ApplyCtx,
                  vision: Optional[Tensor] = None,
                  enc_out: Optional[Tensor] = None) -> Tuple[Tensor, Tensor]:
    """Full-sequence forward, differentiable.  Returns (logits (B,T,V), aux),
    aux the sum of the MoE blocks' load-balance losses (0 without any); with
    ``vision`` T counts the patches before the tokens.  Parameters that do
    not require a gradient build no graph.  On a mesh (``ctx.mesh_info``)
    the parameters are DTensors and so are the logits."""
    with mesh_scope(ctx):
        x = _embed(cfg, params, tokens, vision, ctx)
        positions = torch.arange(x.shape[1], device=x.device)
        x, aux = _run_stack(cfg, params, x, ctx=ctx, positions=positions, length=None,
                            cache=None, enc_out=enc_out)
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        return _head(cfg, params, x, ctx), aux


@torch.no_grad()
def prefill(cfg: ModelConfig, params, tokens: Tensor, cache: Dict[str, Any], *,
            ctx: ApplyCtx, vision: Optional[Tensor] = None,
            enc_out: Optional[Tensor] = None) -> Tuple[Tensor, Dict[str, Any]]:
    """Fill the cache in place; returns (last-position logits (B, V), cache).
    ``cache["length"]`` counts the vision patches and the tokens.  On a mesh
    the cache's leaves are DTensors (``distributed.sharding.cache_shardings``),
    each shard written in place."""
    with mesh_scope(ctx):
        x = _embed(cfg, params, tokens, vision, ctx)
        t = x.shape[1]
        positions = torch.arange(t, device=x.device)
        x, _ = _run_stack(cfg, params, x, ctx=ctx, positions=positions, length=None,
                          cache=cache, enc_out=enc_out)
        x = rmsnorm(params["final_norm"], x[:, -1:], cfg.norm_eps)
        cache["length"].fill_(t)
        return _head(cfg, params, x, ctx)[:, 0], cache


@torch.no_grad()
def decode_step(cfg: ModelConfig, params, token: Tensor, cache: Dict[str, Any], *,
                ctx: ApplyCtx) -> Tuple[Tensor, Dict[str, Any]]:
    """One decode step of token (B, 1), the cache advanced in place.  Returns
    (logits (B, V), cache)."""
    with mesh_scope(ctx):
        length = cache["length"]
        x = _embed(cfg, params, token, None, ctx)
        x, _ = _run_stack(cfg, params, x, ctx=ctx, positions=length.reshape(1), length=length,
                          cache=cache)
        x = rmsnorm(params["final_norm"], x, cfg.norm_eps)
        logits = _head(cfg, params, x, ctx)[:, 0]
        length.add_(1)
        return logits, cache


# ---------------------------------------------------------------------------
# logical axes of the decode cache (the sharding rules)
# ---------------------------------------------------------------------------


def _block_cache_axes(cfg: ModelConfig, kind: str):
    """Logical axes tree parallel to ``init_block_cache``."""
    _check_kind(kind)
    kv = {"k": ("batch", "seq", "kv_heads", "head_dim"),
          "v": ("batch", "seq", "kv_heads", "head_dim")}
    if kind == "xdec":
        return {"self": dict(kv), "cross": dict(kv)}
    if kind == "mlstm":
        return {"C": ("batch", "heads", "head_dim", None), "n": ("batch", "heads", "head_dim"),
                "m": ("batch", "heads")}
    if kind == "slstm":
        ax = ("batch", "heads", "head_dim")
        return {"c": ax, "n": ax, "h": ax, "m": ax}
    if kind == "rglru":
        return {"h": ("batch", "rnn"), "conv": ("batch", None, "rnn")}
    return kv


def cache_axes_tree(cfg: ModelConfig):
    """Axes tree with the structure of ``init_cache``'s output."""
    n_cycles, rest = _cycles_and_rest(cfg)
    stacked = lambda kind: tree_map(lambda ax: ("layers", *ax), _block_cache_axes(cfg, kind))
    return {
        "length": (),
        "cycles": [stacked(kind) for kind in cfg.pattern],
        "rest": [_block_cache_axes(cfg, kind) for kind in rest],
    }
