"""Training step: loss, microbatched gradient accumulation, optimizer.

The port's counterpart of ``repro.train.train_step``, built in the same
units:

  microbatch fwd+bwd  --loop over M microbatches-->  grads
  grads  --[optional compression hook]-->  AdamW update

Heterogeneous work assignment (the paper's partitioner) is realized as
*weighted* gradient accumulation: each microbatch's gradients are combined
with its weight (weight 0 skips it), so shapes stay fixed when the split
changes.

The reference's ``lax.scan`` over microbatches is a Python loop here, and
``jax.value_and_grad`` is ``torch.autograd.grad`` over the parameter leaves,
which are made to require a gradient inside the step only: the parameters
the caller holds are plain tensors between steps.  Gradients come in the
parameters' dtype and accumulate in ``grad_dtype``.

On a mesh (``ctx.mesh_info``) the parameters are DTensors: the microbatches
are laid out (M, B/M, ...) with dim 1 over the data axes, each gradient is
reduced to its parameter's placements, and the loss and metrics come back
whole on every rank.
"""
from __future__ import annotations

from typing import Any, Callable, Dict, Optional, Tuple

import torch
from torch import Tensor

from ..configs.base import ModelConfig, RunConfig
from ..device import is_dtensor
from ..models import model_zoo
from ..models.layers import ApplyCtx, constrain, constrain_batch, mesh_scope
from ..models.params import leaves, unflatten
from ..optim import adamw

Z_LOSS_WEIGHT = 1e-4
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def cross_entropy(logits: Tensor, labels: Tensor, vocab: int) -> Tuple[Tensor, Tensor]:
    """Mean token cross-entropy + z-loss.  labels < 0 are masked."""
    logits = logits.float()
    mask = (labels >= 0).float()
    labels_safe = torch.clamp(labels, min=0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels_safe[..., None])[..., 0]
    nll = (logz - gold) * mask
    denom = torch.clamp(torch.sum(mask), min=1.0)
    xent = torch.sum(nll) / denom
    z = torch.sum(torch.square(logz) * mask) / denom
    return xent, z


def loss_fn(cfg: ModelConfig, params, batch: Dict[str, Tensor],
            ctx: ApplyCtx) -> Tuple[Tensor, Dict[str, Tensor]]:
    logits, aux = model_zoo.forward_train(cfg, params, batch, ctx=ctx)
    labels = batch["labels"]
    if cfg.vision_patches and logits.shape[1] != labels.shape[1]:
        logits = logits[:, -labels.shape[1]:]  # loss on text positions only
    if ctx.mesh_info is not None:  # the loss reads whole rows of the vocab
        logits, labels = constrain_batch(logits, ctx), constrain_batch(labels, ctx)
    xent, z = cross_entropy(logits, labels, cfg.vocab_size)
    loss = xent + Z_LOSS_WEIGHT * z + cfg.router_aux_weight * aux
    return loss, {"xent": xent, "aux": aux, "z": z}


def microbatch_value_and_grad(cfg: ModelConfig, ctx: ApplyCtx) -> Callable:
    """(params, microbatch) -> ((loss, metrics), grads), every output
    detached; a leaf the loss does not reach gets a zero gradient.  On a
    mesh each gradient has its parameter's placements (a partial sum is
    reduced) and the loss and metrics are whole tensors."""

    def f(params, mb):
        flat = [p.detach().requires_grad_(True) for p in leaves(params)]
        with torch.enable_grad(), mesh_scope(ctx):
            loss, metrics = loss_fn(cfg, unflatten(params, flat), mb, ctx)
            grads = torch.autograd.grad(loss, flat, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(flat, grads)]
        metrics = {k: v.detach() for k, v in metrics.items()}
        if is_dtensor(loss):
            grads = [g.redistribute(p.device_mesh, p.placements) for p, g in zip(flat, grads)]
            loss = loss.full_tensor()
            metrics = {k: v.full_tensor() if is_dtensor(v) else v for k, v in metrics.items()}
        return (loss.detach(), metrics), unflatten(params, grads)

    return f


def split_microbatches(batch: Dict[str, Tensor], m: int) -> Dict[str, Tensor]:
    """Microbatch split: (B, ...) -> (M, B/M, ...)."""

    def r(x):
        b = x.shape[0]
        if b % m:
            raise ValueError(f"batch {b} not divisible into {m} microbatches")
        return x.reshape(m, b // m, *x.shape[1:])

    return {k: r(v) for k, v in batch.items()}


def accumulate_grads(
    cfg: ModelConfig,
    params,
    batch: Dict[str, Tensor],
    *,
    ctx: ApplyCtx,
    num_microbatches: int,
    weights: Optional[Tensor] = None,
    grad_dtype=torch.float32,
) -> Tuple[Any, Dict[str, Tensor]]:
    """Gradients accumulated over microbatches, ``acc += w * g`` in
    ``grad_dtype``, divided by max(sum w, 1e-9) at the end.

    weights: optional (M,) per-microbatch weights (the partitioner's
    heterogeneous split; weight 0 skips a microbatch's contribution).
    ``batch`` leaves are microbatched already: (M, B/M, ...), dim 1 placed
    over the data axes on a mesh.  ``metrics`` hold the unweighted means of
    xent, aux and z over the microbatches and the weighted mean ``loss``.
    """
    vg = microbatch_value_and_grad(cfg, ctx)
    device = leaves(params)[0].device
    if weights is None:
        weights = torch.ones((num_microbatches,), dtype=torch.float32, device=device)
    weights = weights.to(device=device, dtype=torch.float32)
    wsum = torch.clamp(torch.sum(weights), min=1e-9)
    mi = ctx.mesh_info
    if mi is not None:
        batch = {k: constrain(v, mi, (None, mi.batch_axes, *[None] * (v.ndim - 2)))
                 for k, v in batch.items()}
    acc = [torch.zeros_like(p, dtype=grad_dtype) if is_dtensor(p)
           else torch.zeros(p.shape, dtype=grad_dtype, device=p.device) for p in leaves(params)]
    loss_sum = torch.zeros((), dtype=torch.float32, device=device)
    per_mb = []
    for i in range(num_microbatches):
        (loss, metrics), grads = vg(params, {k: v[i] for k, v in batch.items()})
        w = weights[i]
        for a, g in zip(acc, leaves(grads)):
            a.add_(w.to(grad_dtype) * g.to(grad_dtype))
        del grads
        loss_sum = loss_sum + w * loss
        per_mb.append(metrics)
    metrics = {k: torch.mean(torch.stack([m[k].float() for m in per_mb])) for k in per_mb[0]}
    metrics["loss"] = loss_sum / wsum
    # float32 out, as the reference's (grad_dtype) / float32 division promotes
    return unflatten(params, [a.float().div_(wsum) for a in acc]), metrics


def make_train_step(
    cfg: ModelConfig,
    run: RunConfig,
    *,
    ctx: ApplyCtx,
    num_microbatches: int,
    compression: Optional[Callable] = None,
) -> Callable:
    """Full train step: accum -> (compress w/ error feedback) -> clip -> AdamW.

    Signature without compression:
        (params, opt_state, batch, step[, mb_weights]) ->
        (params, opt_state, metrics)
    With compression (fn: (grads, ef) -> (grads, ef)), an ``ef`` tree rides
    through the step:
        (params, opt_state, batch, step, mb_weights, ef) ->
        (params, opt_state, metrics, ef)
    """
    schedule = adamw.cosine_schedule(run.learning_rate, run.warmup_steps, run.total_steps)
    grad_dt = DTYPES[run.grad_dtype]

    def _finish(params, opt_state, grads, step, metrics):
        lr = schedule(step)
        params, opt_state, gnorm = adamw.apply(
            params, grads, opt_state, lr,
            weight_decay=run.weight_decay, grad_clip=run.grad_clip,
        )
        metrics["grad_norm"] = gnorm
        metrics["lr"] = lr
        return params, opt_state, metrics

    def accumulate(params, batch, mb_weights):
        return accumulate_grads(cfg, params, batch, ctx=ctx, num_microbatches=num_microbatches,
                                weights=mb_weights, grad_dtype=grad_dt)

    if compression is None:
        def step_fn(params, opt_state, batch, step, mb_weights=None):
            grads, metrics = accumulate(params, batch, mb_weights)
            return _finish(params, opt_state, grads, step, metrics)

        return step_fn

    def step_fn_c(params, opt_state, batch, step, mb_weights, ef):
        grads, metrics = accumulate(params, batch, mb_weights)
        grads, ef = compression(grads, ef)
        params, opt_state, metrics = _finish(params, opt_state, grads, step, metrics)
        return params, opt_state, metrics, ef

    return step_fn_c


def make_optimizer_unit(cfg: ModelConfig, run: RunConfig) -> Callable:
    """Optimizer-only unit: (params, opt_state, grads) -> (params, opt_state,
    grad_norm) at the run's base learning rate, made on the parameters'
    device."""

    def opt_fn(params, opt_state, grads):
        lr = torch.tensor(run.learning_rate, device=leaves(params)[0].device)
        return adamw.apply(params, grads, opt_state, lr,
                           weight_decay=run.weight_decay, grad_clip=run.grad_clip)

    return opt_fn
