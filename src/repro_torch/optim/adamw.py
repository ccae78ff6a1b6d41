"""AdamW with decoupled weight decay, global-norm clipping, LR schedules.

The port's counterpart of ``repro.optim.adamw``.  The optimizer state is a
tree parallel to the parameters (m, v in ``dtype``, float32 by default) and
a step count.  The update is done in float32 and cast once to each leaf's
dtype, as the reference does: ``torch.optim.AdamW`` would do its arithmetic
in a bfloat16 parameter's own dtype and round differently.  Leaves are
updated one at a time, so the float32 temporaries of one leaf are freed
before the next.  Nothing here reads the device.  ``abstract_state`` gives
the state's shapes alone, for the dry run.
"""
from __future__ import annotations

import math
from typing import Any, Callable, NamedTuple, Tuple, Union

import torch
from torch import Tensor

from ..models.params import leaves, tree_map, unflatten


class AdamWState(NamedTuple):
    m: Any
    v: Any
    count: Tensor  # int32 scalar on the parameters' device


def init(params: Any, dtype=torch.float32) -> AdamWState:
    zeros = lambda p: torch.zeros(p.shape, dtype=dtype, device=p.device)
    device = leaves(params)[0].device
    return AdamWState(m=tree_map(zeros, params), v=tree_map(zeros, params),
                      count=torch.zeros((), dtype=torch.int32, device=device))


def abstract_state(abstract_params: Any, dtype=torch.float32) -> AdamWState:
    """The state's shapes, allocating nothing: m and v in ``dtype`` on the
    abstract parameters' device (``meta``, or fake tensors under
    ``FakeTensorMode``), ``count`` an int32 scalar there."""
    mk = lambda p: torch.empty(p.shape, dtype=dtype, device=p.device)
    device = leaves(abstract_params)[0].device
    return AdamWState(m=tree_map(mk, abstract_params), v=tree_map(mk, abstract_params),
                      count=torch.empty((), dtype=torch.int32, device=device))


def global_norm(tree: Any) -> Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(l.float())) for l in leaves(tree)))


def clip_by_global_norm(grads: Any, max_norm: float) -> Tuple[Any, Tensor]:
    norm = global_norm(grads)
    scale = torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)
    return tree_map(lambda g: g * scale.to(g.dtype), grads), norm


def apply(
    params: Any,
    grads: Any,
    state: AdamWState,
    lr: Union[Tensor, float],
    *,
    b1: float = 0.9,
    b2: float = 0.95,
    eps: float = 1e-8,
    weight_decay: float = 0.1,
    grad_clip: float = 1.0,
) -> Tuple[Any, AdamWState, Tensor]:
    """One AdamW update.  Returns (params, state, grad_norm); the inputs are
    left as they were."""
    if grad_clip > 0:
        grads, norm = clip_by_global_norm(grads, grad_clip)
    else:
        norm = global_norm(grads)
    count = state.count + 1
    c1 = 1.0 - b1 ** count.float()
    c2 = 1.0 - b2 ** count.float()

    def upd(p, g, m, v):
        g32 = g.float()
        m2 = b1 * m.float() + (1.0 - b1) * g32
        v2 = b2 * v.float() + (1.0 - b2) * g32 * g32
        del g32
        step = (m2 / c1) / (torch.sqrt(v2 / c2) + eps) + weight_decay * p.float()
        p2 = p.float() - lr * step
        return p2.to(p.dtype), m2.to(m.dtype), v2.to(v.dtype)

    flat = [upd(*x) for x in zip(leaves(params), leaves(grads), leaves(state.m), leaves(state.v))]
    rebuild = lambda i: unflatten(params, [o[i] for o in flat])
    return rebuild(0), AdamWState(rebuild(1), rebuild(2), count), norm


def cosine_schedule(base_lr: float, warmup_steps: int,
                    total_steps: int) -> Callable[[Union[Tensor, int]], Tensor]:
    """step -> learning rate, a float32 scalar: linear warmup from 0, then
    a cosine decay to 0 at ``total_steps``."""

    def lr(step) -> Tensor:
        s = torch.as_tensor(step).float()
        warm = s / max(warmup_steps, 1)
        prog = torch.clamp((s - warmup_steps) / max(total_steps - warmup_steps, 1), 0.0, 1.0)
        cos = 0.5 * (1.0 + torch.cos(math.pi * prog))
        return base_lr * torch.where(s < warmup_steps, warm, cos)

    return lr
