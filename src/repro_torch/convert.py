"""Carry estimator state and model parameters over from the JAX package.

The JAX ``GibbsState`` and ``SchedulerState`` are NamedTuples; handed over
as the same trees with numpy arrays for leaves (``tree_map(np.asarray,
state)`` on the JAX side), they become the port's states on a given device.
Fields are read by name, so this module imports neither JAX nor ``repro``.
The JAX ``key`` leaves are dropped: the port's generator is seeded from an
explicit ``seed``.  A model's parameter tree has the same layout in both
packages, so it carries over leaf for leaf (``model_params_from_jax``).
"""
from __future__ import annotations

import numpy as np
import torch

from .core.gibbs import GibbsState
from .core.moments import BetaParams
from .core.posterior import NormalGammaParams
from .models.params import tree_map
from .sched.scheduler import SchedulerState


def _tensor(x, device, dtype=torch.float32) -> torch.Tensor:
    return torch.tensor(np.asarray(x), dtype=dtype, device=device)  # a copy


def _leaf(x, device) -> torch.Tensor:
    """A numpy leaf, bfloat16 (ml_dtypes) included, as a tensor of its dtype."""
    x = np.asarray(x)
    if x.dtype.name == "bfloat16":
        return torch.from_numpy(x.view(np.uint16).copy()).view(torch.bfloat16).to(device)
    return torch.tensor(x, device=device)


def model_params_from_jax(tree, device):
    """A JAX model parameter tree (nested dicts and lists, numpy leaves) ->
    the port's tree on ``device``, each leaf in its own dtype."""
    return tree_map(lambda x: _leaf(x, device), tree)


def to_gibbs_state(tree, device) -> GibbsState:
    """A JAX ``GibbsState`` of numpy leaves -> the port's ``GibbsState``."""
    ng = tree.ng
    beta_params = lambda p: BetaParams(_tensor(p.a, device), _tensor(p.b, device))
    return GibbsState(
        ng=NormalGammaParams(*(_tensor(getattr(ng, k), device) for k in NormalGammaParams._fields)),
        alpha_prior=beta_params(tree.alpha_prior),
        beta_prior=beta_params(tree.beta_prior),
        mu=_tensor(tree.mu, device),
        lam=_tensor(tree.lam, device),
        alpha=_tensor(tree.alpha, device),
        beta=_tensor(tree.beta, device),
    )


def to_scheduler_state(tree, *, seed: int, device) -> SchedulerState:
    """A JAX ``SchedulerState`` of numpy leaves -> the port's state, with a
    fresh generator seeded from ``seed``.  Capacity-slot states (a ``live``
    mask) are not ported yet."""
    if getattr(tree, "live", None) is not None:
        raise ValueError("capacity-slot scheduler states (live mask) are not ported yet")
    device = torch.device(device)
    return SchedulerState(
        gibbs=to_gibbs_state(tree.gibbs, device),
        ewma_ll=_tensor(tree.ewma_ll, device),
        ewma_count=_tensor(tree.ewma_count, device, torch.int32),
        step=_tensor(tree.step, device, torch.int32),
        generator=torch.Generator(device=device).manual_seed(int(seed)),
    )
