"""Carry estimator and service state and model parameters over from the JAX package.

The JAX states (``GibbsState``, ``SchedulerState``, ``DagState``,
``Hyperprior``, ``GateState``, ``TelemetryRing``, ``ServeState``) are
NamedTuples; handed
over as the same trees with numpy arrays for leaves (``tree_map(np.asarray,
state)`` on the JAX side), they become the port's states on a given device.
Fields are read by name, so this module imports neither JAX nor ``repro``.
The JAX ``key`` leaves are dropped: the port's generator is seeded from an
explicit ``seed``.  A model's parameter tree has the same layout in both
packages, so it carries over leaf for leaf (``model_params_from_jax``).
"""
from __future__ import annotations

import numpy as np
import torch

from .core.frontier import UnitParams
from .core.gibbs import GibbsState
from .core.moments import BetaParams
from .core.posterior import NormalGammaParams
from .hier.hyperprior import Hyperprior
from .models.params import tree_map
from .sched.dag import DagState
from .sched.scheduler import ProposeStats, SchedulerState
from .serve.gate import GateState
from .serve.ring import TelemetryRing
from .serve.service import ServeState


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
    return GibbsState(
        ng=NormalGammaParams(*(_tensor(getattr(ng, k), device) for k in NormalGammaParams._fields)),
        alpha_prior=_beta(tree.alpha_prior, device),
        beta_prior=_beta(tree.beta_prior, device),
        mu=_tensor(tree.mu, device),
        lam=_tensor(tree.lam, device),
        alpha=_tensor(tree.alpha, device),
        beta=_tensor(tree.beta, device),
    )


def to_scheduler_state(tree, *, seed: int, device) -> SchedulerState:
    """A JAX ``SchedulerState`` of numpy leaves -> the port's state, with a
    fresh generator seeded from ``seed``; a capacity state keeps its live
    mask."""
    device = torch.device(device)
    live = getattr(tree, "live", None)
    return SchedulerState(
        gibbs=to_gibbs_state(tree.gibbs, device),
        ewma_ll=_tensor(tree.ewma_ll, device),
        ewma_count=_tensor(tree.ewma_count, device, torch.int32),
        step=_tensor(tree.step, device, torch.int32),
        generator=torch.Generator(device=device).manual_seed(int(seed)),
        live=None if live is None else _tensor(live, device),
    )


def to_dag_state(tree, *, seed: int, device) -> DagState:
    """A JAX ``DagState`` of numpy leaves ((S, K, ...) posteriors) -> the
    port's, with a fresh generator seeded from ``seed``."""
    device = torch.device(device)
    return DagState(
        gibbs=to_gibbs_state(tree.gibbs, device),
        step=_tensor(tree.step, device, torch.int32),
        generator=torch.Generator(device=device).manual_seed(int(seed)),
    )


def _beta(p, device) -> BetaParams:
    return BetaParams(_tensor(p.a, device), _tensor(p.b, device))


def to_hyperprior(tree, device) -> Hyperprior:
    """A JAX ``Hyperprior`` of numpy leaves -> the port's."""
    return Hyperprior(
        ng=NormalGammaParams(*(_tensor(getattr(tree.ng, k), device)
                               for k in NormalGammaParams._fields)),
        alpha_prior=_beta(tree.alpha_prior, device),
        beta_prior=_beta(tree.beta_prior, device),
        n_workers=_tensor(tree.n_workers, device),
    )


def to_gate_state(tree, device) -> GateState:
    """A JAX ``GateState`` of numpy leaves -> the port's."""
    return GateState(mean=_tensor(tree.mean, device), var=_tensor(tree.var, device),
                     count=_tensor(tree.count, device, torch.int32))


def to_ring(tree, device) -> TelemetryRing:
    """A JAX ``TelemetryRing`` of numpy leaves -> the port's."""
    i32 = lambda x: _tensor(x, device, torch.int32)
    return TelemetryRing(
        fracs=_tensor(tree.fracs, device), times=_tensor(tree.times, device),
        valid=_tensor(tree.valid, device), head=i32(tree.head), count=i32(tree.count),
        dropped=i32(tree.dropped), total=i32(tree.total),
    )


def to_serve_state(tree, *, seed: int, device) -> ServeState:
    """A JAX ``ServeState`` of numpy leaves -> the port's, with the
    scheduler's generator seeded from ``seed``."""
    device = torch.device(device)
    f32 = lambda x: _tensor(x, device)
    i32 = lambda x: _tensor(x, device, torch.int32)
    age = getattr(tree, "refresh_age", None)
    return ServeState(
        sched=to_scheduler_state(tree.sched, seed=seed, device=device),
        ring=to_ring(tree.ring, device),
        fractions=f32(tree.fractions),
        stats=ProposeStats(*(f32(getattr(tree.stats, k)) for k in ProposeStats._fields)),
        ref=UnitParams(*(f32(getattr(tree.ref, k)) for k in UnitParams._fields)),
        staleness=i32(tree.staleness),
        n_drains=i32(tree.n_drains),
        n_proposes=i32(tree.n_proposes),
        last_drift=f32(tree.last_drift),
        gate=to_gate_state(tree.gate, device),
        hyper=to_hyperprior(tree.hyper, device),
        hyper_age=i32(tree.hyper_age),
        refresh_age=None if age is None else i32(age),
    )
