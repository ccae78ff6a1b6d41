"""Compressed posterior representation + active-set refresh policy.

PyTorch counterpart of ``repro.core.compress``.  The dense (K, 2, G)
exponent log-posterior grid is the fleet estimator's memory and bandwidth
ceiling (~400 MB at K = 1e5, G = 512, re-evaluated every drain).  This
module breaks it for *converged* workers:

  * The **surrogate** is the moment-matched Beta fit the sampler already
    keeps — ``GibbsState.alpha_prior`` / ``beta_prior`` are the Eqs 12-18
    compression of the last full grid evaluation.  Sampling a converged
    worker's exponents from the frozen fit is within grid-integration error
    of re-evaluating the grid (:func:`surrogate_gap` measures it); the
    conjugate Normal-Gamma block needs no grid at all.  Positive-scale
    summaries compress to a log-normal, :func:`fit_lognormal_moments`.
  * The **active set** keeps the full grid for the M workers that still need
    it — young, surprising, anomalous or stale — ranked by
    :func:`select_active` from existing statistics into a fixed-size top-M.

``gibbs_batch(..., active_idx=...)`` consumes the selection: the gathered
M-worker slab runs the full grid path, everyone else the grid-free surrogate
sweep, and the results scatter back — bitwise the dense path at M = K.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import Tensor

from .gibbs import GibbsState
from .moments import (
    BetaParams,
    exponent_grid,
    fit_beta_method_of_moments,
    log_posterior_grid,
    moments_from_log_density,
)

# float32 leaves of one worker's compressed GibbsState: ng(mu0, kappa0, nu0,
# psi0) + alpha_prior(a, b) + beta_prior(a, b) + samples(mu, lam, alpha,
# beta).  The reference's PRNG key pair adds the same bytes to the dense and
# the compressed representation and is left out of the comparison.
COMPRESSED_LEAVES = 12


def beta_moments(p: BetaParams) -> Tuple[Tensor, Tensor]:
    """Analytic (E, Var) of Beta(a, b) — the surrogate's closed-form moments."""
    s = p.a + p.b
    mean = p.a / s
    var = p.a * p.b / (s * s * (s + 1.0))
    return mean, var


def fit_lognormal_moments(mean: Tensor, var: Tensor) -> Tuple[Tensor, Tensor]:
    """Log-normal (m, s2) matching (E, Var): LogNormal(m, s2) has that mean
    and variance.  The surrogate of positive-scale posteriors."""
    mean = torch.clamp(torch.as_tensor(mean, dtype=torch.float32), min=1e-12)
    var = torch.as_tensor(var, dtype=torch.float32, device=mean.device)
    s2 = torch.log1p(torch.clamp(var, min=0.0) / (mean * mean))
    m = torch.log(mean) - 0.5 * s2
    return m, s2


def surrogate_moments(state: GibbsState) -> Tuple[Tensor, Tensor]:
    """(E, Var) of the compressed exponent posteriors, shape (..., 2): index
    0 the alpha posterior, 1 the beta posterior (``log_posterior_grid``'s
    layout)."""
    ea, va = beta_moments(state.alpha_prior)
    eb, vb = beta_moments(state.beta_prior)
    return torch.stack([ea, eb], dim=-1), torch.stack([va, vb], dim=-1)


def grid_moments(
    state: GibbsState,
    t: Tensor,
    f: Tensor,
    mask: Optional[Tensor] = None,
    *,
    grid_size: int = 512,
) -> Tuple[Tensor, Tensor]:
    """(E, Var) of the dense exponent grid posterior, shape (..., 2), at the
    state's current conditioning samples — the grid the next full sweep
    would moment-fit, and the reference the surrogate is held against."""
    grid = exponent_grid(grid_size, device=t.device)
    logp = log_posterior_grid(
        grid, t, f, state.mu, state.lam, state.alpha, state.beta,
        state.alpha_prior, state.beta_prior, mask, symmetric_grid=True,
    )
    return moments_from_log_density(grid, logp)


def fit_surrogate(
    state: GibbsState,
    t: Tensor,
    f: Tensor,
    mask: Optional[Tensor] = None,
    *,
    grid_size: int = 512,
) -> Tuple[BetaParams, BetaParams]:
    """Moment-match fresh Beta surrogates to the dense grid posterior (what a
    full refresh chains into ``alpha_prior`` / ``beta_prior``)."""
    mean, var = grid_moments(state, t, f, mask, grid_size=grid_size)
    a = fit_beta_method_of_moments(mean[..., 0], var[..., 0])
    b = fit_beta_method_of_moments(mean[..., 1], var[..., 1])
    return a, b


def surrogate_gap(
    state: GibbsState,
    t: Tensor,
    f: Tensor,
    mask: Optional[Tensor] = None,
    *,
    grid_size: int = 512,
) -> Tuple[Tensor, Tensor]:
    """(|E_grid - E_surrogate|, |Var_grid - Var_surrogate|), shape (..., 2).

    For a converged worker the mean gap is < 1e-3, the bound for trusting
    the compressed path."""
    ge, gv = grid_moments(state, t, f, mask, grid_size=grid_size)
    se, sv = surrogate_moments(state)
    return torch.abs(ge - se), torch.abs(gv - sv)


def select_active(
    m: int,
    *,
    age: Tensor,
    nu: Optional[Tensor] = None,
    surprise: Optional[Tensor] = None,
    anomaly: Optional[Tensor] = None,
    live: Optional[Tensor] = None,
    youth_weight: float = 32.0,
    surprise_weight: float = 8.0,
    anomaly_weight: float = 4.0,
    youth_scale: float = 16.0,
) -> Tuple[Tensor, Tensor]:
    """Pick the fixed-size top-M active set; returns (idx (M,), priority (K,)).

    Priority sums existing fleet-health statistics: ``age`` (drains since
    the last full refresh), youth from the Normal-Gamma ``nu`` (effective
    sample size 2(nu - 1)), ``surprise`` and ``anomaly`` (each clipped at
    0); dead ``live`` slots drop to -inf.

    Ties go to the lower index, as ``lax.top_k`` breaks them: that order is
    what makes refresh round-robin (at start-up every age is saturated and
    every worker ties).  ``torch.topk`` promises no order among ties, so the
    top M come from a stable descending sort, which is exact on ties and on
    -inf.  Runs on the device of ``age`` with no host sync.
    """
    pri = age.to(torch.float32)
    if nu is not None:
        ess = torch.clamp(2.0 * (nu - 1.0), min=0.0)  # hier.effective_sample_size
        pri = pri + youth_weight * youth_scale / (youth_scale + ess)
    if surprise is not None:
        pri = pri + surprise_weight * torch.clamp(surprise, min=0.0)
    if anomaly is not None:
        pri = pri + anomaly_weight * torch.clamp(anomaly, min=0.0)
    if live is not None:
        pri = torch.where(live > 0, pri, -torch.inf)
    idx = torch.sort(pri, descending=True, stable=True).indices[:m]
    return idx, pri


class CompressionReport(NamedTuple):
    """Posterior-state footprint of dense vs compressed configurations."""

    dense_bytes: int
    compressed_bytes: int
    ratio: float


def compression_report(
    k: int, grid_size: int, active: int, *, dtype_bytes: int = 4
) -> CompressionReport:
    """Posterior-state bytes: dense (K, 2, G) grid vs active-set compressed
    (the grid for the M-worker slab only), both plus the per-worker scalar
    surrogate (COMPRESSED_LEAVES floats) every configuration carries."""
    scalars = k * COMPRESSED_LEAVES * dtype_bytes
    dense = k * 2 * grid_size * dtype_bytes + scalars
    compressed = min(active, k) * 2 * grid_size * dtype_bytes + scalars
    return CompressionReport(dense, compressed, dense / max(compressed, 1))
