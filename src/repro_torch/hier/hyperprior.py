"""Empirical-Bayes fleet hyperprior: cold-start, transfer, drift scoring.

PyTorch counterpart of ``repro.hier.hyperprior``.  The paper infers each
processing unit independently, so a worker that joins the fleet starts from
the vague global prior and spends its first observations re-learning what
the fleet already knows.  This module pools
strength across the fleet without touching the per-worker estimator:

  * :func:`fit_hyperprior` — fleet-level hyperparameters moment-matched from
    the per-worker posteriors: a pooled Normal-Gamma over each worker's
    (mu, lambda) and pooled Beta summaries of the exponent posteriors.  The
    refit is a per-worker map and a sum over the fleet (13 scalars,
    :func:`hyper_stats`), then :func:`hyper_from_stats`; over a mesh
    (:func:`fit_hyperprior_sharded`) each rank sums its own rows and one
    ``all_reduce`` adds the 13 scalars.  The refit sums in float64: its
    between-worker variances are E[x^2] - E[x]^2 of nearly equal terms
    (a fleet of well-learned workers cancels ~50-fold), so in float32 the
    order of the sum, one device's or a mesh's, would show in the result.
  * :func:`shrink` — blend each worker toward the fleet prior with weight
    ``w = tau / (tau + ess)``: a cold worker (ess 0) lands on the pool, a
    mature one keeps its own data, weight 0 is a bitwise no-op.
  * :func:`surprise` — per-worker log-density ratio of the pool's typical
    parameters and the worker's under the pooled prior: the drift statistic
    behind the serve gate, whose null level does not grow with K.

``shrink`` and ``surprise`` are strictly per-worker, so with ``sharding``
each rank computes its own rows (``repro_torch.sharding.shard_fleet_call``) and the
rows are all-gathered; only the O(1) hyperprior is replicated.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
import torch.distributed as dist
from torch import Tensor

from repro_torch.core.distributions import (
    EPS,
    TINY,
    beta_logpdf,
    gamma_logpdf,
    normal_logpdf,
)
from repro_torch.core.gibbs import GibbsState, init_state
from repro_torch.core.moments import BetaParams
from repro_torch.core.posterior import NormalGammaParams
from repro_torch.sharding import (
    ShardingConfig,
    local_rows,
    pad_fleet_axis,
    pad_fleet_mask,
    shard_fleet_call,
)

# The Normal-Gamma pseudo-count every per-worker chain starts from: nu0 = 1.
# Effective sample size counts observations accumulated past it.
_NU_INIT = 1.0
# Default pseudo-observation strength of the fleet prior in ``shrink``.
DEFAULT_STRENGTH = 8.0


class Hyperprior(NamedTuple):
    """Fleet-level hyperparameters; scalar tensors.  ``n_workers`` is the
    (masked) worker count the fit pooled."""

    ng: NormalGammaParams
    alpha_prior: BetaParams
    beta_prior: BetaParams
    n_workers: Tensor  # float32 scalar


class HyperStats(NamedTuple):
    """Sufficient statistics of the refit: sums over (masked) workers of the
    posterior means of mu (m*), lambda (l*), alpha (a*) and beta (b*), and of
    the within-worker posterior variances (v*), in float64."""

    n: Tensor
    m1: Tensor
    m2: Tensor
    vm: Tensor
    l1: Tensor
    l2: Tensor
    vl: Tensor
    a1: Tensor
    a2: Tensor
    va: Tensor
    b1: Tensor
    b2: Tensor
    vb: Tensor


def hyper_init(mu_guess: float = 1.0, device=None) -> Hyperprior:
    """The global prior as a degenerate hyperprior (nothing pooled yet)."""
    return Hyperprior(
        ng=NormalGammaParams.default(mu_guess, device=device),
        alpha_prior=BetaParams.default(device=device),
        beta_prior=BetaParams.default(device=device),
        n_workers=torch.zeros((), dtype=torch.float32, device=device),
    )


def _beta_mean_var(p: BetaParams) -> Tuple[Tensor, Tensor]:
    s = p.a + p.b
    mean = p.a / torch.clamp(s, min=TINY)
    var = p.a * p.b / torch.clamp(s * s * (s + 1.0), min=TINY)
    return mean, var


def hyper_stats(fleet: GibbsState, mask: Optional[Tensor] = None) -> HyperStats:
    """Sufficient statistics of the refit from a (K,)-leaf fleet state;
    ``mask`` excludes workers (dead slots) with weight 0.  The per-worker
    terms are computed in float32, then squared and summed in float64
    (module docstring)."""
    ng = fleet.ng
    m_k = ng.mu0.to(torch.float32)
    lam_k = (ng.nu0 / torch.clamp(ng.psi0, min=TINY)).to(torch.float32)
    # Within-worker posterior variances: Var[mu] = psi/(kappa (nu-1)) (guarded
    # for vague nu), Var[lambda] = nu/psi^2.
    vmu_k = ng.psi0 / torch.clamp(ng.kappa0 * torch.clamp(ng.nu0 - 1.0, min=0.1), min=TINY)
    vlam_k = ng.nu0 / torch.clamp(ng.psi0 * ng.psi0, min=TINY)
    a_mean, a_var = _beta_mean_var(fleet.alpha_prior)
    b_mean, b_var = _beta_mean_var(fleet.beta_prior)
    m_k, lam_k, vmu_k, vlam_k, a_mean, a_var, b_mean, b_var = (
        x.to(torch.float64) for x in (m_k, lam_k, vmu_k, vlam_k, a_mean, a_var, b_mean, b_var))

    w = torch.ones_like(m_k) if mask is None else torch.as_tensor(mask).to(m_k.dtype)
    s = lambda x: torch.sum(w * x, dim=-1)
    return HyperStats(
        n=s(torch.ones_like(m_k)),
        m1=s(m_k), m2=s(m_k * m_k), vm=s(vmu_k),
        l1=s(lam_k), l2=s(lam_k * lam_k), vl=s(vlam_k),
        a1=s(a_mean), a2=s(a_mean * a_mean), va=s(a_var),
        b1=s(b_mean), b2=s(b_mean * b_mean), vb=s(b_var),
    )


def _pool_beta(m1: Tensor, m2: Tensor, vw: Tensor, n: Tensor) -> BetaParams:
    """Moment-match a Beta to a population of Beta posteriors: total
    variance = between-worker spread of the means + mean within-worker
    variance, so a fleet of vague posteriors yields a vague pool."""
    mean = torch.clamp(m1 / n, EPS, 1.0 - EPS)
    var = torch.clamp(m2 / n - mean * mean, min=0.0) + vw / n
    var = torch.clamp(var, min=1e-6)
    conc = torch.clamp(mean * (1.0 - mean) / var - 1.0, 0.5, 1e4)
    return BetaParams(a=mean * conc, b=(1.0 - mean) * conc)


def hyper_from_stats(stats: HyperStats) -> Hyperprior:
    """Moment-match the pooled hyperprior from the sufficient statistics.

    ``mu0`` is the fleet mean of E[mu_k]; ``kappa0`` solves 1/(kappa0
    lambda_bar) = V_mu, the fleet's total mu variance; Gamma(a0, b0) over
    lambda matches the mean and total variance of the per-worker precision
    means with b0 = a0 / lambda_bar; the exponent pools are Beta moment
    matches of the per-worker Beta posteriors.
    """
    n = torch.clamp(stats.n, min=1.0)
    mu0 = stats.m1 / n
    v_mu = torch.clamp(stats.m2 / n - mu0 * mu0, min=0.0) + stats.vm / n + 1e-8
    lam_bar = torch.clamp(stats.l1 / n, min=TINY)
    kappa0 = torch.clamp(1.0 / (v_mu * lam_bar), 1e-3, 1e6)
    v_lam = torch.clamp(stats.l2 / n - lam_bar * lam_bar, min=0.0) + stats.vl / n + 1e-8
    a0 = torch.clamp(lam_bar * lam_bar / v_lam, 0.51, 1e6)
    b0 = a0 / lam_bar
    f32 = lambda x: x.to(torch.float32)
    pool = lambda p: BetaParams(a=f32(p.a), b=f32(p.b))
    return Hyperprior(
        ng=NormalGammaParams(mu0=f32(mu0), kappa0=f32(kappa0), nu0=f32(a0), psi0=f32(b0)),
        alpha_prior=pool(_pool_beta(stats.a1, stats.a2, stats.va, n)),
        beta_prior=pool(_pool_beta(stats.b1, stats.b2, stats.vb, n)),
        n_workers=f32(stats.n),
    )


def fit_hyperprior(fleet: GibbsState, mask: Optional[Tensor] = None, group=None) -> Hyperprior:
    """Empirical-Bayes refit of the fleet hyperprior from per-worker
    posteriors (the ``gibbs`` leaf of a ``SchedulerState``).  Runs on the
    fleet's device with no host sync.

    With ``group`` (a process group, each rank holding its own workers) the
    13 sufficient statistics are summed over the group's ranks with one
    ``all_reduce``, the reference's ``psum`` over ``axis_name``; every rank
    then returns the same hyperprior (:func:`fit_hyperprior_sharded`).
    The statistics are summed, reduced and combined in float64 (module
    docstring) and the hyperprior returned in float32.
    """
    stats = hyper_stats(fleet, mask)
    if group is not None:
        flat = torch.stack(tuple(stats))
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=group)
        stats = HyperStats(*flat.unbind(0))
    return hyper_from_stats(stats)


def fit_hyperprior_sharded(
    fleet: GibbsState, sharding: ShardingConfig, mask: Optional[Tensor] = None
) -> Hyperprior:
    """The refit over the fleet mesh: each rank reduces its K_pad / n
    workers to 13 scalars, one ``all_reduce`` adds them, and every rank
    returns the same hyperprior.  K not dividing the shard count is padded
    with mask-0 dummy workers, which add nothing to any statistic.  The sum
    runs in another order than :func:`fit_hyperprior`'s, in float64, so the
    two agree to float32 rounding, not bit for bit."""
    k = fleet.ng.mu0.shape[0]
    m = (torch.ones((k,), dtype=torch.float32, device=fleet.ng.mu0.device) if mask is None
         else torch.broadcast_to(torch.as_tensor(mask, device=fleet.ng.mu0.device), (k,))
         .to(torch.float32))
    pad = sharding.pad(k)
    return fit_hyperprior(local_rows(pad_fleet_axis(fleet, pad), sharding),
                          local_rows(pad_fleet_mask(m, pad), sharding), group=sharding.group)


# --------------------------------------------------------------------------
# shrinkage
# --------------------------------------------------------------------------
def effective_sample_size(fleet: GibbsState) -> Tensor:
    """Observations each worker's posterior has absorbed, (K,): ``2 (nu -
    1)``, since nu grows by n/2 per batch from its birth value 1."""
    return torch.clamp(2.0 * (fleet.ng.nu0 - _NU_INIT), min=0.0)


def shrinkage_weight(fleet: GibbsState, strength: float = DEFAULT_STRENGTH) -> Tensor:
    """Fleet-prior weight ``w = tau / (tau + ess)`` per worker, (K,) in [0, 1]."""
    return strength / (strength + effective_sample_size(fleet))


def _log_blend(own: Tensor, pool: Tensor, w: Tensor) -> Tensor:
    """Geometric interpolation for positive scale/pseudo-count parameters."""
    return torch.exp((1.0 - w) * torch.log(torch.clamp(own, min=TINY))
                     + w * torch.log(torch.clamp(pool, min=TINY)))


def _shrink_body(fleet: GibbsState, hyper: Hyperprior, w: Tensor) -> GibbsState:
    """Blend the workers of ``fleet`` toward the (replicated) fleet prior."""
    guard = lambda own, blended: torch.where(w > 0.0, blended, own)
    ng, h = fleet.ng, hyper.ng
    new_ng = NormalGammaParams(
        mu0=guard(ng.mu0, ng.mu0 + w * (h.mu0 - ng.mu0)),
        kappa0=guard(ng.kappa0, _log_blend(ng.kappa0, h.kappa0, w)),
        nu0=guard(ng.nu0, _log_blend(ng.nu0, h.nu0, w)),
        psi0=guard(ng.psi0, _log_blend(ng.psi0, h.psi0, w)),
    )
    blend_beta = lambda own, pool: BetaParams(
        a=guard(own.a, _log_blend(own.a, pool.a, w)),
        b=guard(own.b, _log_blend(own.b, pool.b, w)),
    )
    lam_pool = h.nu0 / torch.clamp(h.psi0, min=TINY)
    a_pool, _ = _beta_mean_var(hyper.alpha_prior)
    b_pool, _ = _beta_mean_var(hyper.beta_prior)
    return fleet._replace(
        ng=new_ng,
        alpha_prior=blend_beta(fleet.alpha_prior, hyper.alpha_prior),
        beta_prior=blend_beta(fleet.beta_prior, hyper.beta_prior),
        mu=guard(fleet.mu, fleet.mu + w * (h.mu0 - fleet.mu)),
        lam=guard(fleet.lam, _log_blend(fleet.lam, lam_pool, w)),
        alpha=guard(fleet.alpha,
                    torch.clamp(fleet.alpha + w * (a_pool - fleet.alpha), EPS, 1.0 - EPS)),
        beta=guard(fleet.beta,
                   torch.clamp(fleet.beta + w * (b_pool - fleet.beta), EPS, 1.0 - EPS)),
    )


def shrink(
    fleet: GibbsState,
    hyper: Hyperprior,
    weight=None,
    *,
    strength: float = DEFAULT_STRENGTH,
    sharding: Optional[ShardingConfig] = None,
) -> GibbsState:
    """Blend each worker's posterior toward the fleet prior.

    ``weight`` (scalar or (K,)) overrides the rule ``w = strength /
    (strength + ess)``.  ``weight=0`` is a bitwise no-op on every leaf, a
    cold worker (ess 0) lands on the hyperprior, a mature worker barely
    moves.  The chain's current samples are pulled along with its prior,
    since they weight the next sweep's Normal-Gamma update.  The blend is
    per-worker, so with ``sharding`` each rank blends its own rows and the
    rows are all-gathered.
    """
    if weight is None:
        w = shrinkage_weight(fleet, strength)
    else:
        w = torch.broadcast_to(
            torch.as_tensor(weight, dtype=torch.float32, device=fleet.ng.mu0.device),
            fleet.ng.mu0.shape,
        )
    if sharding is None or fleet.ng.mu0.ndim == 0:
        return _shrink_body(fleet, hyper, w)
    return shard_fleet_call(lambda fl, ww: _shrink_body(fl, hyper, ww), sharding, (fleet, w))


# --------------------------------------------------------------------------
# surprise
# --------------------------------------------------------------------------
def _hyper_logpdf(hyper: Hyperprior, mu: Tensor, lam: Tensor, alpha: Tensor,
                  beta: Tensor) -> Tensor:
    """Log-density of worker parameters under the pooled hyperprior."""
    h = hyper.ng
    scale_mu = 1.0 / torch.sqrt(torch.clamp(h.kappa0 * lam, min=TINY))
    return (
        normal_logpdf(mu, h.mu0, scale_mu)
        + gamma_logpdf(lam, h.nu0, h.psi0)
        + beta_logpdf(alpha, hyper.alpha_prior.a, hyper.alpha_prior.b)
        + beta_logpdf(beta, hyper.beta_prior.a, hyper.beta_prior.b)
    )


def _surprise_body(fleet: GibbsState, hyper: Hyperprior) -> Tensor:
    lam_k = fleet.ng.nu0 / torch.clamp(fleet.ng.psi0, min=TINY)
    a_k, _ = _beta_mean_var(fleet.alpha_prior)
    b_k, _ = _beta_mean_var(fleet.beta_prior)
    logp_k = _hyper_logpdf(hyper, fleet.ng.mu0, lam_k, a_k, b_k)

    # The reference point: the hyperprior's own typical parameters.
    lam_t = hyper.ng.nu0 / torch.clamp(hyper.ng.psi0, min=TINY)
    a_t, _ = _beta_mean_var(hyper.alpha_prior)
    b_t, _ = _beta_mean_var(hyper.beta_prior)
    logp_t = _hyper_logpdf(hyper, hyper.ng.mu0, lam_t, a_t, b_t)
    return (logp_t - logp_k).to(torch.float32)


def surprise(
    fleet: GibbsState, hyper: Hyperprior, *, sharding: Optional[ShardingConfig] = None
) -> Tensor:
    """Per-worker drift score against the pooled prior; (K,), on the device.

    ``log p(theta_typical | hyper) - log p(theta_k | hyper)`` with theta_k
    worker k's posterior point estimates and theta_typical the hyperprior's
    own means: ~0 for a worker the pool explains, growing as its posterior
    escapes the pool.  Its null distribution does not depend on K, so one
    online-calibrated gate serves any fleet size (``repro_torch.serve.gate``).
    Strictly per-worker: with ``sharding`` each rank scores its own rows and
    the scores are all-gathered.
    """
    if sharding is None or fleet.ng.mu0.ndim == 0:
        return _surprise_body(fleet, hyper)
    return shard_fleet_call(lambda fl: _surprise_body(fl, hyper), sharding, (fleet,))


# --------------------------------------------------------------------------
# cold-start admission
# --------------------------------------------------------------------------
def init_from_hyperprior(generator: torch.Generator, count: int, hyper: Hyperprior) -> GibbsState:
    """``count`` fresh per-worker states born from the fleet prior: their
    Normal-Gamma and exponent priors are the pooled hyperparameters, and
    their initial draws come from those distributions (from ``generator``)."""
    rows = lambda x: torch.broadcast_to(x, (count,)).clone()
    return init_state(
        generator,
        ng=NormalGammaParams(*(rows(x) for x in hyper.ng)),
        alpha_prior=BetaParams(*(rows(x) for x in hyper.alpha_prior)),
        beta_prior=BetaParams(*(rows(x) for x in hyper.beta_prior)),
    )
