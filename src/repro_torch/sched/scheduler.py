"""Online Bayesian scheduler: state in, state out.

PyTorch counterpart of ``repro.sched.scheduler`` for a fleet of fixed size:

    init(config, num_workers, seed, device)   -> state
    observe(state, telemetry, config)         -> (state, ll)
    propose(state, config)                    -> (fractions, stats)
    anomaly(state, telemetry, config)         -> (state, scores)

``SchedulerState`` is a NamedTuple of tensors plus the fleet's
``torch.Generator``; ``observe`` returns a new state but draws from that
generator in place.  ``observe`` and ``propose`` never wait for the device:
their loops have fixed counts (Gibbs sweeps, bisection, Adam steps) and every
pick is made by tensor indexing, so a cycle runs under
``torch.cuda.set_sync_debug_mode("error")``.

``solve_fractions`` (i) starts from the makespan-equalizing split solved by
bisection with the current alpha estimates, (ii) refines by Adam on logits,
and (iii) keeps whichever of {refined, equalizing, uniform} scores best, so
descent can only improve the proposal.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch
from torch import Tensor

from repro_torch.core import gibbs
from repro_torch.core.frontier import UnitParams, mean_var_completion
from repro_torch.core.posterior import posterior_predictive_logpdf
from repro_torch.device import resolve_device

from .objectives import Objective, evaluate


class Telemetry(NamedTuple):
    """One batch of per-worker observations: fractions worked, times taken."""

    fracs: Tensor  # (K, N) workload fraction each worker processed
    times: Tensor  # (K, N) measured completion times


class SchedulerState(NamedTuple):
    """Everything the scheduler has learned."""

    gibbs: gibbs.GibbsState  # per-worker posteriors, leaves (K,)
    ewma_ll: Tensor  # (K,) EWMA of negative predictive log-likelihood
    ewma_count: Tensor  # (K,) anomaly updates folded into each worker's EWMA
    step: Tensor  # scalar, observe() calls so far
    generator: torch.Generator  # the fleet's random source, on its device


class ProposeStats(NamedTuple):
    """Frontier statistics of a proposed split."""

    e_t: Tensor  # expected makespan at the proposal
    var: Tensor  # completion-time variance at the proposal
    score: Tensor  # objective score (lower is better)


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    """Static hyperparameters."""

    objective: Objective = Objective()
    n_iters: int = 20  # Gibbs sweeps per telemetry batch
    grid_size: int = 256  # exponent-posterior grid resolution
    discount: float = 0.9  # power-prior forgetting factor
    mu_guess: float = 1.0  # prior center for per-unit mean time
    ewma: float = 0.8  # anomaly-score smoothing
    opt_steps: int = 200  # Adam steps of the simplex refinement
    opt_lr: float = 0.05
    num_points: int = 512  # quadrature points for objective evaluation
    min_fraction: float = 5e-3  # proposal floor per worker (see solve_fractions)


def init(
    config: SchedulerConfig,
    num_workers: int,
    seed: int = 0,
    device=None,
) -> SchedulerState:
    """Fresh beliefs for a K-worker fleet.

    An entry point: runs on CUDA unless ``device`` says otherwise, and raises
    when no device is given and none is available.  ``seed`` seeds the
    fleet's generator.
    """
    device = resolve_device(device)
    generator = torch.Generator(device=device).manual_seed(int(seed))
    fleet = gibbs.init_state(generator, mu_guess=config.mu_guess, shape=(num_workers,))
    return SchedulerState(
        gibbs=fleet,
        ewma_ll=torch.zeros((num_workers,), dtype=torch.float32, device=device),
        ewma_count=torch.zeros((num_workers,), dtype=torch.int32, device=device),
        step=torch.zeros((), dtype=torch.int32, device=device),
        generator=generator,
    )


def advance_fleet(
    fleet: gibbs.GibbsState,
    times: Tensor,
    fracs: Tensor,
    config: SchedulerConfig,
    generator: torch.Generator,
    mask: Optional[Tensor] = None,
) -> Tuple[gibbs.GibbsState, Tensor]:
    """The one fleet-advance path: discount -> fleet-native ``gibbs_batch``."""
    discounted = gibbs.discount_state(fleet, config.discount)
    return gibbs.gibbs_batch(
        discounted, times, fracs, mask,
        generator=generator, n_iters=config.n_iters, grid_size=config.grid_size,
    )


def observe(
    state: SchedulerState,
    telemetry: Telemetry,
    config: SchedulerConfig = SchedulerConfig(),
    mask: Optional[Tensor] = None,
) -> Tuple[SchedulerState, Tensor]:
    """Gibbs-update every worker's posterior from one telemetry batch.

    Power-prior forgetting is applied before the batch; the whole fleet
    advances through one ``gibbs_batch``, so each sweep's grid posterior is
    ONE K1 launch.  ``mask`` (same shape as ``telemetry.times``) invalidates
    elements exactly.  Returns the per-worker log-likelihood.
    """
    fleet, ll = advance_fleet(
        state.gibbs, telemetry.times, telemetry.fracs, config, state.generator, mask=mask
    )
    return state._replace(gibbs=fleet, step=state.step + 1), ll


def unit_params_from_gibbs(st: gibbs.GibbsState, *, use_samples: bool = False) -> UnitParams:
    """Point estimates from a (possibly batched) ``GibbsState``: the chained
    posterior means by default, the last Gibbs samples with ``use_samples``."""
    if use_samples:
        return UnitParams(mu=st.mu, sigma=st.sigma, alpha=st.alpha, beta=st.beta)
    ng = st.ng
    lam_mean = ng.nu0 / torch.clamp(ng.psi0, min=1e-30)
    return UnitParams(
        mu=ng.mu0,
        sigma=1.0 / torch.sqrt(torch.clamp(lam_mean, min=1e-30)),
        alpha=st.alpha_prior.a / (st.alpha_prior.a + st.alpha_prior.b),
        beta=st.beta_prior.a / (st.beta_prior.a + st.beta_prior.b),
    )


def unit_params(state: SchedulerState, *, use_samples: bool = False) -> UnitParams:
    """Current point estimates as frontier parameters (posterior means: one
    vague-prior sample can swing a worker's apparent speed by orders of
    magnitude, so samples are no partitioning input)."""
    return unit_params_from_gibbs(state.gibbs, use_samples=use_samples)


def _equalizing_fractions(params: UnitParams) -> Tensor:
    """Makespan-equalizing split: find tau with sum_k (tau/mu_k)^(1/alpha_k) = 1.

    50 bisection steps in log space (the sum is monotone in tau), each a
    tensor ``where``: no step waits for the device.
    """
    mu = torch.clamp(params.mu, min=1e-6)
    alpha = torch.clamp(params.alpha, 0.05, 1.0)
    log_mu = torch.log(mu)

    def frac_sum(log_tau):
        return torch.sum(torch.exp(torch.clamp((log_tau - log_mu) / alpha, -60.0, 0.0)))

    # At tau = max mu: f_k >= 1 for the slowest unit -> sum >= 1.
    hi = torch.amax(log_mu)
    lo = hi - 60.0
    for _ in range(50):
        mid = 0.5 * (lo + hi)
        too_big = frac_sum(mid) > 1.0
        lo, hi = torch.where(too_big, lo, mid), torch.where(too_big, mid, hi)
    log_tau = 0.5 * (lo + hi)
    f = torch.exp(torch.clamp((log_tau - log_mu) / alpha, -60.0, 0.0))
    return f / torch.clamp(torch.sum(f), min=1e-30)


def solve_fractions(
    params: UnitParams,
    *,
    objective: Objective = Objective(),
    steps: int = 200,
    lr: float = 0.05,
    num_points: int = 512,
    min_fraction: float = 5e-3,
    risk_aversion=None,
    var_budget=None,
    deadline=None,
) -> Tuple[Tensor, ProposeStats]:
    """Objective-optimal fractions on the K-simplex (see module docstring).

    Proposals are floored at ``min_fraction`` per worker: quantization gives
    every worker at least one microbatch anyway, and telemetry at f -> 0
    carries unbounded weight f^(alpha-2beta) in the Normal-Gamma update.
    The Adam refinement takes ``torch.autograd.grad`` of the smooth
    objective.  Returns (fractions, ProposeStats).
    """
    overrides = dict(risk_aversion=risk_aversion, var_budget=var_budget, deadline=deadline)
    params = UnitParams(*(x.detach() for x in params))
    f_eq = _equalizing_fractions(params)
    k = f_eq.shape[0]
    f_uni = torch.full((k,), 1.0 / k, dtype=f_eq.dtype, device=f_eq.device)

    logits = torch.log(torch.clamp(f_eq, min=1e-9))
    m = torch.zeros_like(logits)
    v = torch.zeros_like(logits)
    with torch.enable_grad():
        for step in range(1, steps + 1):
            x = logits.detach().requires_grad_(True)
            loss = evaluate(
                objective, torch.softmax(x, dim=-1), params,
                num_points=num_points, smooth=True, **overrides,
            )
            (g,) = torch.autograd.grad(loss, x)
            m = 0.9 * m + 0.1 * g
            v = 0.999 * v + 0.001 * g * g
            mh = m / (1.0 - 0.9**step)
            vh = v / (1.0 - 0.999**step)
            logits = logits - lr * mh / (torch.sqrt(vh) + 1e-8)
    f_ref = torch.softmax(logits, dim=-1)

    # Safeguard: descent may only improve on the analytic candidates.
    cands = torch.clamp(torch.stack([f_ref, f_eq, f_uni]), min=min_fraction)  # (3, K)
    cands = cands / torch.sum(cands, dim=-1, keepdim=True)
    scores = torch.stack(
        [evaluate(objective, c, params, num_points=num_points, **overrides) for c in cands]
    )
    best = torch.index_select(cands, 0, torch.argmin(scores).reshape(1))[0]

    e_t, var = mean_var_completion(best, params, num_points)
    return best, ProposeStats(e_t=e_t, var=var, score=torch.amin(scores))


def propose(
    state: SchedulerState, config: SchedulerConfig = SchedulerConfig()
) -> Tuple[Tensor, ProposeStats]:
    """Objective-optimal fractions under the current beliefs."""
    return solve_fractions(
        unit_params(state),
        objective=config.objective,
        steps=config.opt_steps,
        lr=config.opt_lr,
        num_points=config.num_points,
        min_fraction=config.min_fraction,
    )


def anomaly(
    state: SchedulerState,
    telemetry: Telemetry,
    config: SchedulerConfig = SchedulerConfig(),
    valid: Optional[Tensor] = None,
) -> Tuple[SchedulerState, Tensor]:
    """EWMA'd negative posterior-predictive log-likelihood per worker.

    High score == recent behaviour inconsistent with the learned model.
    Accepts (K,) single observations or (K, N) batches (averaged over N).
    Freshness is tracked per worker, so a worker's EWMA starts at its own
    first score.  ``valid`` (per worker (K,) or per element) masks invalid
    telemetry out of every EWMA and freshness counter.
    """
    p = unit_params(state)
    lam_mean = 1.0 / torch.clamp(p.sigma * p.sigma, min=1e-30)
    t = torch.as_tensor(telemetry.times, dtype=torch.float32, device=p.mu.device)
    f = torch.as_tensor(telemetry.fracs, dtype=torch.float32, device=p.mu.device)
    if valid is None:
        v = torch.ones(t.shape, dtype=torch.float32, device=t.device)
    else:
        v = torch.as_tensor(valid, device=t.device).to(torch.float32)
        if v.ndim < t.ndim:  # per-worker (K,) mask over a (K, N) batch
            v = v[..., None]
        v = torch.broadcast_to(v, t.shape)
    # Invalid slots get interior dummy values so inf/nan never reaches the
    # logpdf (0 * inf = nan would leak through the mask otherwise).
    t = torch.where(v > 0, t, 1.0)
    f = torch.where(v > 0, f, 0.5)
    per_k = lambda x: x.reshape(x.shape + (1,) * (t.ndim - 1))
    ll = posterior_predictive_logpdf(
        t, f, per_k(p.mu), per_k(lam_mean), per_k(p.alpha), per_k(p.beta)
    )
    if ll.ndim > 1:
        n_valid = torch.sum(v, dim=-1)
        ll = torch.sum(ll * v, dim=-1) / torch.clamp(n_valid, min=1.0)
        worker_valid = n_valid > 0
    else:
        worker_valid = v > 0
    score = -ll
    fresh = state.ewma_count == 0
    blended = torch.where(
        fresh, score, config.ewma * state.ewma_ll + (1.0 - config.ewma) * score
    )
    new_ewma = torch.where(worker_valid, blended, state.ewma_ll)
    state = state._replace(
        ewma_ll=new_ewma,
        ewma_count=state.ewma_count + worker_valid.to(state.ewma_count.dtype),
    )
    return state, new_ewma


def flag_stragglers(
    scores: Tensor, threshold_sigma: float = 3.0, valid: Optional[Tensor] = None
) -> Tensor:
    """Workers whose anomaly score is a robust outlier vs the fleet.

    Medians average the two middle values of an even count, as
    ``jnp.median`` does (``torch.median`` would take the lower one).
    ``valid`` excludes workers from the median/MAD baseline, and excluded
    workers are never flagged.
    """
    scores = torch.as_tensor(scores, dtype=torch.float32)
    if valid is None:
        med = torch.quantile(scores, 0.5)
        mad = torch.quantile(torch.abs(scores - med), 0.5) + 1e-9
        return scores > med + threshold_sigma * 1.4826 * mad
    v = torch.as_tensor(valid, device=scores.device).to(torch.bool)
    nan = torch.full_like(scores, float("nan"))
    med = torch.nanquantile(torch.where(v, scores, nan), 0.5)
    mad = torch.nanquantile(torch.where(v, torch.abs(scores - med), nan), 0.5) + 1e-9
    return v & (scores > med + threshold_sigma * 1.4826 * mad)
