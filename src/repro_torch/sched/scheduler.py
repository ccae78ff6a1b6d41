"""Online Bayesian scheduler: state in, state out.

PyTorch counterpart of ``repro.sched.scheduler`` (its single-device paths):

    init(config, num_workers, seed, device, capacity) -> state
    observe(state, telemetry, config)                 -> (state, ll)
    propose(state, config)                            -> (fractions, stats)
    anomaly(state, telemetry, config)                 -> (state, scores)

``SchedulerState`` is a NamedTuple of tensors plus the fleet's
``torch.Generator``; every transition returns a new state but draws from
that generator in place.  ``observe``, ``propose``, ``admit_workers`` and
``retire_workers`` never wait for the device: their loops have fixed counts
(Gibbs sweeps, bisection, Adam steps) and every pick is made by tensor
indexing, so they run under ``torch.cuda.set_sync_debug_mode("error")``.

Elastic membership comes two ways.  A capacity state (``init(capacity=)``)
carries a ``live`` mask over fixed slots: ``admit_workers`` and
``retire_workers`` flip slots on the device without changing a shape, and
``grow_capacity`` reallocates when the slots run out.  ``add_workers`` and
``remove_workers`` change the fleet's size.  ``Scheduler`` is the
imperative shell over all of it.

``solve_fractions`` (i) starts from the makespan-equalizing split solved by
bisection with the current alpha estimates, (ii) refines by Adam on logits,
and (iii) keeps whichever of {refined, equalizing, uniform} scores best, so
descent can only improve the proposal.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Tuple

import numpy as np
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
    live: Optional[Tensor] = None  # (K,) float {0, 1} capacity-slot mask;
    # None = every slot live.  Allocated by ``init(capacity=)`` and flipped
    # by ``admit_workers`` / ``retire_workers`` with no shape change.


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
    hierarchical: bool = False  # pool strength across the fleet (repro_torch.hier):
    # admissions are born from the empirical-Bayes fleet hyperprior, and the
    # serve loop's drift gate scores per-worker surprise against it
    hyper_strength: float = 8.0  # fleet-prior pseudo-observations (shrink)
    hyper_refit_every: int = 4  # drains between hyperprior refits (serve)


def init(
    config: SchedulerConfig,
    num_workers: int,
    seed: int = 0,
    device=None,
    capacity: Optional[int] = None,
) -> SchedulerState:
    """Fresh beliefs for a K-worker fleet.

    An entry point: runs on CUDA unless ``device`` says otherwise, and raises
    when no device is given and none is available.  ``seed`` seeds the
    fleet's generator.  ``capacity`` (>= ``num_workers``) allocates that many
    slots, the first ``num_workers`` live; None is the exact-size state with
    no live mask.
    """
    device = resolve_device(device)
    if capacity is None:
        slots, live = num_workers, None
    else:
        if capacity < num_workers:
            raise ValueError(f"{capacity=} < {num_workers=}")
        slots = capacity
        live = (torch.arange(capacity, device=device) < num_workers).to(torch.float32)
    generator = torch.Generator(device=device).manual_seed(int(seed))
    fleet = gibbs.init_state(generator, mu_guess=config.mu_guess, shape=(slots,))
    return SchedulerState(
        gibbs=fleet,
        ewma_ll=torch.zeros((slots,), dtype=torch.float32, device=device),
        ewma_count=torch.zeros((slots,), dtype=torch.int32, device=device),
        step=torch.zeros((), dtype=torch.int32, device=device),
        generator=generator,
        live=live,
    )


def advance_fleet(
    fleet: gibbs.GibbsState,
    times: Tensor,
    fracs: Tensor,
    config: SchedulerConfig,
    generator: torch.Generator,
    mask: Optional[Tensor] = None,
    active_idx: Optional[Tensor] = None,
) -> Tuple[gibbs.GibbsState, Tensor]:
    """The one fleet-advance path: discount -> fleet-native ``gibbs_batch``.

    ``active_idx`` routes the advance through the compressed active-set path
    (``core.compress``).  Power-prior forgetting of the exponent Beta priors
    pairs with the grid re-fit that re-tightens them, so surrogate workers
    skip both: their Beta fit neither widens nor re-learns until they enter
    the active set again.  The Normal-Gamma block discounts for every worker.
    """
    discounted = gibbs.discount_state(fleet, config.discount)
    if active_idx is not None and times.ndim >= 2:
        onehot = torch.zeros(times.shape[:1], dtype=torch.float32,
                             device=times.device).index_fill(0, active_idx, 1.0)
        freeze = lambda orig, disc: torch.where(onehot > 0, disc, orig)
        pick = lambda o, d: type(o)(freeze(o.a, d.a), freeze(o.b, d.b))
        discounted = discounted._replace(
            alpha_prior=pick(fleet.alpha_prior, discounted.alpha_prior),
            beta_prior=pick(fleet.beta_prior, discounted.beta_prior),
        )
    return gibbs.gibbs_batch(
        discounted, times, fracs, mask,
        generator=generator, n_iters=config.n_iters, grid_size=config.grid_size,
        active_idx=active_idx,
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
    elements exactly; on a capacity state dead slots are masked out too.
    Returns the per-worker log-likelihood.
    """
    if state.live is not None:
        lv = state.live[:, None]
        mask = lv if mask is None else torch.broadcast_to(mask, telemetry.times.shape) * lv
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


def _equalizing_fractions(params: UnitParams, live: Optional[Tensor] = None) -> Tensor:
    """Makespan-equalizing split: find tau with sum_k (tau/mu_k)^(1/alpha_k) = 1.

    50 bisection steps in log space (the sum is monotone in tau), each a
    tensor ``where``: no step waits for the device.  Rows (..., K) are
    solved independently.  ``live`` (a {0, 1} mask of the same shape) leaves
    dead slots out of the sum and gives them exactly 0.
    """
    mu = torch.clamp(params.mu, min=1e-6)
    alpha = torch.clamp(params.alpha, 0.05, 1.0)
    log_mu = torch.log(mu)
    lv = torch.ones_like(mu) if live is None else live.to(mu.dtype)
    row_sum = lambda x: torch.sum(x, dim=-1, keepdim=True)

    def frac_sum(log_tau):
        return row_sum(lv * torch.exp(torch.clamp((log_tau - log_mu) / alpha, -60.0, 0.0)))

    # At tau = max live mu: f_k >= 1 for the slowest live unit -> sum >= 1.
    hi = torch.amax(torch.where(lv > 0, log_mu, -torch.inf), dim=-1, keepdim=True)
    lo = hi - 60.0
    for _ in range(50):
        mid = 0.5 * (lo + hi)
        too_big = frac_sum(mid) > 1.0
        lo, hi = torch.where(too_big, lo, mid), torch.where(too_big, mid, hi)
    log_tau = 0.5 * (lo + hi)
    f = lv * torch.exp(torch.clamp((log_tau - log_mu) / alpha, -60.0, 0.0))
    return f / torch.clamp(row_sum(f), min=1e-30)


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
    live: Optional[Tensor] = None,
) -> Tuple[Tensor, ProposeStats]:
    """Objective-optimal fractions on the K-simplex (see module docstring).

    Proposals are floored at ``min_fraction`` per worker: quantization gives
    every worker at least one microbatch anyway, and telemetry at f -> 0
    carries unbounded weight f^(alpha-2beta) in the Normal-Gamma update.
    The Adam refinement takes ``torch.autograd.grad`` of the smooth
    objective.  ``live`` (a {0, 1} capacity-slot mask shaped as ``params``)
    restricts the solve to live workers: dead slots get exactly 0 (their
    logits are pinned at -1e9 and the floor skips them), and their parked
    posteriors are never consulted.

    ``params`` leaves may be rows (S, K): then S independent solves run as
    one, the way the reference vmaps one solve over a DAG's stages.  The
    rows' losses are summed before the gradient and Adam is elementwise, so
    each row takes exactly its own solve's steps; the best candidate is
    picked per row, and ``risk_aversion`` / ``var_budget`` / ``deadline``
    may be (S,) per-row overrides.  Returns (fractions, ProposeStats), the
    stats (S,) for rows.
    """
    overrides = dict(risk_aversion=risk_aversion, var_budget=var_budget, deadline=deadline)
    params = UnitParams(*(x.detach() for x in params))
    if live is not None:
        # Park dead slots on benign interior parameters, so their ignored
        # rows cannot put extreme magnitudes into the quadrature.
        lv = live > 0
        params = UnitParams(
            mu=torch.where(lv, params.mu, 1.0),
            sigma=torch.where(lv, params.sigma, 1e-3),
            alpha=torch.where(lv, params.alpha, 0.5),
            beta=torch.where(lv, params.beta, 0.5),
        )
    pin = (lambda x: x) if live is None else (lambda x: torch.where(live > 0, x, -1e9))
    f_eq = _equalizing_fractions(params, live)
    k = f_eq.shape[-1]
    if live is None:
        f_uni = torch.full(f_eq.shape, 1.0 / k, dtype=f_eq.dtype, device=f_eq.device)
    else:
        f_uni = live.to(f_eq.dtype) / torch.clamp(torch.sum(live, dim=-1, keepdim=True), min=1.0)

    logits = torch.log(torch.clamp(f_eq, min=1e-9))
    m = torch.zeros_like(logits)
    v = torch.zeros_like(logits)
    with torch.enable_grad():
        for step in range(1, steps + 1):
            x = logits.detach().requires_grad_(True)
            loss = evaluate(
                objective, torch.softmax(pin(x), dim=-1), params,
                num_points=num_points, smooth=True, **overrides,
            )
            if loss.ndim:  # rows: independent solves, one gradient
                loss = torch.sum(loss)
            (g,) = torch.autograd.grad(loss, x)
            m = 0.9 * m + 0.1 * g
            v = 0.999 * v + 0.001 * g * g
            mh = m / (1.0 - 0.9**step)
            vh = v / (1.0 - 0.999**step)
            logits = logits - lr * mh / (torch.sqrt(vh) + 1e-8)
    f_ref = torch.softmax(pin(logits), dim=-1)

    # Safeguard: descent may only improve on the analytic candidates.
    cands = torch.clamp(torch.stack([f_ref, f_eq, f_uni]), min=min_fraction)  # (3, ..., K)
    if live is not None:
        cands = torch.where(live > 0, cands, 0.0)
    cands = cands / torch.sum(cands, dim=-1, keepdim=True)
    scores = torch.stack(
        [evaluate(objective, c, params, num_points=num_points, **overrides) for c in cands]
    )  # (3, ...)
    pick = torch.argmin(scores, dim=0)[None, ..., None].expand(1, *cands.shape[1:])
    best = torch.gather(cands, 0, pick)[0]

    e_t, var = mean_var_completion(best, params, num_points)
    return best, ProposeStats(e_t=e_t, var=var, score=torch.amin(scores, dim=0))


def propose(
    state: SchedulerState, config: SchedulerConfig = SchedulerConfig()
) -> Tuple[Tensor, ProposeStats]:
    """Objective-optimal fractions under the current beliefs; on a capacity
    state dead slots get exactly 0."""
    return solve_fractions(
        unit_params(state),
        objective=config.objective,
        steps=config.opt_steps,
        lr=config.opt_lr,
        num_points=config.num_points,
        min_fraction=config.min_fraction,
        live=state.live,
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
    telemetry out of every EWMA and freshness counter; so does a dead
    capacity slot.
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
    if state.live is not None:
        v = v * (state.live if v.ndim == 1 else state.live[:, None])
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


# --------------------------------------------------------------------------
# elastic membership
# --------------------------------------------------------------------------
def num_workers(state: SchedulerState) -> int:
    """Live fleet size: the slot count, or the live mask's sum on a capacity
    state (one scalar read from the device)."""
    if state.live is None:
        return int(state.ewma_ll.shape[0])
    return int(torch.sum(state.live))


def capacity(state: SchedulerState) -> int:
    """Allocated worker slots (== num_workers when there is no live mask)."""
    return int(state.ewma_ll.shape[0])


def _fresh_workers(state: SchedulerState, count: int, config: SchedulerConfig,
                   generator: torch.Generator, hyper=None, mu_guess=None) -> gibbs.GibbsState:
    """``count`` newly born per-worker states: from the fleet hyperprior
    (pooled from the incumbents unless ``hyper`` is given) when
    ``config.hierarchical``, else from the global prior."""
    if config.hierarchical:
        from repro_torch import hier

        if hyper is None:
            hyper = hier.fit_hyperprior(state.gibbs, state.live)
        return hier.init_from_hyperprior(generator, count, hyper)
    guess = config.mu_guess if mu_guess is None else mu_guess
    return gibbs.init_state(generator, mu_guess=guess, shape=(count,))


def admit_workers(
    state: SchedulerState, count: int, config: SchedulerConfig = SchedulerConfig()
) -> SchedulerState:
    """Admit ``count`` workers into dead capacity slots, on the device.

    The dead slots are the first ``count`` of a stable ascending sort of the
    live mask (lowest index first), re-initialized from fresh priors (or the
    fleet hyperprior when ``config.hierarchical``) by scatter and flipped
    live; no shape changes and nothing waits for the device.  Slots beyond
    the dead count are left untouched, so over-admitting clobbers nothing.
    Draws come from the state's generator.
    """
    if state.live is None:
        raise ValueError("admit_workers needs a capacity state (init(..., capacity=)); "
                         "use add_workers for exact-size fleets")
    count = min(count, capacity(state))
    idx = torch.argsort(state.live, stable=True)[:count]  # dead (0.0) slots first
    ok = state.live.index_select(0, idx) == 0.0  # never clobber a live slot
    fresh = _fresh_workers(state, count, config, state.generator)

    def put(full, new):
        keep = ok.reshape(ok.shape + (1,) * (new.ndim - 1))
        return full.index_copy(0, idx, torch.where(keep, new, full.index_select(0, idx)))

    zeros = lambda like: torch.zeros((count,), dtype=like.dtype, device=like.device)
    return state._replace(
        gibbs=gibbs.tree_map2(put, state.gibbs, fresh),
        ewma_ll=put(state.ewma_ll, zeros(state.ewma_ll)),
        ewma_count=put(state.ewma_count, zeros(state.ewma_count)),
        live=put(state.live, torch.ones_like(zeros(state.live))),
    )


def retire_workers(state: SchedulerState, dead) -> SchedulerState:
    """Mark workers dead in place of their slots, on the device.

    ``dead`` is a (capacity,) boolean or {0, 1} mask; pass it on the state's
    device to keep the call free of host copies.  The slots' posteriors are
    parked (the live mask hides them from observe, propose and anomaly), and
    their EWMA leaves are zeroed, so a later admission into the slot seeds
    anomaly freshness anew.
    """
    if state.live is None:
        raise ValueError("retire_workers needs a capacity state (init(..., capacity=)); "
                         "use remove_workers for exact-size fleets")
    gone = torch.as_tensor(dead, device=state.live.device).to(state.live.dtype) > 0
    return state._replace(
        live=torch.where(gone, 0.0, state.live),
        ewma_ll=torch.where(gone, 0.0, state.ewma_ll),
        ewma_count=torch.where(gone, 0, state.ewma_count),
    )


def _cat(a: Tensor, b: Tensor) -> Tensor:
    return torch.cat([a, b.to(a.dtype)], dim=0)


def grow_capacity(
    state: SchedulerState, new_capacity: int, config: SchedulerConfig = SchedulerConfig()
) -> SchedulerState:
    """Reallocate a capacity state with more slots: the shape-changing
    fallback for when admissions run out of slots.  New slots are dead, with
    prior-initialized posteriors drawn from the state's generator."""
    if state.live is None:
        raise ValueError("grow_capacity needs a capacity state")
    cap = capacity(state)
    if new_capacity <= cap:
        return state
    extra = new_capacity - cap
    fresh = gibbs.init_state(state.generator, mu_guess=config.mu_guess, shape=(extra,))
    zeros = lambda like: torch.zeros((extra,), dtype=like.dtype, device=like.device)
    return state._replace(
        gibbs=gibbs.tree_map2(_cat, state.gibbs, fresh),
        ewma_ll=_cat(state.ewma_ll, zeros(state.ewma_ll)),
        ewma_count=_cat(state.ewma_count, zeros(state.ewma_count)),
        live=_cat(state.live, zeros(state.live)),
    )


def remove_workers(state: SchedulerState, dead) -> SchedulerState:
    """Drop failed workers from the fleet (elastic down-scale; changes K).
    ``dead`` is a host (K,) boolean mask."""
    keep = torch.as_tensor(np.flatnonzero(~np.asarray(dead, bool)),
                           device=state.ewma_ll.device)
    take = lambda x: x.index_select(0, keep)
    return state._replace(
        gibbs=gibbs.tree_map(take, state.gibbs),
        ewma_ll=take(state.ewma_ll),
        ewma_count=take(state.ewma_count),
        live=None if state.live is None else take(state.live),
    )


def add_workers(
    state: SchedulerState,
    count: int,
    config: SchedulerConfig = SchedulerConfig(),
    *,
    seed: Optional[int] = None,
    mu_guess: Optional[float] = None,
    hyper=None,
) -> SchedulerState:
    """Admit new workers with fresh priors (elastic up-scale; changes K).

    Draws come from the state's generator, or from a fresh one seeded with
    ``seed``; ``mu_guess`` overrides the config's prior center.  With
    ``config.hierarchical`` the newcomers are born from the fleet hyperprior
    (``repro_torch.hier``), pooled from the incumbents unless ``hyper`` is
    given: the cold-start transfer path.
    """
    device = state.ewma_ll.device
    generator = (state.generator if seed is None
                 else torch.Generator(device=device).manual_seed(int(seed)))
    if config.hierarchical and hyper is None:
        from repro_torch import hier

        hyper = hier.fit_hyperprior(state.gibbs)
    fresh = _fresh_workers(state, count, config, generator, hyper=hyper, mu_guess=mu_guess)
    zeros = lambda like: torch.zeros((count,), dtype=like.dtype, device=like.device)
    return state._replace(
        gibbs=gibbs.tree_map2(_cat, state.gibbs, fresh),
        # Fresh admits carry ewma_count = 0: their first anomaly score seeds
        # their EWMA directly.
        ewma_ll=_cat(state.ewma_ll, zeros(state.ewma_ll)),
        ewma_count=_cat(state.ewma_count, zeros(state.ewma_count)),
        live=None if state.live is None else _cat(state.live, torch.ones_like(zeros(state.live))),
    )


# --------------------------------------------------------------------------
# imperative shell
# --------------------------------------------------------------------------
class Scheduler:
    """Thin imperative shell: config + current ``SchedulerState``.

    All logic lives in the functions above; this class threads the state for
    callers structured as loops (trainer, server, monitor).  Host inputs
    (numpy telemetry and masks) are moved to the state's device here.  An
    entry point: runs on CUDA unless ``device`` says otherwise.
    """

    def __init__(
        self,
        num_workers: int,
        *,
        config: Optional[SchedulerConfig] = None,
        seed: int = 0,
        capacity: Optional[int] = None,
        device=None,
        **overrides,
    ):
        config = config or SchedulerConfig()
        if overrides:
            config = dataclasses.replace(config, **overrides)
        self.config = config
        self.state = init(config, num_workers, seed, device, capacity)

    @property
    def device(self) -> torch.device:
        return self.state.ewma_ll.device

    def _tensor(self, x, dtype=torch.float32) -> Tensor:
        return torch.as_tensor(np.asarray(x) if not isinstance(x, Tensor) else x,
                               dtype=dtype, device=self.device)

    @property
    def num_workers(self) -> int:
        return num_workers(self.state)

    @property
    def objective(self) -> Objective:
        return self.config.objective

    @objective.setter
    def objective(self, obj: Objective) -> None:
        self.config = dataclasses.replace(self.config, objective=obj)

    # -- estimation --------------------------------------------------------
    def observe(self, telemetry: Telemetry, mask=None) -> Tensor:
        telemetry = Telemetry(self._tensor(telemetry.fracs), self._tensor(telemetry.times))
        self.state, ll = observe(self.state, telemetry, self.config,
                                 None if mask is None else self._tensor(mask))
        return ll

    def unit_params(self) -> UnitParams:
        return unit_params(self.state)

    # -- partitioning ------------------------------------------------------
    def propose_fractions(self) -> Tuple[np.ndarray, float, float]:
        fracs, stats = propose(self.state, self.config)
        return fracs.cpu().numpy(), float(stats.e_t), float(stats.var)

    def propose_microbatches(self, total_microbatches: int, min_per_worker: int = 1) -> np.ndarray:
        from .quantize import quantize_fractions

        fracs, _ = propose(self.state, self.config)
        return quantize_fractions(
            fracs.cpu().numpy(),
            total_microbatches,
            self.unit_params(),
            objective=self.config.objective,
            min_per_worker=min_per_worker,
            live=None if self.state.live is None else self.state.live.cpu().numpy() > 0,
        )

    # -- anomaly / straggler detection -------------------------------------
    def anomaly_scores(self, fracs, times, valid=None) -> np.ndarray:
        self.state, scores = anomaly(
            self.state, Telemetry(self._tensor(fracs), self._tensor(times)), self.config,
            None if valid is None else self._tensor(valid),
        )
        return scores.cpu().numpy().astype(np.float64)

    def flag_stragglers(self, threshold_sigma: float = 3.0, valid=None) -> np.ndarray:
        if valid is None and self.state.live is not None:
            valid = self.state.live > 0  # dead slots never skew or get flagged
        return flag_stragglers(
            self.state.ewma_ll, threshold_sigma,
            None if valid is None else self._tensor(valid, torch.bool),
        ).cpu().numpy()

    # -- hierarchical pooling (repro_torch.hier) ---------------------------
    def fit_hyperprior(self):
        """Pool the current per-worker posteriors into a fleet hyperprior."""
        from repro_torch import hier

        return hier.fit_hyperprior(self.state.gibbs)

    def shrink(self, hyper=None) -> None:
        """Blend cold workers toward the fleet prior (ESS-weighted)."""
        from repro_torch import hier

        hyper = hyper if hyper is not None else self.fit_hyperprior()
        self.state = self.state._replace(
            gibbs=hier.shrink(self.state.gibbs, hyper, strength=self.config.hyper_strength)
        )

    def surprise(self, hyper=None) -> np.ndarray:
        """Per-worker drift scores against the pooled prior."""
        from repro_torch import hier

        hyper = hyper if hyper is not None else self.fit_hyperprior()
        return hier.surprise(self.state.gibbs, hyper).cpu().numpy()

    # -- elastic membership ------------------------------------------------
    @property
    def capacity(self) -> int:
        return capacity(self.state)

    def admit_workers(self, count: int) -> None:
        """Slot-based admission; doubles capacity (shape-changing) only when
        the free slots do not suffice."""
        cap = capacity(self.state)
        free = cap - num_workers(self.state)
        if count > free:
            self.state = grow_capacity(self.state, max(2 * cap, cap + count - free), self.config)
        self.state = admit_workers(self.state, count, self.config)

    def retire_workers(self, dead) -> None:
        """Slot-based removal: parks the slots, leaf shapes unchanged."""
        self.state = retire_workers(self.state, self._tensor(dead, torch.bool))

    def remove_workers(self, dead) -> None:
        self.state = remove_workers(self.state, dead)

    def add_workers(self, count: int, seed: Optional[int] = None,
                    mu_guess: Optional[float] = None) -> None:
        self.state = add_workers(self.state, count, self.config, seed=seed, mu_guess=mu_guess)
