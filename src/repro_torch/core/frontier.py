"""Completion-time statistics of a partitioned workflow and the QoS frontier.

PyTorch counterpart of the two-way and completion-moment part of
``repro.core.frontier`` (Section 1 of the paper, generalized to K units):

  P(t <= eps | f, Theta) = prod_k P(t_k <= eps | f_k, Theta_k)
  E(t)   = int_0^inf [1 - P(t <= eps)] d eps
  Var(t) = 2 int_0^inf eps [1 - P(t <= eps)] d eps - E(t)^2

with per-unit times t_k ~ N(f_k^alpha_k mu_k, (f_k^beta_k sigma_k)^2).

The product of K Normal CDFs is formed as exp(sum log Phi): equal to the
product, finite in its gradient where a CDF underflows to 0, and free of the
zero test (a host sync) that the backward of ``torch.prod`` makes.
Fractions may carry leading batch axes (..., K); each row is integrated on
its own quadrature grid, as the reference's vmap over rows does.

The stochastic stage transforms (conditional branches, rework loops) and the
stage compositions of a workflow DAG (serial sums, the PERT max over
parallel branches, topological reduction) follow; the max over branches
forms its product of CDFs the same way.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import Tensor

from repro_torch.device import host_constant

from .distributions import normal_log_cdf

DEFAULT_QUAD_POINTS = 1024


class UnitParams(NamedTuple):
    """Per-unit completion-time model parameters; leaves have shape (K,)."""

    mu: Tensor
    sigma: Tensor
    alpha: Tensor
    beta: Tensor

    @staticmethod
    def of(mu, sigma, alpha=None, beta=None) -> "UnitParams":
        as_f32 = lambda x: torch.as_tensor(x, dtype=torch.float32)
        mu = as_f32(mu)
        one = torch.ones_like(mu)
        return UnitParams(
            mu,
            as_f32(sigma),
            one if alpha is None else as_f32(alpha),
            one if beta is None else as_f32(beta),
        )


def component_mean_std(fracs: Tensor, params: UnitParams) -> Tuple[Tensor, Tensor]:
    """Per-unit mean f^alpha mu and std f^beta sigma for fractions (..., K)."""
    f = torch.clamp(fracs, min=1e-9)
    mean = f**params.alpha * params.mu
    std = f**params.beta * params.sigma
    return mean, torch.clamp(std, min=1e-9)


def _log_cdf_sum(eps: Tensor, mean: Tensor, std: Tensor) -> Tensor:
    return torch.sum(normal_log_cdf(eps, mean, std), dim=-1)


def completion_cdf(eps: Tensor, fracs: Tensor, params: UnitParams) -> Tensor:
    """P(t <= eps | f, Theta): product of per-unit Normal CDFs.

    eps (..., Q) with fracs (K,) gives (..., Q); a scalar eps with fracs
    (..., K) gives (...).
    """
    mean, std = component_mean_std(fracs, params)
    if not isinstance(eps, Tensor):  # a fill, not a host-to-device copy
        eps = torch.full((), float(eps), dtype=mean.dtype, device=mean.device)
    return torch.exp(_log_cdf_sum(eps[..., None], mean, std))


def _quad_grid(means: Tensor, stds: Tensor, num_points: int) -> Tensor:
    """Quadrature abscissae on [0, max_k(mean + 8 std)] per row of (..., K)."""
    upper = torch.clamp(torch.amax(means + 8.0 * stds, dim=-1), min=1e-6)
    unit = torch.linspace(0.0, 1.0, num_points, dtype=means.dtype, device=means.device)
    return unit * upper[..., None]


def _moments_from_survival(eps: Tensor, surv: Tensor) -> Tuple[Tensor, Tensor]:
    """(E, Var) of a nonnegative variable from its survival function values."""
    e_t = torch.trapezoid(surv, eps, dim=-1)
    e_t2 = 2.0 * torch.trapezoid(eps * surv, eps, dim=-1)
    return e_t, torch.clamp(e_t2 - e_t * e_t, min=0.0)


def mean_var_completion(
    fracs: Tensor,
    params: UnitParams,
    num_points: int = DEFAULT_QUAD_POINTS,
) -> Tuple[Tensor, Tensor]:
    """E(t) and Var(t) of the max-completion time by trapezoid quadrature.

    fracs (..., K) -> (...), (...).  Differentiable in ``fracs``.
    """
    mean, std = component_mean_std(fracs, params)
    eps = _quad_grid(mean, std, num_points)  # (..., Q)
    log_cdf = _log_cdf_sum(eps[..., :, None], mean[..., None, :], std[..., None, :])
    surv = 1.0 - torch.exp(log_cdf)
    return _moments_from_survival(eps, surv)


# --------------------------------------------------------------------------
# stochastic stage transforms (conditional branches + rework loops)
# --------------------------------------------------------------------------
def mixture_moments(p: Tensor, mean: Tensor, var: Tensor) -> Tuple[Tensor, Tensor]:
    """Moments of ``Z = B * X`` with ``B ~ Bernoulli(p)`` independent of X:

      E[Z]   = p E[X]
      Var[Z] = p Var[X] + p (1 - p) E[X]^2

    Elementwise and exact; ``p = 1`` is an identity bit for bit.

    >>> e, v = mixture_moments(torch.tensor(0.25), torch.tensor(8.0), torch.tensor(4.0))
    >>> float(e), float(v)
    (2.0, 13.0)
    """
    return p * mean, p * var + p * (1.0 - p) * (mean * mean)


def truncated_geometric_moments(
    success_prob: Tensor,
    max_attempts,
    *,
    max_support: Optional[int] = None,
) -> Tuple[Tensor, Tensor]:
    """(E[N], Var[N]) of ``N = min(Geometric(q), R)`` attempt counts.

    The pmf is ``(1-q)^(n-1) q`` for ``n < R`` and the surviving tail
    ``(1-q)^(R-1)`` on ``n = R``, summed over the static support
    ``1..max_support`` (``max(max_attempts)`` when that is an int or a
    tuple; required when ``max_attempts`` is a tensor).  ``q = 1`` or
    ``R = 1`` gives E[N] = 1 and Var[N] = 0 exactly.

    >>> e_n, v_n = truncated_geometric_moments(torch.tensor(0.5), 30)
    >>> round(float(e_n), 4), round(float(v_n), 4)
    (2.0, 2.0)
    >>> truncated_geometric_moments(torch.tensor(0.5), 1)
    (tensor(1.), tensor(0.))
    """
    q = torch.as_tensor(success_prob, dtype=torch.float32)
    if max_support is None:
        if isinstance(max_attempts, int):
            max_support = max_attempts
        elif isinstance(max_attempts, (tuple, list)):
            max_support = int(max(max_attempts))
        else:
            raise ValueError("max_support is required when max_attempts is a tensor")
    if isinstance(max_attempts, Tensor):
        caps = max_attempts.to(torch.float32)[..., None]
    else:
        caps = host_constant(max_attempts, q.device)[..., None]
    n = torch.arange(1, max_support + 1, dtype=torch.float32, device=q.device)
    fail = 1.0 - q[..., None]
    geometric = fail ** (n - 1.0) * q[..., None]
    tail = fail ** (caps - 1.0)  # all surviving mass collapses onto n == cap
    pmf = torch.where(n < caps, geometric, torch.where(n == caps, tail, 0.0))
    e_n = torch.sum(n * pmf, dim=-1)
    e_n2 = torch.sum(n * n * pmf, dim=-1)
    return e_n, torch.clamp(e_n2 - e_n * e_n, min=0.0)


def compound_sum_moments(
    n_mean: Tensor, n_var: Tensor, mean: Tensor, var: Tensor
) -> Tuple[Tensor, Tensor]:
    """Moments of ``T = sum_{i=1}^N X_i`` (i.i.d. X independent of N), the
    Wald identities E[T] = E[N] E[X], Var[T] = E[N] Var[X] + Var[N] E[X]^2.

    >>> e, v = compound_sum_moments(torch.tensor(2.0), torch.tensor(2.0),
    ...                             torch.tensor(3.0), torch.tensor(0.5))
    >>> float(e), float(v)
    (6.0, 19.0)
    """
    return n_mean * mean, n_mean * var + n_var * (mean * mean)


def stochastic_stage_moments(
    stage_means: Tensor,
    stage_vars: Tensor,
    *,
    exec_probs: Optional[Tensor] = None,
    success_probs: Optional[Tensor] = None,
    max_retries=None,
    max_support: Optional[int] = None,
) -> Tuple[Tensor, Tensor]:
    """Per-attempt stage moments -> what the stage contributes: geometric
    rework first (``success_probs`` per attempt, capped at ``max_retries``),
    Bernoulli path activation second (a skipped stage skips all its retries).
    Both transforms are exact in the moments.

    >>> e, v = stochastic_stage_moments(
    ...     torch.tensor([3.0, 5.0]), torch.tensor([0.5, 1.0]),
    ...     exec_probs=torch.tensor([1.0, 0.5]),
    ...     success_probs=torch.tensor([0.5, 1.0]), max_retries=(30, 1))
    >>> [round(float(x), 3) for x in e]
    [6.0, 2.5]
    """
    e, v = stage_means, stage_vars
    if success_probs is not None:
        if max_retries is None:
            raise ValueError("success_probs requires max_retries")
        n_mean, n_var = truncated_geometric_moments(
            success_probs, max_retries, max_support=max_support
        )
        e, v = compound_sum_moments(n_mean, n_var, e, v)
    if exec_probs is not None:
        e, v = mixture_moments(exec_probs, e, v)
    return e, v


# --------------------------------------------------------------------------
# stage composition (multi-stage workflow DAGs)
# --------------------------------------------------------------------------
def serial_moments(stage_means: Tensor, stage_vars: Tensor) -> Tuple[Tensor, Tensor]:
    """Serial (chain) composition: independent stage times add in mean and
    variance.  (S,) or (S, ...) -> (), (...).

    >>> e, v = serial_moments(torch.tensor([3.0, 2.0]), torch.tensor([0.4, 0.1]))
    >>> float(e), round(float(v), 6)
    (5.0, 0.5)
    """
    return torch.sum(stage_means, dim=0), torch.sum(stage_vars, dim=0)


def parallel_max_moments(
    branch_means: Tensor,
    branch_vars: Tensor,
    num_points: int = DEFAULT_QUAD_POINTS,
) -> Tuple[Tensor, Tensor]:
    """Moments of the max over independent parallel branches (B,), each
    moment-matched to a Normal (the PERT approximation), by the survival
    quadrature of :func:`mean_var_completion`.  Branches that share an
    ancestor are treated as independent, which errs conservative.

    >>> e, v = parallel_max_moments(torch.tensor([3.0, 3.0]), torch.tensor([0.25, 0.25]))
    >>> bool(e > 3.0)
    True
    """
    std = torch.sqrt(torch.clamp(branch_vars, min=1e-18))
    eps = _quad_grid(branch_means, std, num_points)  # (Q,)
    surv = 1.0 - torch.exp(_log_cdf_sum(eps[:, None], branch_means, std))
    return _moments_from_survival(eps, surv)


def dag_completion_moments(
    preds: Tuple[Tuple[int, ...], ...],
    stage_means: Tensor,
    stage_vars: Tensor,
    *,
    num_points: int = DEFAULT_QUAD_POINTS,
) -> Tuple[Tensor, Tensor]:
    """End-to-end (E, Var) of a stage DAG by topological reduction.

    ``preds[i]`` lists the stages that finish before stage i starts, every
    index < i.  A stage starts at the max of its predecessors' finishes
    (:func:`parallel_max_moments`) and finishes after its own moments are
    added; the DAG completes at the max over its sinks.  A chain reduces to
    the summed moments exactly.

    >>> e, v = dag_completion_moments(((), (0,), (1,)), torch.tensor([1.0, 2.0, 3.0]),
    ...                               torch.tensor([0.1, 0.1, 0.1]))
    >>> round(float(e), 4), round(float(v), 4)
    (6.0, 0.3)
    """
    s = len(preds)
    fin_e: list = [None] * s
    fin_v: list = [None] * s
    zero = stage_means.new_zeros(())
    for i, ps in enumerate(preds):
        if not ps:
            start_e, start_v = zero, zero
        elif len(ps) == 1:
            start_e, start_v = fin_e[ps[0]], fin_v[ps[0]]
        else:
            start_e, start_v = parallel_max_moments(
                torch.stack([fin_e[p] for p in ps]),
                torch.stack([fin_v[p] for p in ps]),
                num_points,
            )
        fin_e[i] = start_e + stage_means[i]
        fin_v[i] = start_v + stage_vars[i]
    has_succ = {p for pp in preds for p in pp}
    sinks = [i for i in range(s) if i not in has_succ]
    if len(sinks) == 1:
        return fin_e[sinks[0]], fin_v[sinks[0]]
    return parallel_max_moments(
        torch.stack([fin_e[i] for i in sinks]),
        torch.stack([fin_v[i] for i in sinks]),
        num_points,
    )


def sweep_two_way(
    params: UnitParams,
    num_f: int = 201,
    num_points: int = DEFAULT_QUAD_POINTS,
) -> Tuple[Tensor, Tensor, Tensor]:
    """The paper's Fig 1/2 curves: (f_grid, mu(f), sigma^2(f)) for K=2."""
    f_grid = torch.linspace(
        1e-3, 1.0 - 1e-3, num_f, dtype=torch.float32, device=params.mu.device
    )
    fracs = torch.stack([f_grid, 1.0 - f_grid], dim=-1)  # (F, 2)
    mu_f, var_f = mean_var_completion(fracs, params, num_points)
    return f_grid, mu_f, var_f


def pareto_mask(mu_f: Tensor, var_f: Tensor) -> Tensor:
    """Efficient frontier: points not dominated in (mu, var) (both minimized)."""
    dominated = torch.any(
        (mu_f[None, :] <= mu_f[:, None])
        & (var_f[None, :] <= var_f[:, None])
        & ((mu_f[None, :] < mu_f[:, None]) | (var_f[None, :] < var_f[:, None])),
        dim=1,
    )
    return ~dominated


def optimal_two_way_fraction(
    params: UnitParams,
    *,
    num_f: int = 201,
    num_points: int = DEFAULT_QUAD_POINTS,
    objective="mean",
    risk_aversion: float = 0.0,
    var_budget: float = float("inf"),
) -> Tuple[Tensor, Tensor, Tensor]:
    """Pick f on the frontier for K=2.

    ``objective`` is a ``repro_torch.sched.Objective`` or one of the legacy
    strings ("mean" | "mean_var" | "constrained") combined with the
    ``risk_aversion`` / ``var_budget`` floats.  Returns (f*, mu(f*),
    sigma^2(f*)).
    """
    from repro_torch.sched.objectives import Objective, score_moments_dynamic

    if isinstance(objective, Objective):
        risk_aversion = objective.risk_aversion
        var_budget = objective.var_budget
        deadline = objective.deadline
        kind = objective.kind
    else:
        kind = {"constrained": "var_budget"}.get(objective, objective)
        deadline = 0.0
    f_grid, mu_f, var_f = sweep_two_way(params, num_f, num_points)
    if kind == "deadline":
        fracs = torch.stack([f_grid, 1.0 - f_grid], dim=-1)
        score = -completion_cdf(deadline, fracs, params)
    else:
        score = score_moments_dynamic(kind, mu_f, var_f, risk_aversion, var_budget)
    idx = torch.argmin(score).reshape(1)
    pick = lambda x: torch.index_select(x, 0, idx)[0]
    return pick(f_grid), pick(mu_f), pick(var_f)
