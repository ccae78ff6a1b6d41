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
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch import Tensor

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
