"""Grid-based posteriors for the scaling exponents alpha, beta — Eqs 10-18.

PyTorch counterpart of ``repro.core.moments``.  The posteriors of alpha
(Eq 10) and beta (Eq 11) are non-conjugate, so, following the paper, we
(i) evaluate the unnormalized log-posterior on a grid over (0, 1), (ii)
compute E and Var by numerical integration (Eqs 16-18), and (iii) fit a Beta
distribution by the method of moments (Eqs 12-15).

Step (i) is kernel K1: ``update_alpha_beta_params`` sends it through
``kernels.ops.posterior_grid_fleet`` — one launch for the whole fleet and
both exponents on a CUDA tensor, the plain version ``log_posterior_grid`` on
a CPU tensor.
"""
from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch
from torch import Tensor

from repro_torch.kernels import ops as _kops
from repro_torch.kernels.posterior_grid import posterior_grid_plain

from .distributions import normalize_log_density, trapezoid_weights

DEFAULT_GRID_SIZE = 512
GRID_LO = 1e-4
GRID_HI = 1.0 - 1e-4


class BetaParams(NamedTuple):
    """Beta prior/posterior hyperparameters for one exponent."""

    a: Tensor  # theta (for alpha) / delta (for beta)
    b: Tensor  # phi   (for alpha) / eta   (for beta)

    @staticmethod
    def default(shape=(), device=None) -> "BetaParams":
        # Weakly informative, mildly favouring the interior of (0, 1).
        full = lambda: torch.full(shape, 2.0, dtype=torch.float32, device=device)
        return BetaParams(full(), full())


def exponent_grid(size: int = DEFAULT_GRID_SIZE, device=None) -> Tensor:
    return torch.linspace(GRID_LO, GRID_HI, size, dtype=torch.float32, device=device)


def log_posterior_grid(
    grid: Tensor,
    t: Tensor,
    f: Tensor,
    mu: Tensor,
    lam: Tensor,
    alpha: Tensor,
    beta: Tensor,
    alpha_prior: BetaParams,
    beta_prior: BetaParams,
    mask: Optional[Tensor] = None,
    *,
    symmetric_grid: bool = False,
) -> Tensor:
    """Fused plain evaluation of both exponent log-posteriors (Eqs 10 + 11).

    Shapes: grid (G,); t/f/mask (..., N); mu/lam/alpha/beta and the prior
    leaves (...) -> (..., 2, G), [..., 0, :] the alpha posterior and
    [..., 1, :] the beta posterior.  ``symmetric_grid`` may be set only for
    a midpoint-symmetric grid (``exponent_grid`` is one); see
    ``kernels.posterior_grid.posterior_grid_plain``.
    """
    return posterior_grid_plain(
        grid, t, f, mask, mu, lam, alpha, beta,
        alpha_prior.a, alpha_prior.b, beta_prior.a, beta_prior.b,
        symmetric_grid=symmetric_grid,
    )


def log_posterior_alpha_ref(
    grid: Tensor,
    t: Tensor,
    f: Tensor,
    mu: Tensor,
    lam: Tensor,
    beta: Tensor,
    prior: BetaParams,
    mask: Optional[Tensor] = None,
) -> Tensor:
    """Unnormalized log p(alpha | T, F, mu, lambda, beta) on ``grid`` (Eq 10).

    The alpha row of the plain K1 oracle.  Shapes: grid (G,), t/f (N,) ->
    (G,); leading batch axes broadcast.
    """
    return log_posterior_grid(
        grid, t, f, mu, lam, 0.5, beta, prior, BetaParams.default(device=t.device), mask,
    )[..., 0, :]


def log_posterior_beta_ref(
    grid: Tensor,
    t: Tensor,
    f: Tensor,
    mu: Tensor,
    lam: Tensor,
    alpha: Tensor,
    prior: BetaParams,
    mask: Optional[Tensor] = None,
) -> Tensor:
    """Unnormalized log p(beta | T, F, mu, lambda, alpha) on ``grid`` (Eq 11),
    with the -beta * sum(log f) Jacobian term of Eq 4: the beta row of the
    plain K1 oracle."""
    return log_posterior_grid(
        grid, t, f, mu, lam, alpha, 0.5, BetaParams.default(device=t.device), prior, mask,
    )[..., 1, :]


def moments_from_log_density(grid: Tensor, logp: Tensor) -> Tuple[Tensor, Tensor]:
    """E and Var by numerical integration of a grid log-density (Eqs 16-18)."""
    pdf = normalize_log_density(logp, grid)
    w = trapezoid_weights(grid)
    e1 = torch.sum(pdf * w * grid, dim=-1)
    e2 = torch.sum(pdf * w * grid * grid, dim=-1)
    var = torch.clamp(e2 - e1 * e1, min=1e-12)
    return e1, var


def fit_beta_method_of_moments(mean: Tensor, var: Tensor) -> BetaParams:
    """Beta(a, b) from (E, Var) — Eqs 12-15, clamped into Var < E(1-E)."""
    mean = torch.clamp(mean, 1e-4, 1.0 - 1e-4)
    cap = mean * (1.0 - mean)
    var = torch.minimum(torch.clamp(var, min=1e-10), 0.999 * cap)
    common = cap / var - 1.0
    a = mean * common
    b = (1.0 - mean) * common
    return BetaParams(torch.clamp(a, min=1e-3), torch.clamp(b, min=1e-3))


def update_alpha_beta_params(
    grid: Tensor,
    t: Tensor,
    f: Tensor,
    mu: Tensor,
    lam: Tensor,
    alpha: Tensor,
    beta: Tensor,
    alpha_prior: BetaParams,
    beta_prior: BetaParams,
    mask: Optional[Tensor] = None,
    *,
    symmetric_grid: bool = False,
) -> Tuple[BetaParams, BetaParams]:
    """Posterior Beta approximations for alpha and beta (one Gibbs sub-step).

    ``t``/``f``/``mask`` may carry leading fleet axes, with the scalars and
    prior leaves shaped to match; the whole fleet is one K1 launch.
    ``symmetric_grid`` may be set when ``grid`` is midpoint-symmetric
    (``exponent_grid`` is); see ``log_posterior_grid``.
    """
    logp = _kops.posterior_grid_fleet(
        grid, t, f, mu, lam, alpha, beta, alpha_prior, beta_prior, mask,
        symmetric_grid=symmetric_grid,
    )
    ea, va = moments_from_log_density(grid, logp[..., 0, :])
    eb, vb = moments_from_log_density(grid, logp[..., 1, :])
    return fit_beta_method_of_moments(ea, va), fit_beta_method_of_moments(eb, vb)
