"""Conjugate Normal-Gamma updates for (mu, lambda) — Eqs 6-9 of the paper.

PyTorch counterpart of ``repro.core.posterior``.  The completion-time model
of one processing unit is

    t_n | f_n ~ N( f_n^alpha * mu,  f_n^{2 beta} / lambda )        (Eq 1)

and with the Normal-Gamma prior the posterior after a batch (T, F), with
(alpha, beta) held fixed, is Normal-Gamma with the parameters of Eqs 6-9.
Every update takes an optional validity ``mask`` and broadcasts over leading
worker axes.
"""
from __future__ import annotations

import math
from typing import NamedTuple, Optional

import torch
from torch import Tensor

_PSI_FLOOR = 1e-8
_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)


class NormalGammaParams(NamedTuple):
    """Hyperparameters of the Normal-Gamma distribution over (mu, lambda)."""

    mu0: Tensor
    kappa0: Tensor
    nu0: Tensor
    psi0: Tensor

    @staticmethod
    def default(
        mu_guess=1.0, shape=(), device=None
    ) -> "NormalGammaParams":
        """A weak prior centred at ``mu_guess`` (a float or a tensor)."""
        if isinstance(mu_guess, Tensor):
            mu0 = torch.broadcast_to(mu_guess.to(torch.float32), shape).clone()
            device = mu0.device
        else:
            mu0 = torch.full(shape, float(mu_guess), dtype=torch.float32, device=device)
        full = lambda v: torch.full(shape, v, dtype=torch.float32, device=device)
        return NormalGammaParams(mu0=mu0, kappa0=full(1e-3), nu0=full(1.0), psi0=full(1.0))


def update_normal_gamma(
    prior: NormalGammaParams,
    t: Tensor,
    f: Tensor,
    alpha: Tensor,
    beta: Tensor,
    mask: Optional[Tensor] = None,
) -> NormalGammaParams:
    """Posterior Normal-Gamma hyperparameters — Eqs 6-9.

    t, f (and mask) are (..., N); alpha, beta and the prior leaves carry the
    leading axes (...).
    """
    f = torch.clamp(f, min=1e-6)
    logf = torch.log(f)
    alpha = torch.as_tensor(alpha, dtype=t.dtype, device=t.device)[..., None]
    beta = torch.as_tensor(beta, dtype=t.dtype, device=t.device)[..., None]

    w_cross = torch.exp((alpha - 2.0 * beta) * logf)  # f^{alpha-2beta}
    w_self = torch.exp(2.0 * (alpha - beta) * logf)  # f^{2alpha-2beta}
    t_scaled = t * torch.exp(-beta * logf)  # t / f^beta

    if mask is not None:
        m = mask.to(t.dtype)
        n_eff = torch.sum(m, dim=-1)
        s_cross = torch.sum(m * w_cross * t, dim=-1)
        s_self = torch.sum(m * w_self, dim=-1)
        s_sq = torch.sum(m * t_scaled * t_scaled, dim=-1)
    else:
        n_eff = float(t.shape[-1])
        s_cross = torch.sum(w_cross * t, dim=-1)
        s_self = torch.sum(w_self, dim=-1)
        s_sq = torch.sum(t_scaled * t_scaled, dim=-1)

    kappa_n = prior.kappa0 + s_self  # Eq 7
    mu_n = (prior.mu0 * prior.kappa0 + s_cross) / kappa_n  # Eq 6
    nu_n = prior.nu0 + 0.5 * n_eff  # Eq 8
    psi_n = prior.psi0 + 0.5 * (
        -mu_n * mu_n * kappa_n + prior.mu0 * prior.mu0 * prior.kappa0 + s_sq
    )  # Eq 9
    # psi_n > 0 mathematically; the clamp guards float32 cancellation.
    psi_n = torch.clamp(psi_n, min=_PSI_FLOOR)
    return NormalGammaParams(mu_n, kappa_n, nu_n, psi_n)


def log_likelihood(
    t: Tensor,
    f: Tensor,
    mu: Tensor,
    lam: Tensor,
    alpha: Tensor,
    beta: Tensor,
    mask: Optional[Tensor] = None,
) -> Tensor:
    """Data log-likelihood (Eq 4 with the 1/f^beta Jacobian), summed over N."""
    f = torch.clamp(f, min=1e-6)
    logf = torch.log(f)
    col = lambda x: torch.as_tensor(x, dtype=t.dtype, device=t.device)[..., None]
    alpha, beta, lam_b, mu_b = col(alpha), col(beta), col(lam), col(mu)

    mean = torch.exp(alpha * logf) * mu_b
    z = (t - mean) * torch.exp(-beta * logf)
    ll = (
        0.5 * torch.log(torch.clamp(lam_b, min=1e-30))
        - beta * logf
        - 0.5 * lam_b * z * z
        - _LOG_SQRT_2PI
    )
    if mask is not None:
        ll = ll * mask.to(ll.dtype)
    return torch.sum(ll, dim=-1)


def posterior_predictive_logpdf(
    t: Tensor, f: Tensor, mu: Tensor, lam: Tensor, alpha: Tensor, beta: Tensor
) -> Tensor:
    """Plug-in predictive log-density of single observations (elementwise).

    Used by the straggler detector: persistently low values mean the unit no
    longer behaves like its learned model.
    """
    f = torch.clamp(f, min=1e-6)
    mean = f**alpha * mu
    sigma = f**beta / torch.sqrt(torch.clamp(torch.as_tensor(lam), min=1e-30))
    sigma = torch.clamp(sigma, min=1e-6)
    z = (t - mean) / sigma
    return -0.5 * z * z - torch.log(sigma) - _LOG_SQRT_2PI
