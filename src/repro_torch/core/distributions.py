"""Distribution primitives of the Bayesian workflow-partitioning estimator.

PyTorch counterpart of ``repro.core.distributions``.  Every function works
on tensors of any leading shape, on the device of its inputs.  Samplers take
an explicit ``torch.Generator`` on that device in place of a JAX key; they
draw other numbers than JAX's threefry streams, so only their distributions
match the reference.
"""
from __future__ import annotations

import math

import torch
from torch import Tensor

# Numerical floors, as in the reference (everything runs in float32).
EPS = 1e-6
TINY = 1e-30

_LOG_SQRT_2PI = 0.5 * math.log(2.0 * math.pi)
_SQRT_2_OVER_PI = math.sqrt(2.0 / math.pi)
_INV_SQRT_2 = 1.0 / math.sqrt(2.0)


def normal_logpdf(x: Tensor, loc: Tensor, scale: Tensor) -> Tensor:
    scale = torch.clamp(torch.as_tensor(scale), min=EPS)
    z = (x - loc) / scale
    return -0.5 * z * z - torch.log(scale) - _LOG_SQRT_2PI


def normal_cdf(x: Tensor, loc: Tensor, scale: Tensor) -> Tensor:
    scale = torch.clamp(torch.as_tensor(scale), min=EPS)
    return torch.special.ndtr((x - loc) / scale)


class _LogNdtr(torch.autograd.Function):
    """log Phi(z), differentiated through the Mills ratio
    phi(z)/Phi(z) = sqrt(2/pi) / erfcx(-z/sqrt(2)), which is exact in float32
    for every z.  ``torch.special.log_ndtr``'s own derivative cancels z^2/2
    against log Phi(z) and is wrong, or infinite, below z of about -1e4:
    a worker with a tiny share and a tight estimate reaches that at eps = 0."""

    @staticmethod
    def forward(ctx, z):
        ctx.save_for_backward(z)
        return torch.special.log_ndtr(z)

    @staticmethod
    def backward(ctx, grad):
        (z,) = ctx.saved_tensors
        return grad * (_SQRT_2_OVER_PI / torch.special.erfcx(-z * _INV_SQRT_2))


def normal_log_cdf(x: Tensor, loc: Tensor, scale: Tensor) -> Tensor:
    """``log normal_cdf``, finite where the CDF itself underflows to 0, with a
    finite gradient everywhere."""
    scale = torch.clamp(torch.as_tensor(scale), min=EPS)
    return _LogNdtr.apply((x - loc) / scale)


def gamma_logpdf(x: Tensor, shape: Tensor, rate: Tensor) -> Tensor:
    x = torch.clamp(x, min=TINY)
    shape = torch.as_tensor(shape, dtype=x.dtype, device=x.device)
    return (
        shape * torch.log(torch.as_tensor(rate, dtype=x.dtype, device=x.device))
        - torch.special.gammaln(shape)
        + (shape - 1.0) * torch.log(x)
        - rate * x
    )


def _betaln(a: Tensor, b: Tensor) -> Tensor:
    return torch.special.gammaln(a) + torch.special.gammaln(b) - torch.special.gammaln(a + b)


def beta_logpdf(x: Tensor, a: Tensor, b: Tensor) -> Tensor:
    x = torch.clamp(x, EPS, 1.0 - EPS)
    a = torch.as_tensor(a, dtype=x.dtype, device=x.device)
    b = torch.as_tensor(b, dtype=x.dtype, device=x.device)
    return (a - 1.0) * torch.log(x) + (b - 1.0) * torch.log1p(-x) - _betaln(a, b)


def sample_gamma(generator: torch.Generator, shape_param: Tensor, rate: Tensor) -> Tensor:
    """Gamma(shape, rate) draws, one per element of the broadcast parameters."""
    shape_param, rate = torch.broadcast_tensors(shape_param, rate)
    shape_param = torch.clamp(shape_param, min=EPS)
    rate = torch.clamp(rate, min=TINY)
    return torch._standard_gamma(shape_param, generator=generator) / rate


def sample_normal(generator: torch.Generator, loc: Tensor, scale: Tensor) -> Tensor:
    loc, scale = torch.broadcast_tensors(loc, scale)
    z = torch.randn(loc.shape, generator=generator, dtype=loc.dtype, device=loc.device)
    return loc + torch.clamp(scale, min=0.0) * z


def _log_standard_gamma(generator: torch.Generator, a: Tensor) -> Tensor:
    """log X for X ~ Gamma(a, 1), finite for every a > 0.

    Uses Gamma(a) = Gamma(a + 1) * U^(1/a): the draw at shape a + 1 >= 1
    never underflows, and log U = -Exp(1) is taken in log space, so shapes
    as small as the moment fit's 1e-3 floor give no 0 and hence no NaN.
    """
    g = torch._standard_gamma(a + 1.0, generator=generator)
    e = torch.empty_like(a).exponential_(generator=generator)
    return torch.log(g) - e / a


def sample_beta(generator: torch.Generator, a: Tensor, b: Tensor) -> Tensor:
    """Beta(a, b) draws as X / (X + Y) of two Gammas, formed in log space."""
    a, b = torch.broadcast_tensors(a, b)
    a = torch.clamp(a, min=EPS)
    b = torch.clamp(b, min=EPS)
    log_x = _log_standard_gamma(generator, a)
    log_y = _log_standard_gamma(generator, b)
    return torch.clamp(torch.sigmoid(log_x - log_y), EPS, 1.0 - EPS)


def trapezoid_weights(grid: Tensor) -> Tensor:
    """Trapezoid-rule quadrature weights for a (possibly non-uniform) 1-D grid."""
    half = 0.5 * torch.diff(grid)
    return torch.nn.functional.pad(half, (0, 1)) + torch.nn.functional.pad(half, (1, 0))


def normalize_log_density(logp: Tensor, grid: Tensor) -> Tensor:
    """Normalize an unnormalized log-density on ``grid`` (trailing axis) into
    a pdf, by log-sum-exp against trapezoid weights."""
    w = trapezoid_weights(grid)
    m = torch.amax(logp, dim=-1, keepdim=True)
    p = torch.exp(logp - m)
    z = torch.sum(p * w, dim=-1, keepdim=True)
    return p / torch.clamp(z, min=TINY)
