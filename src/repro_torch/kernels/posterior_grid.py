"""K1: both exponent log-posteriors for a whole fleet in one launch.

Port of ``repro.kernels.posterior_grid.posterior_grid_fleet_pallas`` (the
paper's O(K*G*N) numerical-integration hot spot, Eqs 10-11).  For every
worker k and grid point g:

    logp_a[k, g] = -lam_k/2 * sum_n m_kn ((t_kn - f_kn^g mu_k) f_kn^-beta_k)^2 + prior(g)
    logp_b[k, g] = -lam_k/2 * sum_n m_kn ((t_kn - f_kn^alpha_k mu_k) f_kn^-g)^2
                   - g * sum_n m_kn log f_kn + prior(g)

with the quadratic forms expanded into three masked inner products over one
shared pow table pg = f^g:

    S_a(g) = A0 - 2 mu <pg, m wb^2 t> + mu^2 <pg^2, m wb^2>,   wb = f^-beta
    S_b(g) = <1/pg^2, m r^2>,                                  r = t - f^alpha mu

``posterior_grid_fleet`` dispatches on the device of its tensors: a CUDA
tensor goes to the hand-written kernel (``csrc/posterior_grid.cu``), which
raises if it cannot be built or launched; a CPU tensor goes to the plain
PyTorch version ``posterior_grid_plain``, which the tests and the on-card
comparison also use.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch import Tensor

from ..device import refuse_dtensor
from .build import CudaKernel

_KERNEL = CudaKernel(
    "posterior_grid_fleet",
    "posterior_grid.cu",
    [ctypes.c_void_p] * 6 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
)


def posterior_grid_plain(
    grid: Tensor,
    t: Tensor,
    f: Tensor,
    mask: Optional[Tensor],
    mu: Tensor,
    lam: Tensor,
    alpha: Tensor,
    beta: Tensor,
    alpha_prior_a: Tensor,
    alpha_prior_b: Tensor,
    beta_prior_a: Tensor,
    beta_prior_b: Tensor,
    *,
    symmetric_grid: bool = False,
) -> Tensor:
    """Plain PyTorch version of K1; also the oracle ``moments.log_posterior_grid``.

    Shapes: grid (G,); t/f/mask (..., N); the per-worker scalars (...).
    Returns (..., 2, G).  ``symmetric_grid=True`` asserts grid[i] +
    grid[G-1-i] is constant and reads the beta mode's f^{-2g} off the alpha
    mode's pg^2 table at the mirrored index (f^{-2 g_i} =
    f^{-2(g_0 + g_{G-1})} f^{2 g_{G-1-i}}), saving the reciprocal per cell.
    """
    f = torch.clamp(f, min=1e-6)
    logf = torch.log(f)  # (..., N)
    m = torch.ones_like(logf) if mask is None else mask.to(logf.dtype)
    col = lambda x: torch.as_tensor(x, dtype=logf.dtype, device=logf.device)[..., None]
    mu_b, lam_b, alpha_b, beta_b = col(mu), col(lam), col(alpha), col(beta)

    wb2 = m * torch.exp(-2.0 * beta_b * logf)  # m f^{-2 beta}
    u = wb2 * t
    a0 = torch.sum(u * t, dim=-1, keepdim=True)
    r = t - torch.exp(alpha_b * logf) * mu_b
    w = m * r * r
    if symmetric_grid:
        w = w * torch.exp(-2.0 * (grid[0] + grid[-1]) * logf)
    sum_logf = torch.sum(logf * m, dim=-1, keepdim=True)

    pg = torch.exp(grid[:, None] * logf[..., None, :])  # (..., G, N) = f^g
    pg2 = pg * pg
    s1 = torch.sum(pg * u[..., None, :], dim=-1)
    s2 = torch.sum(pg2 * wb2[..., None, :], dim=-1)
    s3 = torch.sum((pg2 if symmetric_grid else 1.0 / pg2) * w[..., None, :], dim=-1)
    quad_a = -0.5 * lam_b * (a0 - 2.0 * mu_b * s1 + mu_b * mu_b * s2)
    quad_b = -0.5 * lam_b * s3
    if symmetric_grid:
        quad_b = torch.flip(quad_b, dims=(-1,))

    g = torch.clamp(grid, 1e-6, 1.0 - 1e-6)
    lg = torch.log(g)
    l1mg = torch.log1p(-g)
    logp_a = quad_a + (col(alpha_prior_a) - 1.0) * lg + (col(alpha_prior_b) - 1.0) * l1mg
    logp_b = (
        quad_b
        - grid * sum_logf
        + (col(beta_prior_a) - 1.0) * lg
        + (col(beta_prior_b) - 1.0) * l1mg
    )
    return torch.stack([logp_a, logp_b], dim=-2)


def posterior_grid_cuda(
    grid: Tensor, t: Tensor, f: Tensor, mask: Tensor, params: Tensor,
    *, symmetric_grid: bool = False,
) -> Tensor:
    """Launch K1 on the current stream.

    grid (G,); t/f/mask (K, N); params (K, 8) = (mu, lam, alpha, beta,
    alpha_prior.a, alpha_prior.b, beta_prior.a, beta_prior.b).  All float32
    and on one CUDA device.  Returns (K, 2, G).  ``symmetric_grid=True``
    launches the mirrored mode, which reads the beta mode's f^{-2g} off the
    alpha mode's pg^2 (see ``posterior_grid_plain``); only for a grid
    symmetric about its midpoint.
    """
    k, n = t.shape
    g_n = grid.shape[0]
    tensors = (grid, t, f, mask, params)
    for x in tensors:
        if not x.is_cuda or x.dtype != torch.float32 or x.device != t.device:
            raise ValueError("posterior_grid_cuda takes float32 tensors on one CUDA device")
    if f.shape != (k, n) or mask.shape != (k, n) or params.shape != (k, 8) or grid.ndim != 1:
        raise ValueError(
            f"shapes: grid {tuple(grid.shape)}, t {tuple(t.shape)}, f {tuple(f.shape)}, "
            f"mask {tuple(mask.shape)}, params {tuple(params.shape)}"
        )
    grid, t, f, mask, params = (x.contiguous() for x in tensors)
    out = torch.empty((k, 2, g_n), dtype=torch.float32, device=t.device)
    stream = torch.cuda.current_stream(t.device).cuda_stream
    with torch.cuda.device(t.device):
        _KERNEL.launch(
            grid.data_ptr(), t.data_ptr(), f.data_ptr(), mask.data_ptr(),
            params.data_ptr(), out.data_ptr(), k, n, g_n, int(symmetric_grid), stream,
        )
    return out


def posterior_grid_fleet(
    grid: Tensor,
    t: Tensor,
    f: Tensor,
    mask: Tensor,
    mu: Tensor,
    lam: Tensor,
    alpha: Tensor,
    beta: Tensor,
    alpha_prior_a: Tensor,
    alpha_prior_b: Tensor,
    beta_prior_a: Tensor,
    beta_prior_b: Tensor,
    *,
    symmetric_grid: bool = False,
) -> Tensor:
    """Both exponent log-posteriors of a K-worker fleet: (K, N) -> (K, 2, G).

    Same signature as ``posterior_grid_fleet_pallas``, plus the reference's
    ``symmetric_grid`` (``moments.log_posterior_grid``), which the Pallas
    route ignored.  CUDA tensors run the kernel in the mode it picks; CPU
    tensors run ``posterior_grid_plain`` in the same form; a DTensor is
    refused.
    """
    refuse_dtensor("posterior_grid_fleet", grid, t, f, mask, mu, lam, alpha, beta)
    if t.device.type == "cpu":
        return posterior_grid_plain(
            grid, t, f, mask, mu, lam, alpha, beta,
            alpha_prior_a, alpha_prior_b, beta_prior_a, beta_prior_b,
            symmetric_grid=symmetric_grid,
        )
    if not t.is_cuda:
        raise ValueError(f"posterior_grid_fleet: no kernel for device {t.device}")
    k = t.shape[0]
    per_k = lambda x: torch.broadcast_to(
        torch.as_tensor(x, dtype=torch.float32, device=t.device), (k,)
    )
    params = torch.stack(
        [per_k(x) for x in (mu, lam, alpha, beta, alpha_prior_a, alpha_prior_b,
                            beta_prior_a, beta_prior_b)],
        dim=1,
    )
    as_f32 = lambda x: x.to(torch.float32)
    return posterior_grid_cuda(as_f32(grid), as_f32(t), as_f32(f), as_f32(mask), params,
                               symmetric_grid=symmetric_grid)
