"""Public wrappers around the hand-written kernels.

Each wrapper dispatches on the device of its tensors: CUDA tensors launch the
kernel (or raise), CPU tensors run the kernel's plain PyTorch version.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch
from torch import Tensor

from repro_torch.sharding import shard_fleet_call

from .decode_attention import decode_attention as _decode_attention
from .lru_scan import lru_scan as _lru_scan
from .posterior_grid import posterior_grid_fleet as _posterior_grid_fleet


def posterior_grid_fleet(
    grid: Tensor,
    t: Tensor,
    f: Tensor,
    mu: Tensor,
    lam: Tensor,
    alpha: Tensor,
    beta: Tensor,
    alpha_prior,
    beta_prior,
    mask: Optional[Tensor] = None,
    *,
    symmetric_grid: bool = False,
    sharding=None,
    active_idx: Optional[Tensor] = None,
    out_prev: Optional[Tensor] = None,
) -> Tensor:
    """Both exponent posteriors for a whole fleet in one kernel launch.

    Signature mirrors ``repro_torch.core.moments.log_posterior_grid``:
    t/f/mask (..., N), per-worker scalars broadcastable to (...) ->
    (..., 2, G).  Stacked leading axes — a workflow DAG's (S, K, N) block,
    or none for a single unit — are folded into one fleet axis before the
    launch and unfolded after it, so the whole stack still costs ONE launch.
    ``symmetric_grid=True`` (only for a midpoint-symmetric grid, as
    ``exponent_grid``) takes K1's mirrored mode.

    ``active_idx`` (an (M,) int64 tensor on the fleet's device; t of shape
    (K, N)) launches K1 over the gathered M-worker slab only: the rows are
    gathered outside the kernel (``index_select``), the kernel runs on
    (M, N), and its (M, 2, G) result is scattered (``index_copy``) into
    ``out_prev``, a (K, 2, G) grid cache, or into zeros when there is none.
    Rows outside ``active_idx`` keep ``out_prev``'s values, and at
    ``active_idx = arange(K)`` the result is bitwise the dense launch's.
    Single-device only (the gather is a cross-shard operation): combine it
    with ``sharding=None``.

    ``sharding`` (a ``repro_torch.sharding.ShardingConfig``) splits the
    (folded) fleet axis across the mesh's ranks: each rank launches K1 once
    on its K_pad / n rows, the pad rows masked out, and the (K, 2, G)
    output is all-gathered, so every rank returns the whole of it.
    """
    if mask is None:
        mask = torch.ones_like(t)
    if active_idx is not None and t.ndim == 2:
        if sharding is not None:
            raise ValueError("active_idx is a single-device path; pass sharding=None")
        k = t.shape[0]
        take_kn = lambda x: torch.broadcast_to(x, t.shape).index_select(0, active_idx)
        take_k = lambda x: torch.broadcast_to(
            torch.as_tensor(x, dtype=torch.float32, device=t.device), (k,)
        ).index_select(0, active_idx)
        slab = posterior_grid_fleet(
            grid, take_kn(t), take_kn(f),
            take_k(mu), take_k(lam), take_k(alpha), take_k(beta),
            type(alpha_prior)(take_k(alpha_prior.a), take_k(alpha_prior.b)),
            type(beta_prior)(take_k(beta_prior.a), take_k(beta_prior.b)),
            take_kn(mask),
            symmetric_grid=symmetric_grid,
        )
        base = (torch.zeros((k, *slab.shape[1:]), dtype=slab.dtype, device=slab.device)
                if out_prev is None else out_prev)
        return base.index_copy(0, active_idx, slab)
    lead = t.shape[:-1]
    n = t.shape[-1]
    flat_kn = lambda x: torch.broadcast_to(x, t.shape).reshape(-1, n)
    flat_k = lambda x: torch.broadcast_to(
        torch.as_tensor(x, dtype=torch.float32, device=t.device), lead
    ).reshape(-1)
    args = (
        flat_kn(t), flat_kn(f), flat_kn(mask),
        flat_k(mu), flat_k(lam), flat_k(alpha), flat_k(beta),
        flat_k(alpha_prior.a), flat_k(alpha_prior.b),
        flat_k(beta_prior.a), flat_k(beta_prior.b),
    )
    launch = lambda *a: _posterior_grid_fleet(grid, *a, symmetric_grid=symmetric_grid)
    if sharding is None:
        out = launch(*args)
    else:
        out = shard_fleet_call(launch, sharding, args, mask_index=2)
    return out.reshape(*lead, *out.shape[1:])


class _Prior(NamedTuple):
    a: Tensor
    b: Tensor


def _single_mode(grid, t, f, mu, lam, exponent, prior, mask, mode):
    """Row ``mode`` of the fused launch, given the other mode's exponent.
    The unused mode's exponent (0.5) and prior (``BetaParams.default``'s 2,
    2) are dummies made on t's device, so a call copies nothing from the
    host and a CUDA graph can capture it."""
    dummy = lambda v: torch.full((), v, dtype=torch.float32, device=t.device)
    other = _Prior(dummy(2.0), dummy(2.0))
    if mode == 0:
        alpha, beta, priors = dummy(0.5), exponent, (prior, other)
    else:
        alpha, beta, priors = exponent, dummy(0.5), (other, prior)
    return posterior_grid_fleet(grid, t, f, mu, lam, alpha, beta, *priors, mask)[..., mode, :]


def posterior_grid_alpha(
    grid: Tensor,
    t: Tensor,
    f: Tensor,
    mu: Tensor,
    lam: Tensor,
    beta: Tensor,
    prior,
    mask: Optional[Tensor] = None,
) -> Tensor:
    """Eq 10 on a grid: the alpha row of the fused launch.

    Production code that needs both exponents calls ``posterior_grid_fleet``
    once; this slice computes, and discards, the beta row too."""
    return _single_mode(grid, t, f, mu, lam, beta, prior, mask, 0)


def posterior_grid_beta(
    grid: Tensor,
    t: Tensor,
    f: Tensor,
    mu: Tensor,
    lam: Tensor,
    alpha: Tensor,
    prior,
    mask: Optional[Tensor] = None,
) -> Tensor:
    """Eq 11 on a grid: the beta row of the fused launch (see
    ``posterior_grid_alpha``)."""
    return _single_mode(grid, t, f, mu, lam, alpha, prior, mask, 1)


def decode_attention(q: Tensor, k: Tensor, v: Tensor, length: Optional[Tensor] = None, *,
                     return_lse: bool = False):
    """Flash-decode GQA attention (B,H,D) x (B,S,KVH,D) -> (B,H,D); length
    (B,) valid cache rows, all S by default.  With ``return_lse`` also the
    (B, H) float32 log-sum-exps of the scaled scores (-inf where no row is
    valid)."""
    if length is None:
        length = torch.full((q.shape[0],), k.shape[1], dtype=torch.int32, device=q.device)
    return _decode_attention(q, k, v, length, return_lse=return_lse)


def lru_scan(a: Tensor, b: Tensor, h0: Optional[Tensor] = None) -> Tensor:
    """Linear-recurrence scan h_t = a_t h_{t-1} + b_t (RG-LRU core); h0
    (B, R) zeros by default."""
    if h0 is None:
        h0 = torch.zeros((a.shape[0], a.shape[2]), dtype=a.dtype, device=a.device)
    return _lru_scan(a, b, h0)
