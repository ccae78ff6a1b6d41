"""Algorithm 1 — Gibbs sampling of (mu, sigma, alpha, beta).

PyTorch counterpart of ``repro.core.gibbs``: the dense path, the compressed
active set of ``core.compress``, and the fleet sharded over a mesh
(``core.sharding``).  Per batch of telemetry (T, F) the sampler runs
``n_iters`` sweeps; each sweep

  - recomputes the Normal-Gamma posterior (Eqs 6-9) at the current
    (alpha, beta) and samples lambda ~ Gamma(nu_N, psi_N),
    mu ~ N(mu_N, (kappa_N lambda)^{-1});
  - refits the Beta approximations of alpha and beta (Eqs 10-18) at the
    current (mu, lambda) — one K1 launch for the whole fleet — and samples
    alpha, beta from them.

Batches chain: the posterior hyperparameters become the next batch's prior.

A ``GibbsState`` holds no key: an explicit ``torch.Generator`` on the
state's device travels beside it, and every sampler draws from it in place.
Leaves are scalars for one unit, or carry leading fleet axes (K,) — every
sub-step broadcasts over them, and no operation mixes fleet rows.
"""
from __future__ import annotations

from typing import Callable, NamedTuple, Optional, Tuple

import numpy as np
import torch
from torch import Tensor

from repro_torch.device import resolve_device

from .distributions import sample_beta, sample_gamma, sample_normal
from .moments import BetaParams, exponent_grid, update_alpha_beta_params
from .posterior import NormalGammaParams, log_likelihood, update_normal_gamma
from repro_torch.sharding import (
    ShardingConfig,
    gather_fleet,
    local_rows,
    pad_fleet_axis,
    pad_fleet_mask,
    tree_map,
    unpad_fleet_axis,
)


class GibbsState(NamedTuple):
    """Carry of the Gibbs chain: prior hyperparameters + current samples."""

    ng: NormalGammaParams
    alpha_prior: BetaParams
    beta_prior: BetaParams
    mu: Tensor
    lam: Tensor
    alpha: Tensor
    beta: Tensor

    @property
    def sigma(self) -> Tensor:
        return torch.sqrt(1.0 / torch.clamp(self.lam, min=1e-30))


def _mu_scale(kappa: Tensor, lam: Tensor) -> Tensor:
    return 1.0 / torch.sqrt(torch.clamp(kappa * lam, min=1e-30))


def init_state(
    generator: torch.Generator,
    ng: Optional[NormalGammaParams] = None,
    alpha_prior: Optional[BetaParams] = None,
    beta_prior: Optional[BetaParams] = None,
    mu_guess=1.0,
    shape=(),
) -> GibbsState:
    """Draw the initial (alpha, beta, lambda, mu) from the priors (Algorithm 1).

    Runs on the generator's device.  ``shape`` is the fleet shape of the
    default priors: () for one unit, (K,) for a fleet.
    """
    device = generator.device
    ng = ng if ng is not None else NormalGammaParams.default(mu_guess, shape, device)
    alpha_prior = alpha_prior if alpha_prior is not None else BetaParams.default(shape, device)
    beta_prior = beta_prior if beta_prior is not None else BetaParams.default(shape, device)
    alpha = sample_beta(generator, alpha_prior.a, alpha_prior.b)
    beta = sample_beta(generator, beta_prior.a, beta_prior.b)
    lam = sample_gamma(generator, ng.nu0, ng.psi0)
    mu = sample_normal(generator, ng.mu0, _mu_scale(ng.kappa0, lam))
    return GibbsState(ng, alpha_prior, beta_prior, mu, lam, alpha, beta)


def _advance(
    state: GibbsState,
    t: Tensor,
    f: Tensor,
    mask: Optional[Tensor],
    *,
    generator: torch.Generator,
    n_iters: int,
    grid_size: int,
    chain_priors: bool,
    sharding: Optional[ShardingConfig] = None,
) -> Tuple[GibbsState, Tensor]:
    """One telemetry batch of full Gibbs sweeps (the dense path).

    Strictly per-worker: no operation mixes rows of the fleet axis, so a
    gathered slab of rows computes what the same rows compute in the whole
    fleet, given the same draws.

    With ``sharding`` the fleet axis is split across the mesh's ranks: each
    rank runs the per-worker work on its own block of rows (``own``): the
    Normal-Gamma update, K1 and the Beta fit.  The draws are made in the
    global layout: the rank all-gathers (``everyone``) the O(K) posterior
    parameters, the four Normal-Gamma leaves before lambda and mu are drawn
    and the four Beta leaves before alpha and beta are, and draws over the
    whole K from its replicated generator, as the unsharded sweep draws.  So
    every rank's generator ends where the unsharded call leaves it, every
    rank holds the same global state, and no two shards share noise.  Two
    O(K) gathers a sweep; the (K, 2, G) posteriors never cross ranks.  K not
    dividing the shard count is padded with copies of the last row whose
    telemetry is masked out, and sliced off each gather.  The mask has t's
    shape (``gibbs_batch`` broadcasts it), as the reference's sharded path
    makes it.  Without ``sharding`` both maps are the identity.
    """
    own = everyone = lambda tree: tree
    if sharding is not None:
        k = t.shape[0]
        pad = sharding.pad(k)
        mask = torch.ones_like(t) if mask is None else mask.to(t.dtype)
        mask = local_rows(pad_fleet_mask(mask, pad), sharding)
        own = lambda tree: local_rows(pad_fleet_axis(tree, pad), sharding)
        everyone = lambda tree: unpad_fleet_axis(gather_fleet(tree, sharding), k)
    t_l, f_l = own(t), own(f)
    ng_l, ap_l, bp_l = own(state.ng), own(state.alpha_prior), own(state.beta_prior)
    grid = exponent_grid(grid_size, device=t.device)
    st = state
    ng_post = a_post = b_post = None
    for _ in range(n_iters):
        # -- (mu, lambda) block: conjugate update at current (alpha, beta).
        ng_post = everyone(update_normal_gamma(ng_l, t_l, f_l, own(st.alpha), own(st.beta), mask))
        lam = sample_gamma(generator, ng_post.nu0, ng_post.psi0)
        mu = sample_normal(generator, ng_post.mu0, _mu_scale(ng_post.kappa0, lam))

        # -- (alpha, beta) block: grid posterior (K1) -> Beta fit -> sample.
        a_post, b_post = everyone(update_alpha_beta_params(
            grid, t_l, f_l, own(mu), own(lam), own(st.alpha), own(st.beta), ap_l, bp_l, mask,
            symmetric_grid=True,  # exponent_grid is a symmetric linspace
        ))
        alpha = sample_beta(generator, a_post.a, a_post.b)
        beta = sample_beta(generator, b_post.a, b_post.b)
        st = st._replace(mu=mu, lam=lam, alpha=alpha, beta=beta)

    if chain_priors and n_iters > 0:
        st = st._replace(ng=ng_post, alpha_prior=a_post, beta_prior=b_post)

    ll = everyone(log_likelihood(t_l, f_l, own(st.mu), own(st.lam), own(st.alpha), own(st.beta),
                                 mask))
    return st, ll


def _advance_surrogate(
    state: GibbsState,
    t: Tensor,
    f: Tensor,
    mask: Optional[Tensor],
    *,
    generator: torch.Generator,
    n_iters: int,
    chain_priors: bool,
) -> Tuple[GibbsState, Tensor]:
    """Grid-free Gibbs sweeps against the compressed exponent posterior.

    The stored Beta hyperparameters are the moment-matched surrogate of the
    exponent posterior (``core.compress``): each sweep samples (alpha, beta)
    from the frozen Beta fit and runs only the conjugate Normal-Gamma block.
    The Beta priors are never re-chained; they stay frozen until the worker
    next enters the active set.  Draws come in the dense path's order
    (lambda, mu, alpha, beta per sweep).
    """
    st = state
    ng_post = None
    for _ in range(n_iters):
        ng_post = update_normal_gamma(st.ng, t, f, st.alpha, st.beta, mask)
        lam = sample_gamma(generator, ng_post.nu0, ng_post.psi0)
        mu = sample_normal(generator, ng_post.mu0, _mu_scale(ng_post.kappa0, lam))
        alpha = sample_beta(generator, st.alpha_prior.a, st.alpha_prior.b)
        beta = sample_beta(generator, st.beta_prior.a, st.beta_prior.b)
        st = st._replace(mu=mu, lam=lam, alpha=alpha, beta=beta)

    if chain_priors and n_iters > 0:
        # Only the conjugate block chains; the Beta surrogate stays frozen.
        st = st._replace(ng=ng_post)

    ll = log_likelihood(t, f, st.mu, st.lam, st.alpha, st.beta, mask)
    return st, ll


def tree_map2(fn: Callable[[Tensor, Tensor], Tensor], a, b):
    """Apply ``fn`` to the paired tensor leaves of two states of one layout."""
    if isinstance(a, Tensor):
        return fn(a, b)
    return type(a)(*(tree_map2(fn, x, y) for x, y in zip(a, b)))


def _advance_active(
    state: GibbsState,
    t: Tensor,
    f: Tensor,
    mask: Optional[Tensor],
    active_idx: Tensor,
    **kw,
) -> Tuple[GibbsState, Tensor]:
    """Active-set advance: the full grid path for the gathered M-worker slab,
    the compressed surrogate for every worker, the slab scattered over it.

    The slab advances first, from the generator's state on entry, then the
    surrogate sweeps all K: with ``active_idx = arange(K)`` the slab draws
    exactly what the dense path draws, and the surrogate's rows are all
    overwritten, so the result is bitwise the dense path's.  Gather
    (``index_select``) and scatter (``index_copy``) take a device index, so
    nothing waits for the device.
    """
    m = torch.ones_like(t) if mask is None else mask.to(t.dtype)
    take = lambda x: x.index_select(0, active_idx)
    slab, ll_slab = _advance(tree_map(take, state), take(t), take(f), take(m), **kw)
    kw.pop("grid_size")
    rest, ll_rest = _advance_surrogate(state, t, f, m, **kw)
    put = lambda full, part: full.index_copy(0, active_idx, part)
    return tree_map2(put, rest, slab), put(ll_rest, ll_slab)


def gibbs_batch(
    state: GibbsState,
    t: Tensor,
    f: Tensor,
    mask: Optional[Tensor] = None,
    *,
    generator: torch.Generator,
    n_iters: int = 20,
    grid_size: int = 512,
    chain_priors: bool = True,
    sharding: Optional[ShardingConfig] = None,
    active_idx: Optional[Tensor] = None,
) -> Tuple[GibbsState, Tensor]:
    """Process one telemetry batch; returns (new_state, log_likelihood).

    Fleet-native: with leaves of shape (K,) and t/f/mask of shape (K, N) all
    K chains advance together, and each sweep's grid posterior is ONE K1
    launch covering every worker and both exponents.

    Args:
      state: current chain state (prior hyperparameters + samples).
      t, f: observations, shape (N,) or (K, N).
      mask: optional validity mask, broadcastable to ``t``.  It is broadcast
        to t's shape before it meets the telemetry, so a (K, 1) mask (a
        capacity state's live slots) counts each of a worker's N elements.
      generator: the chain's random source, on the state's device.
      chain_priors: if True (paper's Algorithm 1), the batch posterior becomes
        the next batch's prior.
      sharding: optional ``core.sharding.ShardingConfig``: the fleet axis is
        split across the mesh's ranks, each sweep launching K1 once a rank
        on that rank's rows (``_advance``).  Every rank passes the
        same global state and telemetry and gets back the same global
        result, the unsharded call's chains with its generator left where
        the unsharded call leaves it.  Single-unit (N,) telemetry ignores it.
      active_idx: optional (M,) int64 tensor of fleet rows (on the state's
        device) to advance through the full grid path; the other K - M
        workers advance through the grid-free compressed surrogate
        (``core.compress``), and each sweep's K1 launch covers the M rows
        only.  Bitwise the dense path at ``active_idx = arange(K)``.
        Single-device only (the slab gather is a cross-shard operation):
        combine with ``sharding=None``.
    """
    kw = dict(generator=generator, n_iters=n_iters, grid_size=grid_size,
              chain_priors=chain_priors)
    if mask is not None:
        mask = torch.broadcast_to(mask, t.shape)
    if active_idx is not None and t.ndim >= 2:
        if sharding is not None:
            raise ValueError("active_idx is a single-device path; pass sharding=None")
        return _advance_active(state, t, f, mask, active_idx, **kw)
    return _advance(state, t, f, mask, sharding=sharding if t.ndim >= 2 else None, **kw)


def discount_state(state: GibbsState, rho: float) -> GibbsState:
    """Power-prior forgetting: scale the pseudo-counts by rho in (0, 1].

    Keeps every posterior MEAN but widens the distributions, which
    down-weights old evidence exponentially.  rho=1 recovers the paper.
    """
    if rho >= 1.0:
        return state
    ng = state.ng
    ng = NormalGammaParams(
        mu0=ng.mu0,
        kappa0=ng.kappa0 * rho,
        nu0=torch.clamp(ng.nu0 * rho, min=0.51),  # keep Gamma proper
        psi0=ng.psi0 * rho,
    )
    soften = lambda p: BetaParams(a=(p.a - 1.0) * rho + 1.0, b=(p.b - 1.0) * rho + 1.0)
    return state._replace(
        ng=ng,
        alpha_prior=soften(state.alpha_prior),
        beta_prior=soften(state.beta_prior),
    )


def _as_tensor(x, device) -> Tensor:
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return torch.as_tensor(x, dtype=torch.float32, device=device)


def _generator(seed: int, device) -> torch.Generator:
    return torch.Generator(device=device).manual_seed(int(seed))


def fit(
    seed: int,
    t,
    f,
    *,
    batch_size: int = 32,
    n_iters: int = 20,
    grid_size: int = 512,
    mu_guess: Optional[float] = None,
    device=None,
) -> Tuple[GibbsState, Tensor]:
    """Fit one unit's parameters from a telemetry stream (N,) in batches.

    An entry point: runs on CUDA unless ``device`` says otherwise (and raises
    when no device is given and none is available); ``seed`` seeds its
    generator.  The final partial batch is padded and masked, so every
    observation influences the posterior.

    Returns the final state and the per-batch log-likelihood trace (the
    paper's Fig 5 curve).
    """
    device = resolve_device(device)
    t = _as_tensor(t, device)
    f = _as_tensor(f, device)
    generator = _generator(seed, device)
    n = t.shape[-1]
    n_batches = max(-(-n // batch_size), 1)
    pad = n_batches * batch_size - n
    # Padding observations carry mask=0 and interior dummy values: exact
    # no-ops on every masked reduction.
    t_b = torch.nn.functional.pad(t, (0, pad)).reshape(n_batches, batch_size)
    f_b = torch.nn.functional.pad(f, (0, pad), value=0.5).reshape(n_batches, batch_size)
    m_b = (torch.arange(n + pad, device=device) < n).to(torch.float32).reshape(
        n_batches, batch_size
    )

    guess = t.mean() / torch.clamp(f.mean(), min=1e-6) if mu_guess is None else mu_guess
    state = init_state(generator, mu_guess=guess)
    lls = []
    for b in range(n_batches):
        state, ll = gibbs_batch(
            state, t_b[b], f_b[b], m_b[b], generator=generator,
            n_iters=n_iters, grid_size=grid_size,
        )
        lls.append(ll)
    return state, torch.stack(lls)


def fit_fleet(
    seed: int,
    t,
    f,
    *,
    n_iters: int = 20,
    grid_size: int = 512,
    mu_guess=None,
    device=None,
    sharding: Optional[ShardingConfig] = None,
) -> Tuple[GibbsState, Tensor]:
    """Fleet estimation: t, f of shape (K, N) -> per-worker states (K,).

    An entry point (see ``fit`` for ``seed`` and ``device``).  Every worker
    advances in one fleet-native ``gibbs_batch``: one K1 launch per sweep,
    or one a rank on its rows with ``sharding`` (the unsharded chains).
    """
    device = resolve_device(device)
    t = _as_tensor(t, device)
    f = _as_tensor(f, device)
    generator = _generator(seed, device)
    k = t.shape[0]
    if mu_guess is None:
        mu_guess = t.mean(dim=-1) / torch.clamp(f.mean(dim=-1), min=1e-6)
    ng = NormalGammaParams.default(_as_tensor(mu_guess, device), (k,))
    states = init_state(generator, ng=ng, shape=(k,))
    return gibbs_batch(states, t, f, generator=generator, n_iters=n_iters, grid_size=grid_size,
                       sharding=sharding)


def fold_stage_axis(tree):
    """Fold (S, K, ...) state leaves into the fleet axis: (S*K, ...),
    stage-major, so stage s worker k lands at flat row s*K + k."""
    return tree_map(lambda x: x.reshape(x.shape[0] * x.shape[1], *x.shape[2:]), tree)


def unfold_stage_axis(tree, num_stages: int):
    """Inverse of :func:`fold_stage_axis`: (S*K, ...) leaves -> (S, K, ...)."""
    return tree_map(
        lambda x: x.reshape(num_stages, x.shape[0] // num_stages, *x.shape[1:]), tree
    )


def fit_dag(
    seed: int,
    t,
    f,
    *,
    n_iters: int = 20,
    grid_size: int = 512,
    mu_guess=None,
    device=None,
    sharding: Optional[ShardingConfig] = None,
) -> Tuple[GibbsState, Tensor]:
    """Stacked stage-fleet estimation: t, f of shape (S, K, N).

    The stage axis is folded into the fleet axis, so the whole DAG — every
    stage, every worker, both exponents — is one K1 launch per sweep.
    ``sharding`` splits the folded S*K axis across the mesh, padding S*K
    (not K) up to the shard count.  Returns states with (S, K) leaves and
    the (S, K) log-likelihood.
    """
    device = resolve_device(device)
    t = _as_tensor(t, device)
    f = _as_tensor(f, device)
    s, k, n = t.shape
    states, ll = fit_fleet(
        seed,
        t.reshape(s * k, n),
        f.reshape(s * k, n),
        n_iters=n_iters,
        grid_size=grid_size,
        mu_guess=None if mu_guess is None else _as_tensor(mu_guess, device).reshape(s * k),
        device=device,
        sharding=sharding,
    )
    return unfold_stage_axis(states, s), ll.reshape(s, k)
