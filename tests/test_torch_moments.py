"""Port parity: the plain grid posterior (K1's plain version), grid moment
integration, the Beta moment fit and one full exponent sub-step.

The same numpy inputs go through ``repro.core.moments`` (JAX on the CPU)
and ``repro_torch.core.moments``.  The grid posterior is held with the
reference kernel tests' own tolerance, ``_assert_logp_close`` (rtol 2e-5
scaled by 1 + max|logp|, tests/test_kernels.py).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import moments as jm
from repro_torch.core import moments as tm

CASES = [(1, 64, 100), (3, 300, 777), (4, 512, 128), (5, 17, 33)]


def fleet_case(k, n, seed=0, zero_cols=False):
    """K-worker telemetry with per-worker params and ragged masks (numpy),
    shaped as the reference's ``_fleet_case``."""
    rng = np.random.default_rng(seed)
    f = rng.uniform(0.05, 0.95, (k, n))
    mu = np.linspace(5.0, 40.0, k)
    t = f**0.9 * mu[:, None] + f**0.7 * 2.0 * rng.normal(size=(k, n))
    mask = (np.arange(n)[None, :] < np.linspace(n // 2, n, k)[:, None]).astype(np.float64)
    if zero_cols:
        mask = mask * (np.arange(n) % 5 != 0)[None, :]
    lam = np.linspace(0.1, 0.5, k)
    alpha = np.linspace(0.6, 0.95, k)
    beta = np.linspace(0.5, 0.9, k)
    ap = (np.linspace(1.5, 4.0, k), np.linspace(2.0, 3.0, k))
    bp = (np.linspace(2.0, 5.0, k), np.linspace(1.5, 2.5, k))
    f32 = lambda x: np.asarray(x, np.float32)
    return dict(
        t=f32(t), f=f32(f), mask=f32(mask), mu=f32(mu), lam=f32(lam),
        alpha=f32(alpha), beta=f32(beta), ap=tuple(map(f32, ap)), bp=tuple(map(f32, bp)),
    )


def assert_logp_close(got, want, rtol=2e-5):
    want = np.asarray(want)
    scale = 1.0 + float(np.max(np.abs(want)))
    np.testing.assert_allclose(np.asarray(got), want, rtol=rtol, atol=rtol * scale)


def _jax_grid(grid, c, **kw):
    J = jnp.asarray
    return jm.log_posterior_grid(
        J(grid), J(c["t"]), J(c["f"]), J(c["mu"]), J(c["lam"]), J(c["alpha"]),
        J(c["beta"]), jm.BetaParams(*map(J, c["ap"])), jm.BetaParams(*map(J, c["bp"])),
        J(c["mask"]), **kw,
    )


def _torch_grid(grid, c, **kw):
    T = torch.as_tensor
    return tm.log_posterior_grid(
        T(grid), T(c["t"]), T(c["f"]), T(c["mu"]), T(c["lam"]), T(c["alpha"]),
        T(c["beta"]), tm.BetaParams(*map(T, c["ap"])), tm.BetaParams(*map(T, c["bp"])),
        T(c["mask"]), **kw,
    )


@pytest.mark.parametrize("symmetric", [False, True])
@pytest.mark.parametrize("zero_cols", [False, True])
@pytest.mark.parametrize("k,g,n", CASES)
def test_log_posterior_grid_matches_reference(k, g, n, zero_cols, symmetric):
    """Both forms, on the reference kernel tests' cases: the general
    reciprocal form on a linspace grid, the mirror form on exponent_grid."""
    c = fleet_case(k, n, zero_cols=zero_cols)
    grid = np.asarray(jm.exponent_grid(g)) if symmetric else np.linspace(
        1e-4, 1 - 1e-4, g, dtype=np.float32
    )
    got = _torch_grid(grid, c, symmetric_grid=symmetric)
    assert got.shape == (k, 2, g)
    assert_logp_close(got, _jax_grid(grid, c, symmetric_grid=symmetric))


def test_log_posterior_grid_fully_masked_worker_is_prior():
    c = fleet_case(3, 150, seed=7)
    c["mask"][1] = 0.0
    grid = np.linspace(1e-4, 1 - 1e-4, 64, dtype=np.float32)
    got = _torch_grid(grid, c)
    assert torch.isfinite(got).all()
    assert_logp_close(got, _jax_grid(grid, c))
    gc = np.clip(grid, 1e-6, 1 - 1e-6)
    prior_only = (c["ap"][0][1] - 1.0) * np.log(gc) + (c["ap"][1][1] - 1.0) * np.log1p(-gc)
    np.testing.assert_allclose(got[1, 0].numpy(), prior_only, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("g", [64, 257])
def test_symmetric_grid_identity(g):
    """On the symmetric exponent grid the mirror form equals the general
    reciprocal form (the reference's identity test, rtol 1e-5)."""
    c = fleet_case(3, 250, seed=9)
    grid = tm.exponent_grid(g).numpy()
    general = _torch_grid(grid, c, symmetric_grid=False)
    mirrored = _torch_grid(grid, c, symmetric_grid=True)
    assert_logp_close(mirrored, general, rtol=1e-5)


def test_moments_and_beta_fit_match_reference():
    rng = np.random.default_rng(4)
    grid = np.asarray(jm.exponent_grid(128))
    logp = (-((grid[None, :] - rng.uniform(0.2, 0.8, (6, 1))) ** 2)
            * rng.uniform(50, 5000, (6, 1))).astype(np.float32)
    want = jm.moments_from_log_density(jnp.asarray(grid), jnp.asarray(logp))
    got = tm.moments_from_log_density(torch.as_tensor(grid), torch.as_tensor(logp))
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-5)
    # Var = E[g^2] - E[g]^2 cancels two O(0.1) sums taken in another order:
    # held absolutely, at a few float32 ulps of E[g^2]
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), atol=1e-6)
    mean = np.asarray([0.5, 1e-6, 0.999999, 0.3, 0.7], np.float32)
    var = np.asarray([0.01, 0.1, 1e-3, 1e-12, 0.5], np.float32)
    want = jm.fit_beta_method_of_moments(jnp.asarray(mean), jnp.asarray(var))
    got = tm.fit_beta_method_of_moments(torch.as_tensor(mean), torch.as_tensor(var))
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=1e-5)


def test_update_alpha_beta_params_matches_reference():
    """One (alpha, beta) sub-step at a fixed state: grid posterior -> moments
    -> Beta fit.  The fit maps (E, Var) one to one onto (a, b), and a tight
    posterior's a + b ~ 1/Var amplifies Var's float32 cancellation noise, so
    each fitted Beta is held through its moments: the mean a/(a+b) at rtol
    1e-5, the variance absolutely at 1e-6, as in the moment test above."""
    c = fleet_case(4, 96, seed=5)
    grid = np.asarray(jm.exponent_grid(256))
    J, T = jnp.asarray, torch.as_tensor
    args = lambda X, B: (
        X(grid), X(c["t"]), X(c["f"]), X(c["mu"]), X(c["lam"]), X(c["alpha"]),
        X(c["beta"]), B(*map(X, c["ap"])), B(*map(X, c["bp"])), X(c["mask"]),
    )
    want = jm.update_alpha_beta_params(*args(J, jm.BetaParams))
    got = tm.update_alpha_beta_params(*args(T, tm.BetaParams))
    beta_moments = lambda a, b: (a / (a + b), a * b / ((a + b) ** 2 * (a + b + 1.0)))
    for gp, wp in zip(got, want):
        g_mean, g_var = beta_moments(*(x.double().numpy() for x in gp))
        w_mean, w_var = beta_moments(*(np.asarray(x, np.float64) for x in wp))
        np.testing.assert_allclose(g_mean, w_mean, rtol=1e-5)
        np.testing.assert_allclose(g_var, w_var, atol=1e-6)
