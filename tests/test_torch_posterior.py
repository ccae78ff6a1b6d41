"""Port parity: Normal-Gamma posterior, likelihoods, logpdfs and samplers.

The same numpy inputs go through ``repro.core`` (JAX on the CPU) and
``repro_torch.core`` (PyTorch on the CPU).  Deterministic functions are held
at rtol 1e-5 (float32 evaluation-order noise).  Samplers cannot reproduce
JAX's threefry streams, so they are held statistically: the mean and
variance of 2e5 draws against the analytic values.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import distributions as jd
from repro.core import posterior as jp
from repro_torch.core import distributions as td
from repro_torch.core import posterior as tp

RTOL = 1e-5


def _case(k=3, n=50, seed=0):
    rng = np.random.default_rng(seed)
    f = rng.uniform(0.05, 0.95, (k, n)).astype(np.float32)
    mu = np.linspace(5.0, 40.0, k).astype(np.float32)
    t = (f**0.9 * mu[:, None] + f**0.7 * 2.0 * rng.normal(size=(k, n))).astype(np.float32)
    mask = (rng.uniform(size=(k, n)) > 0.2).astype(np.float32)
    alpha = np.linspace(0.6, 0.95, k).astype(np.float32)
    beta = np.linspace(0.5, 0.9, k).astype(np.float32)
    lam = np.linspace(0.1, 0.5, k).astype(np.float32)
    prior = [np.linspace(a, b, k).astype(np.float32)
             for a, b in ((3.0, 30.0), (1e-3, 0.5), (1.0, 4.0), (1.0, 3.0))]
    return t, f, mask, mu, lam, alpha, beta, prior


def _close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


J = jnp.asarray
T = torch.as_tensor


@pytest.mark.parametrize("masked", [False, True])
def test_update_normal_gamma_matches_reference(masked):
    t, f, mask, _, _, alpha, beta, prior = _case()
    m = mask if masked else None
    want = jp.update_normal_gamma(
        jp.NormalGammaParams(*map(J, prior)), J(t), J(f), J(alpha), J(beta),
        None if m is None else J(m),
    )
    got = tp.update_normal_gamma(
        tp.NormalGammaParams(*map(T, prior)), T(t), T(f), T(alpha), T(beta),
        None if m is None else T(m),
    )
    for g, w in zip(got[:3], want[:3]):
        _close(g, w)
    # psi_N is a difference of terms ~100x its size: float32 cancellation
    # gives it ~100x the relative rounding of the other three.
    _close(got.psi0, want.psi0, rtol=1e-4)


def test_psi_floor_clamp_matches_reference():
    """A noiseless batch drives psi_N to float32 cancellation: both clamp."""
    f = np.linspace(0.1, 0.9, 64, dtype=np.float32)
    t = (f**0.8 * 10.0).astype(np.float32)
    prior = [np.float32(10.0), np.float32(1e6), np.float32(1.0), np.float32(0.0)]
    want = jp.update_normal_gamma(jp.NormalGammaParams(*map(J, prior)), J(t), J(f), 0.8, 0.8)
    got = tp.update_normal_gamma(
        tp.NormalGammaParams(*map(T, prior)), T(t), T(f), T(0.8), T(0.8)
    )
    np.testing.assert_array_equal(np.asarray(want.psi0), np.float32(1e-8))
    np.testing.assert_array_equal(got.psi0.numpy(), np.float32(1e-8))


def test_log_likelihood_and_predictive_match_reference():
    t, f, mask, mu, lam, alpha, beta, _ = _case(seed=1)
    want = jp.log_likelihood(J(t), J(f), J(mu), J(lam), J(alpha), J(beta), J(mask))
    got = tp.log_likelihood(T(t), T(f), T(mu), T(lam), T(alpha), T(beta), T(mask))
    _close(got, want)
    col = lambda x: x[:, None]
    want = jp.posterior_predictive_logpdf(
        J(t), J(f), J(col(mu)), J(col(lam)), J(col(alpha)), J(col(beta))
    )
    got = tp.posterior_predictive_logpdf(
        T(t), T(f), T(col(mu)), T(col(lam)), T(col(alpha)), T(col(beta))
    )
    _close(got, want)


def test_logpdfs_match_reference():
    rng = np.random.default_rng(2)
    x = rng.uniform(0.01, 0.99, 200).astype(np.float32)
    a = rng.uniform(0.5, 5.0, 200).astype(np.float32)
    b = rng.uniform(0.5, 5.0, 200).astype(np.float32)
    _close(td.normal_logpdf(T(x), T(a), T(b)), jd.normal_logpdf(J(x), J(a), J(b)))
    # a probability: held absolutely (the two ndtr differ in far tails)
    _close(td.normal_cdf(T(x), T(a), T(b)), jd.normal_cdf(J(x), J(a), J(b)), atol=1e-7)
    # lgamma differs by ulps of its O(1) value between the two libraries,
    # so the log-densities built on it are also held absolutely at 1e-5
    _close(td.gamma_logpdf(T(x), T(a), T(b)), jd.gamma_logpdf(J(x), J(a), J(b)), atol=1e-5)
    _close(td.beta_logpdf(T(x), T(a), T(b)), jd.beta_logpdf(J(x), J(a), J(b)), atol=1e-5)


def test_quadrature_helpers_match_reference():
    rng = np.random.default_rng(3)
    grid = np.sort(rng.uniform(0.0, 1.0, 33)).astype(np.float32)
    logp = (rng.normal(size=(4, 33)) * 50.0).astype(np.float32)
    _close(td.trapezoid_weights(T(grid)), jd.trapezoid_weights(J(grid)))
    _close(
        td.normalize_log_density(T(logp), T(grid)),
        jd.normalize_log_density(J(logp), J(grid)),
        atol=1e-6,
    )


def _check_moments(draws, mean, var, n):
    draws = draws.double().numpy()
    assert np.isfinite(draws).all()
    # 6 standard errors of the mean; the variance to 5 % of its value
    assert abs(draws.mean() - mean) < 6.0 * np.sqrt(var / n)
    np.testing.assert_allclose(draws.var(), var, rtol=0.05)


N_DRAWS = 200_000


def test_gamma_and_normal_sampler_moments():
    gen = torch.Generator().manual_seed(0)
    shape, rate = 2.5, 1.5
    draws = td.sample_gamma(gen, torch.full((N_DRAWS,), shape), torch.tensor(rate))
    _check_moments(draws, shape / rate, shape / rate**2, N_DRAWS)
    draws = td.sample_normal(gen, torch.full((N_DRAWS,), 3.0), torch.tensor(0.5))
    _check_moments(draws, 3.0, 0.25, N_DRAWS)


@pytest.mark.parametrize("a,b", [(2.0, 5.0), (0.5, 0.5), (30.0, 3.0)])
def test_beta_sampler_moments(a, b):
    gen = torch.Generator().manual_seed(1)
    draws = td.sample_beta(gen, torch.full((N_DRAWS,), a), torch.tensor(b))
    mean = a / (a + b)
    var = a * b / ((a + b) ** 2 * (a + b + 1.0))
    _check_moments(draws, mean, var, N_DRAWS)


def test_beta_sampler_tiny_shape_has_no_nan():
    """Beta(1e-3, 2) — the moment fit's floor — underflows a naive
    X/(X+Y) of Gamma draws to 0/0; the log-space draw stays finite."""
    gen = torch.Generator().manual_seed(2)
    a, b = 1e-3, 2.0
    draws = td.sample_beta(gen, torch.full((N_DRAWS,), a), torch.tensor(b))
    assert torch.isfinite(draws).all()
    assert bool(((draws >= td.EPS) & (draws <= 1.0 - td.EPS)).all())
    mean = a / (a + b)
    var = a * b / ((a + b) ** 2 * (a + b + 1.0))
    assert abs(float(draws.double().mean()) - mean) < 6.0 * np.sqrt(var / N_DRAWS)
