"""Port parity: Algorithm 1 (Gibbs sampling) on PyTorch.

Sampled chains cannot match JAX's threefry streams, so the sweep is held
in two ways: its deterministic conditionals (ng_post, a_post, b_post) at a
fixed state against the reference, and the chain statistically — parameter
recovery at the thresholds of tests/test_gibbs.py.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import gibbs as jg
from repro.core import moments as jm
from repro.core import posterior as jp
from repro_torch.core import gibbs as tg
from repro_torch.core import moments as tm
from repro_torch.core import posterior as tp
from test_torch_moments import fleet_case


def _synth(seed, n, mu, sigma, alpha, beta):
    rng = np.random.default_rng(seed)
    f = rng.uniform(0.05, 0.95, n).astype(np.float32)
    t = (f**alpha * mu + f**beta * sigma * rng.normal(size=n)).astype(np.float32)
    return f, t


def test_sweep_conditionals_match_reference():
    """One sweep's conditional posteriors at a fixed (mu, lam, alpha, beta,
    priors), both in the symmetric-grid form that each package's sweep asks
    for (K1's mirrored mode on the card)."""
    c = fleet_case(4, 64, seed=3)
    J, T = jnp.asarray, torch.as_tensor
    ng = [np.linspace(a, b, 4).astype(np.float32)
          for a, b in ((3.0, 30.0), (1e-3, 0.5), (1.0, 4.0), (1.0, 3.0))]
    want_ng = jp.update_normal_gamma(
        jp.NormalGammaParams(*map(J, ng)), J(c["t"]), J(c["f"]), J(c["alpha"]),
        J(c["beta"]), J(c["mask"]),
    )
    got_ng = tp.update_normal_gamma(
        tp.NormalGammaParams(*map(T, ng)), T(c["t"]), T(c["f"]), T(c["alpha"]),
        T(c["beta"]), T(c["mask"]),
    )
    for g_, w_ in zip(got_ng, want_ng):
        # psi_N cancels terms ~100x its size (see test_torch_posterior)
        np.testing.assert_allclose(g_.numpy(), np.asarray(w_), rtol=1e-4)

    grid = jm.exponent_grid(128)
    args = lambda X, B: (
        X(c["t"]), X(c["f"]), X(c["mu"]), X(c["lam"]), X(c["alpha"]), X(c["beta"]),
        B(*map(X, c["ap"])), B(*map(X, c["bp"])), X(c["mask"]),
    )
    want = jm.update_alpha_beta_params(grid, *args(J, jm.BetaParams), symmetric_grid=True)
    got = tm.update_alpha_beta_params(T(np.asarray(grid)), *args(T, tm.BetaParams),
                                      symmetric_grid=True)
    beta_moments = lambda a, b: (a / (a + b), a * b / ((a + b) ** 2 * (a + b + 1.0)))
    for gp, wp in zip(got, want):  # held through the fitted moments (see test_torch_moments)
        g_mean, g_var = beta_moments(*(x.double().numpy() for x in gp))
        w_mean, w_var = beta_moments(*(np.asarray(x, np.float64) for x in wp))
        np.testing.assert_allclose(g_mean, w_mean, rtol=1e-5)
        np.testing.assert_allclose(g_var, w_var, atol=1e-6)


def test_sweep_reaches_k1_in_its_mirrored_mode(monkeypatch):
    """Every sweep of the port's Gibbs batch sends its grid posterior to K1's
    wrapper with symmetric_grid=True, as the reference's ``_advance`` asks for
    it (gibbs.py:139-143), on the symmetric exponent grid."""
    from repro_torch.kernels import ops as kops

    calls = []
    real = kops.posterior_grid_fleet

    def spy(grid, *args, **kw):
        calls.append(kw.get("symmetric_grid"))
        sym = grid + torch.flip(grid, dims=(0,))
        torch.testing.assert_close(sym, torch.full_like(sym, float(sym[0])), rtol=0, atol=1e-6)
        return real(grid, *args, **kw)

    monkeypatch.setattr(kops, "posterior_grid_fleet", spy)
    f, t = _synth(2, 32, 20.0, 1.0, 0.9, 0.8)
    gen = torch.Generator().manual_seed(0)
    state = tg.init_state(gen)
    tg.gibbs_batch(state, torch.as_tensor(t), torch.as_tensor(f), generator=gen,
                   n_iters=3, grid_size=64)
    assert calls == [True] * 3


def test_discount_state_matches_reference():
    k = 3
    ng = [np.linspace(a, b, k).astype(np.float32)
          for a, b in ((3.0, 30.0), (10.0, 500.0), (0.6, 40.0), (1.0, 3.0))]
    priors = [np.linspace(1.5, 40.0, k).astype(np.float32) for _ in range(4)]
    samples = [np.linspace(0.2, 0.8, k).astype(np.float32) for _ in range(4)]
    J, T = jnp.asarray, torch.as_tensor
    jstate = jg.GibbsState(
        jp.NormalGammaParams(*map(J, ng)), jm.BetaParams(J(priors[0]), J(priors[1])),
        jm.BetaParams(J(priors[2]), J(priors[3])), *map(J, samples),
        J(np.zeros((k, 2), np.uint32)),
    )
    tstate = tg.GibbsState(
        tp.NormalGammaParams(*map(T, ng)), tm.BetaParams(T(priors[0]), T(priors[1])),
        tm.BetaParams(T(priors[2]), T(priors[3])), *map(T, samples),
    )
    want = jg.discount_state(jstate, 0.7)
    got = tg.discount_state(tstate, 0.7)
    flat = lambda s: [s.ng.mu0, s.ng.kappa0, s.ng.nu0, s.ng.psi0, *s.alpha_prior, *s.beta_prior]
    for g_, w_ in zip(flat(got), flat(want)):
        np.testing.assert_allclose(np.asarray(g_), np.asarray(w_), rtol=1e-6)
    assert tg.discount_state(tstate, 1.0) is tstate


def test_gibbs_recovers_parameters():
    """tests/test_gibbs.py's recovery scenario and thresholds, on the port."""
    mu, sigma, alpha, beta = 30.0, 2.0, 0.9, 0.8
    f, t = _synth(0, 512, mu, sigma, alpha, beta)
    state, lls = tg.fit(1, t, f, batch_size=64, n_iters=15, grid_size=256, device="cpu")
    assert lls.shape == (8,) and torch.isfinite(lls).all()
    assert abs(float(state.mu) - mu) < 1.5
    assert abs(float(state.sigma) - sigma) < 1.0
    assert abs(float(state.alpha) - alpha) < 0.08
    assert abs(float(state.beta) - beta) < 0.15


def test_fit_uses_tail_observations():
    """The final partial batch is padded and masked, never dropped."""
    f, t = _synth(30, 48, 25.0, 1.5, 0.9, 0.8)
    t_fast = t.copy()
    t_fast[32:] *= 0.2
    st_full, lls = tg.fit(31, t, f, batch_size=32, n_iters=10, grid_size=128, device="cpu")
    st_fast, _ = tg.fit(31, t_fast, f, batch_size=32, n_iters=10, grid_size=128, device="cpu")
    assert lls.shape == (2,)
    assert float(st_fast.ng.mu0) < float(st_full.ng.mu0) - 1.0


def test_fit_fleet_and_dag_shapes_and_recovery():
    s, k, n = 2, 3, 96
    rng = np.random.default_rng(5)
    mu = np.linspace(8.0, 30.0, s * k).reshape(s, k, 1)
    f = rng.uniform(0.1, 0.9, (s, k, n)).astype(np.float32)
    t = (f**0.9 * mu + f**0.7 * 0.5 * rng.normal(size=(s, k, n))).astype(np.float32)
    states, ll = tg.fit_dag(0, t, f, n_iters=8, grid_size=64, device="cpu")
    assert ll.shape == (s, k) and states.mu.shape == (s, k)
    assert states.alpha_prior.a.shape == (s, k)
    np.testing.assert_allclose(states.ng.mu0.numpy(), mu[..., 0], rtol=0.15)
    folded = tg.fold_stage_axis(states)
    assert folded.ng.mu0.shape == (s * k,)
    assert torch.equal(tg.unfold_stage_axis(folded, s).ng.mu0, states.ng.mu0)


def test_entry_points_raise_without_a_device():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points would use it")
    f, t = _synth(1, 16, 10.0, 1.0, 0.9, 0.8)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tg.fit(0, t, f)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tg.fit_fleet(0, t[None], f[None])
