"""Port parity: hierarchical empirical-Bayes pooling (repro_torch.hier) and
the calibrated drift gate (repro_torch.serve.gate).

At float32 tolerance, at fleet states the reference builds and ``convert``
carries over: ``hyper_stats``, ``shrink`` and ``surprise`` (rtol 1e-5:
chains of a few float32 logs, exps and divisions); ``fit_hyperprior``
(masked and not) at rtol 1e-4, because its between-worker variances are
E[x^2] - E[x]^2 in float32, which multiplies the sums' ~1e-7 relative error
by E[x^2] / Var(x) (~135 for this fleet's mu); and ``gate_update``
sequences (fire flags and counts exactly, the EWMA at rtol 1e-6).
Statistically, as tests/test_hier.py: the drifted worker is flagged, the
gate's skip rate does not depend on the fleet size, and a worker admitted
from the fleet hyperprior reaches its oracle share in at most half the
observations of a global-prior admit.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import hier as jh
from repro import sched as js
from repro import serve as jsv
from repro_torch import convert
from repro_torch import hier as th
from repro_torch import sched as ts
from repro_torch import serve as tsv
from repro_torch.core import gibbs as tg
from test_torch_serve import _leaves

JCFG = js.SchedulerConfig(n_iters=3, grid_size=32, num_points=64, opt_steps=30, mu_guess=1.0)
TCFG = ts.SchedulerConfig(n_iters=3, grid_size=32, num_points=64, opt_steps=30, mu_guess=1.0)
TRUE_MU, TRUE_ALPHA = 800.0, 0.9
TOL = dict(rtol=1e-5, atol=1e-6)


def _times(rng, fmat, mu=TRUE_MU):
    return (fmat**TRUE_ALPHA * mu * (1.0 + 0.02 * rng.standard_normal(fmat.shape))).astype(np.float32)


def _explore(rng, k, n=16):
    f = rng.uniform(0.05, 0.9, (k, n)).astype(np.float32)
    return f, _times(rng, f)




def _close(got, want, **tol):
    w = [np.asarray(x) for x in jax.tree_util.tree_leaves(want)]
    g = [x.numpy() for x in _leaves(got)]
    assert len(g) == len(w)
    for a, b in zip(g, w):
        np.testing.assert_allclose(a, b, **(tol or TOL))


@pytest.fixture(scope="module")
def ref_fleet():
    """A reference fleet of 16 identical mu = 800 workers after 4 batches,
    and the port's copy of its posteriors."""
    rng = np.random.default_rng(0)
    s = js.Scheduler(16, config=JCFG, seed=0)
    for _ in range(4):
        f, t = _explore(rng, 16)
        s.observe(js.Telemetry(jnp.asarray(f), jnp.asarray(t)))
    host = jax.tree_util.tree_map(np.asarray, s.state.gibbs)
    return s.state.gibbs, convert.to_gibbs_state(host, "cpu")


@pytest.fixture(scope="module")
def port_fleet():
    """The same converged fleet, learned by the port itself."""
    rng = np.random.default_rng(0)
    s = ts.Scheduler(16, config=TCFG, seed=0, device="cpu")
    for _ in range(8):
        s.observe(ts.Telemetry(*_explore(rng, 16)))
    return s


# ---------------------------------------------------- deterministic parity
@pytest.mark.parametrize("masked", [False, True])
def test_hyper_stats_and_fit_match_reference(ref_fleet, masked):
    jfleet, tfleet = ref_fleet
    mask = (np.arange(16) % 3 != 0).astype(np.float32) if masked else None
    jm = None if mask is None else jnp.asarray(mask)
    tm = None if mask is None else torch.as_tensor(mask)
    _close(th.hyper_stats(tfleet, tm), jh.hyper_stats(jfleet, jm))
    got, want = th.fit_hyperprior(tfleet, tm), jh.fit_hyperprior(jfleet, jm)
    refit = dict(rtol=1e-4, atol=1e-6)  # E[x^2] - E[x]^2 cancellation (module docstring)
    _close(got, want, **refit)
    assert float(got.n_workers) == (mask.sum() if masked else 16.0)
    _close(th.hyper_from_stats(th.hyper_stats(tfleet, tm)), want, **refit)


def test_hyper_init_and_weights_match_reference(ref_fleet):
    jfleet, tfleet = ref_fleet
    _close(th.hyper_init(3.0), jh.hyper_init(3.0), rtol=0, atol=0)
    _close(th.effective_sample_size(tfleet), jh.effective_sample_size(jfleet))
    _close(th.shrinkage_weight(tfleet, 5.0), jh.shrinkage_weight(jfleet, 5.0))


@pytest.mark.parametrize("weight", [None, 0.3, "per_worker"])
def test_shrink_matches_reference(ref_fleet, weight):
    jfleet, tfleet = ref_fleet
    hyper_j = jh.fit_hyperprior(jfleet)
    hyper_t = convert.to_hyperprior(jax.tree_util.tree_map(np.asarray, hyper_j), "cpu")
    if weight == "per_worker":
        weight = np.linspace(0.0, 1.0, 16, dtype=np.float32)
    jw = None if weight is None else jnp.asarray(weight)
    tw = None if weight is None else torch.as_tensor(weight)
    got = th.shrink(tfleet, hyper_t, tw, strength=6.0)
    want = jh.shrink(jfleet, hyper_j, jw, strength=6.0)
    _close(got, want._replace(key=None))


def test_surprise_matches_reference(ref_fleet):
    jfleet, tfleet = ref_fleet
    hyper_j = jh.fit_hyperprior(jfleet)
    hyper_t = convert.to_hyperprior(jax.tree_util.tree_map(np.asarray, hyper_j), "cpu")
    got, want = th.surprise(tfleet, hyper_t), jh.surprise(jfleet, hyper_j)
    # log-densities of order 10: held at rtol 1e-5 of the largest
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5 * float(np.abs(np.asarray(want)).max()))


def test_init_from_hyperprior_takes_the_pool_as_its_priors(ref_fleet):
    jfleet, _ = ref_fleet
    hyper = convert.to_hyperprior(jax.tree_util.tree_map(np.asarray, jh.fit_hyperprior(jfleet)),
                                  "cpu")
    fresh = th.init_from_hyperprior(torch.Generator().manual_seed(0), 3, hyper)
    for got, want in zip(_leaves((fresh.ng, fresh.alpha_prior, fresh.beta_prior)),
                         _leaves((hyper.ng, hyper.alpha_prior, hyper.beta_prior))):
        assert got.shape == (3,) and bool((got == want).all())


def test_shrink_weight_zero_is_bitwise_noop_and_cold_lands_on_pool(port_fleet):
    fleet = port_fleet.state.gibbs
    hyper = th.fit_hyperprior(fleet)
    assert all(torch.equal(a, b) for a, b in zip(_leaves(th.shrink(fleet, hyper, 0.0)),
                                                  _leaves(fleet)))
    cold = ts.init(TCFG, 1, seed=3, device="cpu").gibbs
    assert float(th.shrinkage_weight(cold)[0]) == 1.0
    warm = th.shrink(cold, hyper)
    np.testing.assert_allclose(float(warm.ng.mu0[0]), float(hyper.ng.mu0), rtol=1e-6)
    np.testing.assert_allclose(float(warm.ng.kappa0[0]), float(hyper.ng.kappa0), rtol=1e-5)


def _gate_stats(seed, n=40):
    rng = np.random.default_rng(seed)
    stats = rng.standard_normal(n).astype(np.float32) * 0.1 + 1.0
    stats[[12, 25]] = 9.0  # regime changes
    update = rng.uniform(size=n) > 0.15  # some empty drains
    return stats, update


@pytest.mark.parametrize("kw", [{}, dict(z=2.0, warmup=1, decay=0.7)])
def test_gate_update_sequences_match_reference(kw):
    stats, update = _gate_stats(1)
    j_gate, t_gate = jsv.gate_init(), tsv.gate_init()
    for s, u in zip(stats, update):
        jf, j_gate = jsv.gate_update(j_gate, s, update=bool(u), **kw)
        tf, t_gate = tsv.gate_update(t_gate, torch.as_tensor(s), update=bool(u), **kw)
        assert bool(tf) == bool(jf)
        assert int(t_gate.count) == int(j_gate.count)
        np.testing.assert_allclose(float(t_gate.mean), float(j_gate.mean), rtol=1e-6)
        np.testing.assert_allclose(float(t_gate.var), float(j_gate.var), rtol=1e-6, atol=1e-9)
        np.testing.assert_allclose(float(tsv.gate_threshold(t_gate)), float(jsv.gate_threshold(j_gate)),
                                   rtol=1e-6)
    carried = convert.to_gate_state(jax.tree_util.tree_map(np.asarray, j_gate), "cpu")
    for got, want in zip(carried, j_gate):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# ------------------------------------------------------------- statistics
def test_surprise_flags_the_drifted_worker(port_fleet):
    fleet = port_fleet.state.gibbs
    hyper = th.fit_hyperprior(fleet)
    assert th.surprise(fleet, hyper).shape == (16,)
    mu0 = fleet.ng.mu0.clone()
    mu0[3] *= 4.0  # worker 3 silently became 4x slower
    scores = th.surprise(fleet._replace(ng=fleet.ng._replace(mu0=mu0)), hyper).numpy()
    assert scores.argmax() == 3
    assert scores[3] > np.delete(scores, 3).max() + 1.0


def test_calibrated_gate_skip_rate_stable_across_fleet_sizes():
    """The same gate configuration fires at the same near-zero rate on the
    null at K = 10^2 and 10^4, where a threshold tuned at K = 10^2 fires
    almost always at K = 10^4 (tests/test_hier.py's claim, on the port)."""
    rates = {}
    for k in (100, 10_000):
        rng = np.random.default_rng(0)
        gate, fires, ticks = tsv.gate_init(), 0, 120
        for _ in range(ticks):
            fired, gate = tsv.gate_update(gate, float(rng.standard_normal(k).max()))
            fires += int(fired)
        rates[k] = fires / ticks
    assert abs(rates[100] - rates[10_000]) <= 0.05, rates
    assert max(rates.values()) <= 0.1, rates
    rng = np.random.default_rng(1)
    small = np.array([rng.standard_normal(100).max() for _ in range(120)])
    big = np.array([rng.standard_normal(10_000).max() for _ in range(120)])
    assert (big > np.quantile(small, 0.95)).mean() > 0.5


def _clone(scheduler, **overrides):
    s = ts.Scheduler(1, config=dataclasses.replace(scheduler.config, **overrides), device="cpu")
    s.state = scheduler.state
    return s


def _obs_to_band(scheduler, oracle, rng, n=4, max_cycles=15):
    """Observations the newcomer needs before its fraction is within 10 % of
    its oracle share (0 = born ready)."""
    for cycle in range(max_cycles + 1):
        fr, _, _ = scheduler.propose_fractions()
        if abs(fr[-1] - oracle) <= 0.1 * oracle:
            return cycle * n
        fmat = np.tile(fr.astype(np.float32)[:, None], (1, n))
        scheduler.observe(ts.Telemetry(fmat, _times(rng, fmat)))
    return (max_cycles + 1) * n


def test_cold_start_transfer_halves_observations(port_fleet):
    oracle = 1.0 / 17.0
    pooled = _clone(port_fleet, hierarchical=True)
    pooled.add_workers(1, seed=7)
    pooled_obs = _obs_to_band(pooled, oracle, np.random.default_rng(1))
    legacy = _clone(port_fleet, hierarchical=False)
    legacy.add_workers(1, seed=7)
    legacy_obs = _obs_to_band(legacy, oracle, np.random.default_rng(1))
    assert pooled_obs <= 15 * 4, "pooled admit never reached the band"
    assert legacy_obs > 0, "global-prior admit was born converged"
    assert pooled_obs <= legacy_obs / 2, (pooled_obs, legacy_obs)


def test_scheduler_shrink_pulls_cold_admit_to_its_share(port_fleet):
    s = _clone(port_fleet)
    s.add_workers(1, seed=11)  # global prior: believes it is ~800x faster
    fr_cold, _, _ = s.propose_fractions()
    oracle = 1.0 / 17.0
    assert fr_cold[-1] > 3 * oracle
    s.shrink()
    fr_warm, _, _ = s.propose_fractions()
    assert abs(fr_warm[-1] - oracle) < 0.2 * oracle
    assert s.surprise().shape == (17,)


def test_hierarchical_admit_into_a_capacity_slot_is_born_from_the_pool(port_fleet):
    """admit_workers pools the live slots only, and the newcomer's priors are
    that pool."""
    s = ts.Scheduler(4, config=dataclasses.replace(TCFG, hierarchical=True), seed=0,
                     capacity=6, device="cpu")
    s.state = s.state._replace(gibbs=tg.tree_map(lambda x: x[:6].clone(), port_fleet.state.gibbs))
    hyper = th.fit_hyperprior(s.state.gibbs, s.state.live)
    s.admit_workers(1)
    assert float(s.state.live[4]) == 1.0
    np.testing.assert_allclose(float(s.state.gibbs.ng.mu0[4]), float(hyper.ng.mu0), rtol=1e-6)
