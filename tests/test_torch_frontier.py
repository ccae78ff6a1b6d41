"""Port parity: completion-time moments, the two-way frontier, objectives.

The same numpy parameters go through ``repro.core.frontier`` /
``repro.sched.objectives`` (JAX on the CPU) and their ``repro_torch``
counterparts, held at rtol 1e-5 (float32 evaluation-order noise; the port
forms the product of CDFs as exp(sum log CDF)).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import frontier as jf
from repro.sched import objectives as jo
from repro.sched.scheduler import _equalizing_fractions as j_equalizing
from repro_torch.core import frontier as tf
from repro_torch.sched import objectives as to
from repro_torch.sched.scheduler import _equalizing_fractions as t_equalizing

RTOL = 1e-5
# Var = E[t^2] - E[t]^2 cancels: it is held absolutely, at 2e-6 E[t]^2
# (about 16 float32 ulps of the E[t^2] it is cancelled against).
VAR_ULPS = 2e-6


def _params(k, seed):
    rng = np.random.default_rng(seed)
    cols = [rng.uniform(5, 40, k), rng.uniform(0.5, 3, k),
            rng.uniform(0.6, 1.0, k), rng.uniform(0.5, 1.0, k)]
    cols = [c.astype(np.float32) for c in cols]
    return (jf.UnitParams(*map(jnp.asarray, cols)),
            tf.UnitParams(*map(torch.as_tensor, cols)))


def _fracs(k, seed):
    return np.random.default_rng(seed).dirichlet(np.full(k, 2.0)).astype(np.float32)


def _close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol, atol=atol)


def _close_moments(got, want):
    """(E, Var) pairs: E at RTOL, Var at VAR_ULPS * E^2."""
    e_want = np.asarray(want[0], np.float64)
    _close(got[0], want[0])
    np.testing.assert_array_less(
        np.abs(np.asarray(got[1], np.float64) - np.asarray(want[1], np.float64)),
        VAR_ULPS * e_want**2 + 1e-12,
    )


@pytest.mark.parametrize("k", [2, 7, 64])
def test_completion_moments_match_reference(k):
    jp, tp = _params(k, k)
    fr = _fracs(k, k + 1)
    for g_, w_ in zip(tf.component_mean_std(torch.as_tensor(fr), tp),
                      jf.component_mean_std(jnp.asarray(fr), jp)):
        _close(g_, w_)
    eps = np.linspace(0.0, 40.0, 33, dtype=np.float32)
    # a probability: held absolutely as well
    _close(tf.completion_cdf(torch.as_tensor(eps), torch.as_tensor(fr), tp),
           jf.completion_cdf(jnp.asarray(eps), jnp.asarray(fr), jp), atol=1e-6)
    _close_moments(tf.mean_var_completion(torch.as_tensor(fr), tp, 512),
                   jf.mean_var_completion(jnp.asarray(fr), jp, 512))


def test_batched_fractions_match_row_by_row():
    _, tp = _params(5, 3)
    fr = np.stack([_fracs(5, s) for s in range(4)])
    e, v = tf.mean_var_completion(torch.as_tensor(fr), tp, 256)
    for i in range(4):
        e_i, v_i = tf.mean_var_completion(torch.as_tensor(fr[i]), tp, 256)
        _close(e[i], e_i, rtol=1e-6)
        _close(v[i], v_i, rtol=1e-6)


def test_two_way_sweep_frontier_and_optimum_match_reference():
    cols = [np.asarray(x, np.float32) for x in ([30.0, 20.0], [2.0, 6.0], [0.92, 0.88], [0.85, 0.8])]
    jp = jf.UnitParams(*map(jnp.asarray, cols))
    tp = tf.UnitParams(*map(torch.as_tensor, cols))
    got = tf.sweep_two_way(tp, num_f=101)
    want = jf.sweep_two_way(jp, num_f=101)
    _close(got[0], want[0])
    _close_moments(got[1:], want[1:])
    np.testing.assert_array_equal(
        tf.pareto_mask(got[1], got[2]).numpy(), np.asarray(jf.pareto_mask(want[1], want[2]))
    )
    for obj, kw in [("mean", {}), ("mean_var", dict(risk_aversion=1.0)),
                    ("constrained", dict(var_budget=6.0))]:
        g3 = tf.optimal_two_way_fraction(tp, objective=obj, **kw)
        w3 = jf.optimal_two_way_fraction(jp, objective=obj, **kw)
        _close(g3[0], w3[0])
        _close_moments(g3[1:], w3[1:])
    g3 = tf.optimal_two_way_fraction(tp, objective=to.Objective.deadline_quantile(22.0))
    w3 = jf.optimal_two_way_fraction(jp, objective=jo.Objective.deadline_quantile(22.0))
    _close(g3[0], w3[0])


OBJECTIVES = [
    ("mean", {}),
    ("mean_var", dict(risk_aversion=0.5)),
    ("var_budget", dict(var_budget=0.3)),
    ("deadline", dict(deadline=9.0)),
]


@pytest.mark.parametrize("smooth", [False, True])
@pytest.mark.parametrize("kind,kw", OBJECTIVES)
def test_evaluate_matches_reference(kind, kw, smooth):
    jp, tp = _params(6, 11)
    fr = _fracs(6, 12)
    want = jo.evaluate(jo.Objective(kind=kind, **kw), jnp.asarray(fr), jp,
                       num_points=256, smooth=smooth)
    got = to.evaluate(to.Objective(kind=kind, **kw), torch.as_tensor(fr), tp,
                      num_points=256, smooth=smooth)
    _close(got, want)


@pytest.mark.parametrize("k", [3, 16, 200])
def test_equalizing_fractions_match_reference(k):
    jp, tp = _params(k, 20 + k)
    _close(t_equalizing(tp), j_equalizing(jp))


def test_objective_gradient_matches_reference_at_tiny_shares():
    """Workers with a tiny share and a tight spread put the CDF's argument at
    about -6e5 at eps = 0, where torch.special.log_ndtr's own derivative is
    NaN; the solver's gradient must still equal the reference's."""
    cols = [np.asarray(x, np.float32) for x in (
        [20.0, 5.0, 30.0, 8.0, 12.0, 40.0], [0.5, 1e-3, 2.0, 1e-3, 1.0, 3.0],
        [0.9, 0.1, 0.8, 0.15, 0.7, 0.6], [0.8, 0.9, 0.6, 0.95, 0.5, 0.7])]
    fr = np.asarray([0.4, 1e-9, 0.3, 1e-8, 0.2, 0.1], np.float32)
    fr /= fr.sum()
    jp = jf.UnitParams(*map(jnp.asarray, cols))
    tp = tf.UnitParams(*map(torch.as_tensor, cols))
    want = jax.grad(
        lambda f: jo.evaluate(jo.Objective(), f, jp, num_points=256, smooth=True)
    )(jnp.asarray(fr))
    x = torch.as_tensor(fr).requires_grad_(True)
    (got,) = torch.autograd.grad(
        to.evaluate(to.Objective(), x, tp, num_points=256, smooth=True), x
    )
    assert torch.isfinite(got).all()
    _close(got, want)
