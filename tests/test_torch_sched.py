"""Port parity: the fraction solver, microbatch quantization, anomaly scores
and straggler flags.

``solve_fractions`` is deterministic given the parameters, so the port is
held to the reference on its objective score (rtol 1e-4: 200 Adam steps
compound float32 gradient noise) and its fractions (atol 1e-3).
Quantization must give equal counts on the reference's own test inputs
(tests/test_quantize.py), up to exact ties between moves.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sched as js
from repro.core.frontier import UnitParams as JUnit
from repro_torch import convert
from repro_torch import sched as ts
from repro_torch.core.frontier import UnitParams as TUnit


def _both(*cols):
    cols = [np.asarray(c, np.float32) for c in cols]
    while len(cols) < 4:
        cols.append(np.ones_like(cols[0]))
    return JUnit(*map(jnp.asarray, cols)), TUnit(*map(torch.as_tensor, cols))


def _random_params(k, seed):
    rng = np.random.default_rng(seed)
    return _both(rng.uniform(5, 40, k), rng.uniform(0.5, 3, k),
                 rng.uniform(0.6, 1.0, k), rng.uniform(0.5, 1.0, k))


SOLVE_CASES = [
    ("k3", lambda: _both([10.0, 20.0, 40.0], [1.0, 2.0, 4.0]), ts.Objective()),
    ("k6_mean_var", lambda: _random_params(6, 1), ts.Objective.mean_var(0.5)),
    ("k16_budget", lambda: _random_params(16, 2), ts.Objective.variance_budget(0.5)),
    ("k8_deadline", lambda: _random_params(8, 3), ts.Objective.deadline_quantile(12.0)),
]


@pytest.mark.parametrize("name,make,objective", SOLVE_CASES, ids=[c[0] for c in SOLVE_CASES])
def test_solve_fractions_matches_reference(name, make, objective):
    jp, tp = make()
    jobj = js.Objective(**vars(objective))
    kw = dict(steps=60, num_points=256)
    want_f, want_s = js.solve_fractions(jp, objective=jobj, **kw)
    got_f, got_s = ts.solve_fractions(tp, objective=objective, **kw)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), atol=1e-3)
    np.testing.assert_allclose(float(got_s.score), float(want_s.score), rtol=1e-4)
    np.testing.assert_allclose(float(got_f.sum()), 1.0, rtol=1e-5)


def _check(counts, total, min_per_worker=1):
    assert counts.sum() == total and (counts >= min_per_worker).all()


def _pairs():
    """(fractions, total, min_per_worker) inputs of tests/test_quantize.py."""
    k = 8
    corner = np.zeros(k)
    corner[0] = 1.0
    spike = np.full(k, 1e-12)
    spike[3] = 1.0 - 7e-12
    cases = [
        (np.array([0.61, 0.29, 0.10]), 16, 1),
        (np.array([0.97, 0.01, 0.01, 0.01]), 12, 2),
        (np.full(16, 1 / 16), 16, 1),
        (np.full(16, 1 / 16), 17, 1),
        (corner, 10, 1),
        (spike, k, 1),
    ]
    rng = np.random.default_rng(0)
    for _ in range(25):
        kk = int(rng.integers(2, 12))
        cases.append((rng.dirichlet(np.full(kk, 0.05)), int(rng.integers(kk, 4 * kk)), 1))
    rng = np.random.default_rng(2)
    for kk, total in ((512, 4096), (2000, 2000), (2000, 6000)):
        cases.append((rng.dirichlet(np.full(kk, 0.3)), total, 1))
    return cases


def test_rounding_gives_reference_counts():
    for fr, total, minw in _pairs():
        want = js.quantize_fractions(fr, total, min_per_worker=minw)
        got = ts.quantize_fractions(fr, total, min_per_worker=minw)
        _check(got, total, minw)
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        ts.quantize_fractions(np.array([0.5, 0.5]), 3, min_per_worker=2)


def test_refinement_gives_reference_counts():
    """The refined inputs of tests/test_quantize.py with K <= 32: the
    exhaustive move sweep."""
    jp, tp = _both([10.0, 20.0, 40.0], [1.0, 2.0, 4.0])
    fr, _ = js.solve_fractions(jp)
    fr = np.asarray(fr)
    np.testing.assert_array_equal(
        ts.quantize_fractions(fr, 8, tp), js.quantize_fractions(fr, 8, jp)
    )
    rng = np.random.default_rng(1)
    k = 6
    jp, tp = _both(rng.uniform(5, 40, k), rng.uniform(0.5, 3, k))
    fr = rng.dirichlet(np.full(k, 0.2))
    for total, minw in ((k, 1), (13, 1), (24, 2)):
        got = ts.quantize_fractions(fr, total, tp, min_per_worker=minw)
        _check(got, total, minw)
        np.testing.assert_array_equal(got, js.quantize_fractions(fr, total, jp, min_per_worker=minw))


def test_slab_refinement_reaches_reference_objective():
    """K = 48 > 32 takes the gradient-ranked slab.  Workers that do not touch
    the max have a gradient of exactly 0, and a unit moved to any of them
    scores the same: such exact ties may go to another worker than in the
    reference, so the slab is held on its objective, which must equal the
    reference's after the same 16 moves from the same rounding."""
    from repro.core.frontier import mean_var_completion
    from repro.sched.quantize import _refine_counts as j_refine
    from repro_torch.sched.quantize import _refine_counts as t_refine

    rng = np.random.default_rng(6)
    k, total = 48, 480
    jp, tp = _both(rng.uniform(5, 50, k), rng.uniform(0.5, 4, k))
    naive = ts.quantize_fractions(rng.dirichlet(np.full(k, 0.5)), total)
    kw = dict(min_per_worker=1, max_moves=16)
    got = t_refine(torch.as_tensor(naive), tp, total, objective=ts.Objective(), **kw).numpy()
    want = np.asarray(j_refine(jnp.asarray(naive), jp, jnp.asarray(total),
                               objective=js.Objective(), **kw))
    _check(got, total)
    e_t = lambda c: float(mean_var_completion(jnp.asarray(c / total, jnp.float32), jp, 192)[0])
    assert e_t(got) < e_t(naive)
    np.testing.assert_allclose(e_t(got), e_t(want), rtol=1e-6)


CFG = dict(n_iters=3, grid_size=32, num_points=64, opt_steps=10)


def _observed_states(k=4, seed=0):
    """A reference state after two observe batches, and its port copy."""
    jcfg = js.SchedulerConfig(**CFG)
    rng = np.random.default_rng(seed)
    state = js.init(jcfg, k, jax.random.PRNGKey(seed))
    mu = np.linspace(5.0, 20.0, k)
    for _ in range(2):
        f = rng.uniform(0.1, 0.5, (k, 16)).astype(np.float32)
        t = (f**0.9 * mu[:, None] + 0.3 * rng.normal(size=(k, 16))).astype(np.float32)
        state, _ = js.observe(state, js.Telemetry(jnp.asarray(f), jnp.asarray(t)), jcfg)
    tree = jax.tree_util.tree_map(np.asarray, state)
    return state, convert.to_scheduler_state(tree, seed=seed, device="cpu")


def test_anomaly_matches_reference():
    jstate, tstate = _observed_states()
    jcfg, tcfg = js.SchedulerConfig(**CFG), ts.SchedulerConfig(**CFG)
    rng = np.random.default_rng(3)
    for _ in range(3):
        times = np.abs(rng.normal(3.0, 0.5, (4, 5))).astype(np.float32)
        times[2] *= 6.0
        fr = np.full((4, 5), 0.25, np.float32)
        jstate, want = js.anomaly(jstate, js.Telemetry(jnp.asarray(fr), jnp.asarray(times)), jcfg)
        tstate, got = ts.anomaly(tstate, ts.Telemetry(torch.as_tensor(fr), torch.as_tensor(times)), tcfg)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    # a failed worker's non-finite telemetry, masked per worker: frozen EWMA
    valid = np.array([True, False, True, True])
    times = np.full(4, 3.0, np.float32)
    times[1] = np.inf
    fr = np.full(4, 0.25, np.float32)
    jstate, want = js.anomaly(jstate, js.Telemetry(jnp.asarray(fr), jnp.asarray(times)),
                              jcfg, jnp.asarray(valid))
    tstate, got = ts.anomaly(tstate, ts.Telemetry(torch.as_tensor(fr), torch.as_tensor(times)),
                             tcfg, torch.as_tensor(valid))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    np.testing.assert_array_equal(tstate.ewma_count.numpy(), np.asarray(jstate.ewma_count))


@pytest.mark.parametrize("scores,valid", [
    ([1.0, 1.1, 0.9, 1.05, 500.0, 500.0], None),  # even count: mean of the middle two
    ([1.0, 1.1, 0.9, 2.5, 500.0, 500.0], [True, True, True, True, False, False]),
    ([1.0, 1.1, 0.9, 2.5, 500.0, 500.0], None),
    ([0.2, 0.4, 0.3, 0.35, 4.0], None),
    ([1.0, 1.2, 1.1, 1.3, 9.0, 1.15, 2.0, 1.05], [True] * 6 + [False, True]),
])
def test_flag_stragglers_matches_reference(scores, valid):
    s = np.asarray(scores, np.float32)
    want = js.flag_stragglers(jnp.asarray(s), 2.0, None if valid is None else jnp.asarray(valid))
    got = ts.flag_stragglers(torch.as_tensor(s), 2.0, None if valid is None else torch.as_tensor(valid))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_even_median_is_the_mean_of_the_middle_pair():
    """Median 2.5 and MAD 1 put the bar at 2.5 + 1.05 * 1.4826 = 4.06: no
    flag.  torch.median's lower middle values (2 and 1) would put it at
    3.56 and flag the 4."""
    s = np.asarray([1.0, 2.0, 3.0, 4.0], np.float32)
    assert not bool(ts.flag_stragglers(torch.as_tensor(s), 1.05).any())
    assert not bool(np.asarray(js.flag_stragglers(jnp.asarray(s), 1.05)).any())


@pytest.mark.parametrize("kind", ["mean", "mean_var", "var_budget", "deadline"])
@pytest.mark.parametrize("masked", [False, True], ids=["full", "live"])
def test_row_batched_solve_equals_one_row_solves(kind, masked):
    """solve_fractions on (S, K) rows, with (S,) per-row overrides and a
    per-row live mask, is S one-row solves run as one (the DAG's stage
    solves): each row's Adam steps are its own, as are its candidate pick
    and its statistics.  Held to float32 evaluation order: fractions within
    1e-6, E[t] and the score within 1e-5 relative, Var within 2e-6 E^2."""
    rng = np.random.default_rng(17)
    s, k = 4, 5
    cols = [rng.uniform(2, 30, (s, k)), rng.uniform(0.2, 3, (s, k)),
            rng.uniform(0.6, 0.95, (s, k)), rng.uniform(0.5, 0.9, (s, k))]
    params = TUnit(*(torch.as_tensor(c.astype(np.float32)) for c in cols))
    live = torch.as_tensor((rng.uniform(size=(s, k)) > 0.3).astype(np.float32)) if masked else None
    if masked:
        live[:, 0] = 1.0
    per_row = torch.as_tensor([0.2, 1.0, 2.0, 0.5])
    objective, overrides = {
        "mean": (ts.Objective.mean(), {}),
        "mean_var": (ts.Objective.mean_var(1.0), dict(risk_aversion=per_row)),
        "var_budget": (ts.Objective.variance_budget(1.0), dict(var_budget=per_row)),
        "deadline": (ts.Objective.deadline_quantile(5.0), dict(deadline=6.0 * per_row + 2.0)),
    }[kind]
    kw = dict(objective=objective, steps=30, num_points=128, min_fraction=1e-3)
    fracs, stats = ts.solve_fractions(params, live=live, **kw, **overrides)
    assert fracs.shape == (s, k) and stats.e_t.shape == (s,)
    for i in range(s):
        row = TUnit(*(x[i] for x in params))
        f_i, st_i = ts.solve_fractions(row, live=None if live is None else live[i], **kw,
                                       **{name: v[i] for name, v in overrides.items()})
        np.testing.assert_allclose(fracs[i].numpy(), f_i.numpy(), atol=1e-6)
        np.testing.assert_allclose(float(stats.e_t[i]), float(st_i.e_t), rtol=1e-5)
        np.testing.assert_allclose(float(stats.score[i]), float(st_i.score), rtol=1e-5)
        assert abs(float(stats.var[i]) - float(st_i.var)) <= 2e-6 * float(st_i.e_t) ** 2
        if live is not None:
            assert bool((fracs[i][live[i] == 0] == 0).all())
