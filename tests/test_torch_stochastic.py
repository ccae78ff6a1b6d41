"""Port parity: stochastic workflows, checked by the Monte-Carlo simulator.

Mirrors tests/test_stochastic.py on the port.  Every analytic composition
rule of the stochastic DAG layer (branch mixtures, truncated-geometric
rework counts, compound sums and their composition through the topology) is
held twice: against the reference's analytic moments at the same input
(means 1e-5 relative, variances 2e-6 E^2: float32 evaluation order), and
against the port's own simulator at the reference's tolerances (2e5
samples; the ``slow`` counterparts 1e6).  The simulator draws from torch
generators, not threefry, so it is compared with the reference's only
statistically.  Degenerate annotations (p = 1 branches, zero rework, cap 1)
are the port's deterministic proposal bit for bit.
"""
import dataclasses
import importlib.util
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sched as js
from repro.core import frontier as jf
from repro_torch import sched as ts
from repro_torch import sim
from repro_torch.core import frontier as tf

T = torch.as_tensor
VAR_ULPS = 2e-6
EXAMPLE = Path(__file__).resolve().parents[1] / "examples" / "pipeline_dag_torch.py"


def load_example():
    """examples/pipeline_dag_torch.py as a module."""
    spec = importlib.util.spec_from_file_location("pipeline_dag_torch", EXAMPLE)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _stage_leaves(seed, s, k, mu_lo=4.0, mu_hi=20.0, sig_lo=0.5, sig_hi=3.0):
    """tests/test_stochastic.py's ``_stage_params`` leaves, as numpy."""
    rng = np.random.default_rng(seed)
    return (
        rng.uniform(mu_lo, mu_hi, (s, k)).astype(np.float32),
        rng.uniform(sig_lo, sig_hi, (s, k)).astype(np.float32),
        np.full((s, k), 0.9, np.float32),
        np.full((s, k), 0.7, np.float32),
    )


def _stage_params(seed, s, k, **kw):
    return tf.UnitParams(*map(T, _stage_leaves(seed, s, k, **kw)))


def _analytic_dag_moments(dag, fracs, params, num_points=2048):
    """Per-stage quadrature -> stochastic transforms -> topological reduce."""
    e, v = tf.mean_var_completion(T(fracs), params, num_points)
    e, v = ts.effective_stage_moments(dag, e, v)
    return tf.dag_completion_moments(dag.preds, e, v, num_points=num_points)


def _reference_analytic(dag, fracs, leaves, num_points=2048):
    """The reference's analytic moments of the same DAG (its annotations
    read off the port's dataclass)."""
    jdag = js.WorkflowDAG(preds=dag.preds, num_workers=dag.num_workers,
                          exec_probs=dag.exec_probs, rework_probs=dag.rework_probs,
                          max_retries=dag.max_retries, stage_workers=dag.stage_workers)
    jp = jf.UnitParams(*map(jnp.asarray, leaves))
    e, v = jax.vmap(lambda fr, p: jf.mean_var_completion(fr, p, num_points))(jnp.asarray(fracs), jp)
    e, v = js.effective_stage_moments(jdag, e, v)
    return jf.dag_completion_moments(jdag.preds, e, v, num_points=num_points)


def close_to_reference(got, want, rtol=1e-5):
    (ge, gv), (we, wv) = [[float(x) for x in pair] for pair in (got, want)]
    np.testing.assert_allclose(ge, we, rtol=rtol)
    assert abs(gv - wv) <= VAR_ULPS * we * we, (gv, wv)


def _mc_check(dag, fracs, leaves, num_samples, rtol_mean, rtol_var, seed=0):
    """The port's analytic moments against the reference's and against the
    port's simulator (at the reference's tolerances)."""
    params = tf.UnitParams(*map(T, leaves))
    e_a, v_a = _analytic_dag_moments(dag, fracs, params)
    close_to_reference((e_a, v_a), _reference_analytic(dag, fracs, leaves))
    e_mc, v_mc = sim.simulate_moments(seed, dag, fracs, params, num_samples=num_samples,
                                      device="cpu")
    np.testing.assert_allclose(float(e_a), float(e_mc), rtol=rtol_mean)
    np.testing.assert_allclose(float(v_a), float(v_mc), rtol=rtol_var)


# --------------------------------------------------------------------------
# composition rules vs the reference and the MC oracle
# --------------------------------------------------------------------------
def test_mixture_moments_match_monte_carlo():
    dag = ts.WorkflowDAG.chain(1, 4).with_stochastic(exec_probs=(0.3,))
    _mc_check(dag, np.full((1, 4), 0.25, np.float32), _stage_leaves(1, 1, 4), 200_000, 1e-2, 1e-2,
              seed=11)
    e, v = tf.mixture_moments(T(0.25), T(8.0), T(4.0))
    assert (float(e), float(v)) == (2.0, 13.0)


def test_truncated_geometric_moments_match_monte_carlo():
    """Near-constant unit attempts isolate (E[N], Var[N])."""
    r, cap = 0.45, 5
    dag = ts.WorkflowDAG.chain(1, 2).with_stochastic(rework_probs=(r,), max_retries=(cap,))
    leaves = (np.full((1, 2), 2.0, np.float32), np.full((1, 2), 1e-4, np.float32),
              np.ones((1, 2), np.float32), np.ones((1, 2), np.float32))
    params = tf.UnitParams(*map(T, leaves))
    fracs = np.full((1, 2), 0.5, np.float32)
    n_mean, n_var = tf.truncated_geometric_moments(T(1.0 - r), cap)
    jn_mean, jn_var = jf.truncated_geometric_moments(jnp.float32(1.0 - r), cap)
    np.testing.assert_allclose([float(n_mean), float(n_var)], [float(jn_mean), float(jn_var)], rtol=1e-5)
    t = sim.simulate_workflow(12, dag, fracs, params, num_samples=200_000, device="cpu")
    mu_attempt = float(tf.mean_var_completion(T(fracs[0]), tf.UnitParams(*(x[0] for x in params)), 2048)[0])
    np.testing.assert_allclose(float(n_mean) * mu_attempt, float(t.mean()), rtol=1e-2)
    np.testing.assert_allclose(float(n_var) * mu_attempt**2, float(t.var(correction=0)), rtol=1e-2)


@pytest.mark.parametrize("q", [1.0, 0.7, 0.2])
@pytest.mark.parametrize("cap", [1, 2, 6])
def test_truncated_geometric_degenerate_and_general_match_reference(q, cap):
    """E[N] = 1 and Var[N] = 0 exactly at q = 1 or R = 1 (the pmf's n == cap
    edge); otherwise the reference's moments at 1e-5, with a per-stage cap
    tuple on a wider static support too."""
    e_n, v_n = tf.truncated_geometric_moments(T(q), cap)
    if q == 1.0 or cap == 1:
        assert float(e_n) == 1.0 and float(v_n) == 0.0
    je, jv = jf.truncated_geometric_moments(jnp.float32(q), cap)
    np.testing.assert_allclose([float(e_n), float(v_n)], [float(je), float(jv)], rtol=1e-5, atol=1e-7)
    caps = (cap, 4, 1)
    got = tf.truncated_geometric_moments(T([q, 0.5, 0.3]), caps)
    want = jf.truncated_geometric_moments(jnp.asarray([q, 0.5, 0.3], jnp.float32), caps)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-7)


def test_compound_sum_moments_match_monte_carlo():
    dag = ts.WorkflowDAG.chain(1, 4).with_stochastic(rework_probs=(0.35,), max_retries=(6,))
    _mc_check(dag, np.full((1, 4), 0.25, np.float32), _stage_leaves(3, 1, 4), 200_000, 1e-2, 1e-2,
              seed=13)
    e, v = tf.compound_sum_moments(T(2.0), T(2.0), T(3.0), T(0.5))
    assert (float(e), float(v)) == (6.0, 19.0)


def test_stochastic_stage_moments_match_monte_carlo():
    dag = ts.WorkflowDAG.chain(1, 4).with_stochastic(
        exec_probs=(0.6,), rework_probs=(0.3,), max_retries=(4,))
    _mc_check(dag, np.full((1, 4), 0.25, np.float32), _stage_leaves(4, 1, 4), 200_000, 1e-2, 1e-2,
              seed=14)


def test_stochastic_chain_matches_monte_carlo():
    dag = ts.WorkflowDAG.chain(4, 4).with_stochastic(
        exec_probs=(1.0, 0.4, 1.0, 0.8), rework_probs=(0.0, 0.0, 0.5, 0.2), max_retries=(1, 1, 5, 3))
    _mc_check(dag, np.full((4, 4), 0.25, np.float32), _stage_leaves(5, 4, 4), 200_000, 1e-2, 1e-2,
              seed=15)


def test_stochastic_join_matches_monte_carlo():
    """An in-tree join of two independent stochastic branches, then a tail:
    the PERT max on effective moments."""
    dag = ts.WorkflowDAG(preds=((), (), (0, 1), (2,)), num_workers=4).with_stochastic(
        exec_probs=(1.0, 0.5, 1.0, 1.0), rework_probs=(0.3, 0.0, 0.0, 0.25), max_retries=(4, 1, 1, 3))
    _mc_check(dag, np.full((4, 4), 0.25, np.float32), _stage_leaves(6, 4, 4), 200_000, 1e-2, 5e-2,
              seed=16)


@pytest.mark.slow
@pytest.mark.parametrize(
    "exec_probs,rework_probs,max_retries",
    [
        ((0.3, 1.0, 1.0, 1.0), None, None),
        (None, (0.0, 0.45, 0.0, 0.2), (1, 6, 1, 3)),
        ((1.0, 0.4, 0.7, 1.0), (0.0, 0.0, 0.5, 0.3), (1, 1, 5, 4)),
    ],
)
def test_stochastic_chain_monte_carlo_high_sample(exec_probs, rework_probs, max_retries):
    dag = ts.WorkflowDAG.chain(4, 4).with_stochastic(
        exec_probs=exec_probs, rework_probs=rework_probs, max_retries=max_retries)
    _mc_check(dag, np.full((4, 4), 0.25, np.float32), _stage_leaves(7, 4, 4), 1_000_000, 1e-2, 1e-2,
              seed=17)


# --------------------------------------------------------------------------
# degenerate annotations are bitwise the deterministic path
# --------------------------------------------------------------------------
_REG = dict(n_iters=4, grid_size=64, mu_guess=10.0, opt_steps=60, num_points=256)
_REG_CFG = ts.SchedulerConfig(**_REG)


def _learned_state(dag, cfg, seed=0):
    s, k = dag.num_stages, dag.num_workers
    params = _stage_params(seed + 300, s, k)
    state = ts.init_dag(cfg, dag, seed=seed, device="cpu")
    fracs = torch.full((s, k, 32), 1.0 / k)
    times = sim.simulate_telemetry(seed + 1, fracs[..., 0], params, num_obs=32, device="cpu")
    state, _ = ts.observe_dag(state, ts.Telemetry(fracs=fracs, times=times), cfg)
    return state


@pytest.mark.parametrize(
    "objective",
    [ts.Objective.mean(), ts.Objective.mean_var(1.5), ts.Objective.variance_budget(0.5),
     ts.Objective.deadline_quantile(12.0)],
    ids=["mean", "mean_var", "var_budget", "deadline"],
)
def test_degenerate_annotations_propose_bitwise(objective):
    """p = 1.0 branches and zero rework are the deterministic proposal, leaf
    for leaf: the stochastic machinery is routed around, not evaluated and
    cancelled."""
    plain = ts.WorkflowDAG.from_edges(4, ((0, 1), (0, 2), (1, 3), (2, 3)), num_workers=3)
    degenerate = plain.with_stochastic(
        exec_probs=(1.0,) * 4, rework_probs=(0.0,) * 4, max_retries=(1,) * 4)
    capped = plain.with_stochastic(rework_probs=(0.3,) * 4, max_retries=(1,) * 4)
    assert not degenerate.is_stochastic and not capped.is_stochastic
    cfg = dataclasses.replace(_REG_CFG, objective=objective)
    state = _learned_state(plain, cfg)
    f_plain, st_plain = ts.propose_dag(state, plain, cfg)
    for dag in (degenerate, capped):
        f_degen, st_degen = ts.propose_dag(state, dag, cfg)
        assert torch.equal(f_plain, f_degen)
        for a, b in zip(st_plain, st_degen):
            assert torch.equal(a, b)


def test_degenerate_effective_moments_are_identity():
    dag = ts.WorkflowDAG.chain(3, 2).with_stochastic(
        exec_probs=(1.0, 1.0, 1.0), rework_probs=(0.0, 0.0, 0.0))
    e, v = T([1.0, 2.0, 3.0]), T([0.1, 0.2, 0.3])
    ee, vv = ts.effective_stage_moments(dag, e, v)
    assert ee is e and vv is v  # passthrough: the same tensors, not equal values


# --------------------------------------------------------------------------
# stochastic-aware allocation beats blind allocation
# --------------------------------------------------------------------------
def _acceptance_gaps(num_samples):
    """tests/test_stochastic.py's fixture, which is
    examples/pipeline_dag_torch.py's diamond: the simulator prices the
    three proposals on one sampled world (common random numbers)."""
    dag, dag_sto, true, cfg = load_example().diamond_fixture("cpu")
    state = ts.init_dag(cfg, dag, seed=0, device="cpu")
    f_det, _ = ts.propose_dag(state, dag, cfg, params=true)
    f_sto, _ = ts.propose_dag(state, dag_sto, cfg, params=true)
    f_uni = ts.uniform_fractions(dag, "cpu")
    price = lambda f: sim.simulate_workflow(42, dag_sto, f, true, num_samples=num_samples,
                                            device="cpu")
    t_det, t_sto, t_uni = price(f_det), price(f_sto), price(f_uni)
    return float((t_det - t_sto).mean()), float((t_uni - t_sto).mean())


def test_stochastic_aware_propose_beats_deterministic_and_uniform():
    gap_det, gap_uni = _acceptance_gaps(200_000)
    assert gap_det > 0.01, f"det-assumption gap {gap_det:.4f} not positive"
    assert gap_uni > 0.5, f"uniform gap {gap_uni:.4f} not positive"


@pytest.mark.slow
def test_stochastic_aware_propose_beats_baselines_high_sample():
    gap_det, gap_uni = _acceptance_gaps(1_000_000)
    assert gap_det > 0.02
    assert gap_uni > 0.5


# --------------------------------------------------------------------------
# per-stage objectives
# --------------------------------------------------------------------------
def test_per_stage_objectives_solve_each_stage_locally():
    dag = ts.WorkflowDAG.chain(3, 4)
    state = _learned_state(dag, _REG_CFG, seed=7)
    f_mean, _ = ts.propose_dag(state, dag, _REG_CFG)
    params = ts.stage_params(state)
    take = lambda i: tf.UnitParams(*(x[i] for x in params))
    f_minv, _ = ts.propose_dag(state, dag, _REG_CFG, objectives=(
        ts.Objective.mean(), ts.Objective.variance_budget(1e-8), ts.Objective.mean()))
    _, v1_min = tf.mean_var_completion(f_minv[1], take(1), 512)
    _, v1_mean = tf.mean_var_completion(f_mean[1], take(1), 512)
    budget = 0.5 * (float(v1_min) + float(v1_mean))
    objs = (ts.Objective.mean(), ts.Objective.variance_budget(budget), ts.Objective.mean())
    f_mixed, _ = ts.propose_dag(state, dag, _REG_CFG, objectives=objs)
    np.testing.assert_allclose(f_mixed.sum(-1).numpy(), 1.0, atol=1e-5)
    assert torch.equal(f_mixed[0], f_mean[0]) and torch.equal(f_mixed[2], f_mean[2])
    _, v1 = tf.mean_var_completion(f_mixed[1], take(1), 512)
    assert float(v1) <= budget * 1.05
    assert float(v1) <= float(v1_mean) + 1e-6


def test_per_stage_objectives_broadcast_matches_shared_mean():
    dag = ts.WorkflowDAG.chain(3, 4)
    state = _learned_state(dag, _REG_CFG, seed=8)
    f_shared, _ = ts.propose_dag(state, dag, _REG_CFG)
    f_bcast, _ = ts.propose_dag(state, dag, _REG_CFG, objectives=(ts.Objective.mean(),) * 3)
    assert torch.equal(f_shared, f_bcast)


def test_per_stage_objectives_validate_length_and_type():
    dag = ts.WorkflowDAG.chain(3, 4)
    state = _learned_state(dag, _REG_CFG, seed=9)
    with pytest.raises(ValueError, match="need one objective per stage"):
        ts.propose_dag(state, dag, _REG_CFG, objectives=(ts.Objective.mean(),) * 2)
    with pytest.raises(TypeError):
        ts.as_stage_objectives(("mean", "mean", "mean"), 3)


# --------------------------------------------------------------------------
# heterogeneous per-stage widths (pad + mask)
# --------------------------------------------------------------------------
def test_heterogeneous_widths_dead_columns_exactly_zero():
    dag = ts.WorkflowDAG.chain(3, 4).with_stage_workers((2, 3, 4))
    state = _learned_state(dag, _REG_CFG, seed=10)
    live = dag.stage_live("cpu").numpy()
    np.testing.assert_array_equal(live, [[1, 1, 0, 0], [1, 1, 1, 0], [1, 1, 1, 1]])
    np.testing.assert_array_equal(live, np.asarray(js.WorkflowDAG.chain(3, 4).with_stage_workers(
        (2, 3, 4)).stage_live()))
    for objective in (ts.Objective.mean(), ts.Objective.mean_var(1.0)):
        fracs, _ = ts.propose_dag(state, dag, dataclasses.replace(_REG_CFG, objective=objective))
        assert np.all(fracs.numpy()[live == 0] == 0.0)  # exactly, not ~0
        np.testing.assert_allclose(fracs.sum(-1).numpy(), 1.0, atol=1e-5)
    f_uni = ts.uniform_fractions(dag, "cpu").numpy()
    np.testing.assert_allclose(f_uni[0], [0.5, 0.5, 0.0, 0.0])
    np.testing.assert_allclose(f_uni[1, :3], 1.0 / 3, atol=1e-6)


def test_heterogeneous_widths_observe_masks_dead_columns():
    """Whatever a padded column carries leaves its parked posterior as it
    was: two observes differing only in dead-column junk, from states with
    identically seeded generators, are bitwise equal."""
    dag = ts.WorkflowDAG.chain(2, 3).with_stage_workers((1, 3))
    rng = np.random.default_rng(3)
    f = rng.uniform(0.1, 0.9, (2, 3, 16)).astype(np.float32)
    t = rng.uniform(1.0, 9.0, (2, 3, 16)).astype(np.float32)
    t_junk = t.copy()
    t_junk[0, 1:] = 1e6  # dead columns of stage 0
    runs = []
    for times in (t, t_junk):
        state = ts.init_dag(_REG_CFG, dag, seed=3, device="cpu")
        runs.append(ts.observe_dag(state, ts.Telemetry(fracs=T(f), times=T(times)), _REG_CFG, dag=dag))
    (s1, ll1), (s2, ll2) = runs
    for a, b in zip(torch.utils._pytree.tree_leaves(s1.gibbs), torch.utils._pytree.tree_leaves(s2.gibbs)):
        assert torch.equal(a, b)
    assert torch.equal(ll1, ll2)


def test_quantize_dag_fractions_respects_widths_and_totals():
    """Per-stage totals kept, dead columns exactly 0, live ones >= 1; the
    counts are the reference's."""
    dag = ts.WorkflowDAG.chain(3, 4).with_stage_workers((2, 3, 4))
    live = dag.stage_live("cpu").numpy()
    rng = np.random.default_rng(4)
    fracs = rng.dirichlet(np.ones(4), size=3) * live
    fracs /= fracs.sum(-1, keepdims=True)
    counts = ts.quantize_dag_fractions(fracs, (12, 16, 20), live=live > 0)
    np.testing.assert_array_equal(counts.sum(-1), [12, 16, 20])
    assert np.all(counts[live == 0] == 0) and np.all(counts[live > 0] >= 1)
    np.testing.assert_array_equal(counts, js.quantize_dag_fractions(fracs, (12, 16, 20), live=live > 0))


def test_quantize_dag_fractions_refines_each_stage_as_quantize_fractions():
    """With params, each row is quantize_fractions on that stage's
    parameters and objective (per-stage objectives included); a shared
    total, and a bad total or shape, behave as the reference's."""
    params = _stage_params(40, 3, 5)
    fracs = np.random.default_rng(40).dirichlet(np.ones(5), size=3)
    objs = (ts.Objective.mean(), ts.Objective.mean_var(0.5), ts.Objective.variance_budget(2.0))
    counts = ts.quantize_dag_fractions(fracs, 30, params, objectives=objs, refine_passes=1)
    for i in range(3):
        row = ts.quantize_fractions(fracs[i], 30, tf.UnitParams(*(x[i] for x in params)),
                                    objective=objs[i], refine_passes=1)
        np.testing.assert_array_equal(counts[i], row)
    with pytest.raises(ValueError, match="one microbatch total per stage"):
        ts.quantize_dag_fractions(fracs, (30, 30))
    with pytest.raises(ValueError, match=r"expected \(S, K\) fractions"):
        ts.quantize_dag_fractions(fracs[0], 30)


# --------------------------------------------------------------------------
# simulator self-checks
# --------------------------------------------------------------------------
def test_simulator_degenerate_chain_matches_serial_moments():
    dag = ts.WorkflowDAG.chain(3, 4)
    _mc_check(dag, np.full((3, 4), 0.25, np.float32), _stage_leaves(20, 3, 4), 200_000, 1e-2, 1e-2,
              seed=21)


def test_simulator_skipped_stage_contributes_zero():
    """exec_prob = 0 removes the stage's duration but keeps its edges."""
    skip = ts.WorkflowDAG.chain(3, 2).with_stochastic(exec_probs=(1.0, 0.0, 1.0))
    params = _stage_params(22, 3, 2)
    fracs = torch.full((3, 2), 0.5)
    e_skip, _ = sim.simulate_moments(23, skip, fracs, params, num_samples=100_000, device="cpu")
    take = lambda x: x[[0, 2]]
    e_two, _ = sim.simulate_moments(24, ts.WorkflowDAG.chain(2, 2), fracs[:2],
                                    tf.UnitParams(*map(take, params)), num_samples=100_000,
                                    device="cpu")
    np.testing.assert_allclose(float(e_skip), float(e_two), rtol=1.5e-2)


def test_simulator_zero_rework_is_single_attempt():
    """r = 0 takes exactly one attempt (the inverse-CDF edge case)."""
    dag = ts.WorkflowDAG.chain(1, 2)
    annotated = dag.with_stochastic(rework_probs=(0.0,), max_retries=(5,))
    params = _stage_params(25, 1, 2)
    fracs = torch.full((1, 2), 0.5)
    t_plain = sim.simulate_workflow(26, dag, fracs, params, num_samples=8192, device="cpu")
    t_ann = sim.simulate_workflow(26, annotated, fracs, params, num_samples=8192, device="cpu")
    np.testing.assert_allclose(float(t_ann.mean()), float(t_plain.mean()), rtol=2e-2)


def test_simulate_telemetry_feeds_estimator():
    """Telemetry from the true parameters drives the posterior means toward
    them (within the reference's 15 %)."""
    dag = ts.WorkflowDAG.chain(2, 3)
    true = _stage_params(27, 2, 3, sig_lo=0.2, sig_hi=0.5)
    cfg = dataclasses.replace(_REG_CFG, n_iters=6)
    state = ts.init_dag(cfg, dag, seed=5, device="cpu")
    rng = np.random.default_rng(27)
    fr = T(rng.uniform(0.05, 0.95, (96, 2, 3)).astype(np.float32))
    times = sim.simulate_telemetry(6, fr, true, num_obs=1, device="cpu")
    assert times.shape == (96, 2, 3, 1) and bool((times > 0).all())
    state, _ = ts.observe_dag(state, ts.Telemetry(fracs=fr.permute(1, 2, 0),
                                                  times=times[..., 0].permute(1, 2, 0)), cfg)
    np.testing.assert_allclose(state.gibbs.ng.mu0.numpy(), true.mu.numpy(), rtol=0.15)


def test_dag_stats_on_stochastic_dag_reports_effective_contributions():
    dag = ts.WorkflowDAG.chain(2, 3)
    dag_half = dag.with_stochastic(exec_probs=(0.5, 1.0))
    params = _stage_params(28, 2, 3)
    fracs = torch.full((2, 3), 1.0 / 3)
    st_det = ts.dag_stats(dag, fracs, params)
    st_half = ts.dag_stats(dag_half, fracs, params)
    np.testing.assert_allclose(float(st_half.stage_e[0]), 0.5 * float(st_det.stage_e[0]), rtol=1e-6)
    np.testing.assert_allclose(float(st_half.stage_e[1]), float(st_det.stage_e[1]), rtol=1e-6)
    assert float(st_half.e_t) < float(st_det.e_t)
    jd = js.WorkflowDAG.chain(2, 3).with_stochastic(exec_probs=(0.5, 1.0))
    want = js.dag_stats(jd, jnp.full((2, 3), 1.0 / 3), jf.UnitParams(*map(jnp.asarray, _stage_leaves(28, 2, 3))))
    close_to_reference((st_half.e_t, st_half.var), (want.e_t, want.var))
