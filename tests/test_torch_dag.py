"""Port parity: stage-structured workflow DAGs (``repro_torch.sched.dag``).

Mirrors tests/test_dag.py: the topology, stacked (S, K, N) estimation, the
serial / parallel composition of completion moments and stage-wise
partitioning.  The deterministic sub-steps are held against the reference
at a fixed input, each at its stated tolerance: the composition transforms
(means 1e-5 relative; a variance, which cancels E[t^2] - E[t]^2 in float32,
absolutely at 2e-6 E^2, as tests/test_torch_frontier.py holds it),
``path_lengths`` (exact), ``dag_stats`` and ``propose_dag(params=...)`` from
a state carried over by ``convert.to_dag_state`` for every objective kind
and per-stage objectives (fractions within 1e-4 after the Adam steps,
means and scores within 1e-4 relative, variances within 2e-5 E^2).
Sampled parts (``observe_dag``, ``fit_dag``) are checked statistically, as
the reference checks them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sched as js
from repro.core import frontier as jf
from repro.core import moments as jm
from repro_torch import convert, kernels
from repro_torch import sched as ts
from repro_torch.core import frontier as tf
from repro_torch.core import gibbs as tg
from repro_torch.core.moments import BetaParams, exponent_grid
from repro_torch.kernels import ops
from test_torch_moments import assert_logp_close

S, K, N = 3, 4, 48


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Run the module's torch work on one thread.  The suite runs in several
    worker processes, and torch's CPU pool takes a thread per core in each:
    oversubscribed, the pools' threads wait on each other.  On an 8-core
    machine, six processes of test_torch_dag_fleet.py's stochastic case took
    696-698 s each for the port's propose_dag on eight threads, 8.6-11.2 s
    on one (5.4 s alone on eight)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


TCFG = ts.SchedulerConfig(n_iters=6, grid_size=64, mu_guess=15.0, opt_steps=60)  # tests/test_dag.py's
DIAMOND = ((0, 1), (0, 2), (1, 3), (2, 3))
T = torch.as_tensor


def _pipeline_telemetry(seed=0, n=N, true_mu=None):
    """Synthetic (S, K, N) numpy telemetry for a 3-stage x 4-worker pipeline
    (tests/test_dag.py's)."""
    rng = np.random.default_rng(seed)
    if true_mu is None:
        true_mu = rng.uniform(5.0, 30.0, (S, K)).astype(np.float32)
    f = rng.uniform(0.05, 0.95, (S, K, n)).astype(np.float32)
    t = np.maximum(f**0.9 * true_mu[..., None] + 0.3 * rng.normal(size=(S, K, n)), 1e-3)
    return t.astype(np.float32), f, true_mu


def _telem(t, f):
    return ts.Telemetry(fracs=T(f), times=T(t))


def _leaves(tree):
    """The tensors of a nested NamedTuple state, flattened, in order."""
    if isinstance(tree, torch.Tensor):
        return [tree.reshape(-1)]
    return [x for part in tree for x in _leaves(part)]


VAR_ULPS = 2e-6  # tests/test_torch_frontier.py's: about 16 float32 ulps of E[t^2]


def _close_moments(got, want, var_ulps=VAR_ULPS, rtol=1e-5):
    """(E, Var): E within ``rtol``, Var within ``var_ulps`` E^2."""
    (ge, gv), (we, wv) = [[np.asarray(x, np.float64) for x in pair] for pair in (got, want)]
    np.testing.assert_allclose(ge, we, rtol=rtol)
    np.testing.assert_array_less(np.abs(gv - wv), var_ulps * we**2 + 1e-12)


# --------------------------------------------------------------------------
# topology
# --------------------------------------------------------------------------
def test_dag_validates_topological_numbering():
    for pkg in (js, ts):
        with pytest.raises(ValueError, match="numbered topologically"):
            pkg.WorkflowDAG(preds=((1,), ()), num_workers=2)  # pred >= index
        with pytest.raises(ValueError, match="numbered topologically"):
            pkg.WorkflowDAG(preds=((0,), ()), num_workers=2)  # self-loop
    chain = ts.WorkflowDAG.chain(4, 3)
    assert chain.num_stages == 4 and chain.is_chain and chain.sinks == (3,)
    assert chain == ts.WorkflowDAG.chain(4, 3) and hash(chain) == hash(ts.WorkflowDAG.chain(4, 3))


@pytest.mark.parametrize("bad,match", [
    (dict(num_workers=0), "num_workers must be >= 1"),
    (dict(names=("a",)), "names must match num_stages"),
    (dict(exec_probs=(1.0,)), "exec_probs must have one entry per stage"),
    (dict(exec_probs=(1.0, 1.5)), r"exec_probs entries must lie in \[0, 1\]"),
    (dict(rework_probs=(0.0, 1.0)), "rework_probs must be < 1"),
    (dict(max_retries=(2, 2)), "max_retries without rework_probs is meaningless"),
    (dict(rework_probs=(0.1, 0.1), max_retries=(2,)), "max_retries must have one entry per stage"),
    (dict(rework_probs=(0.1, 0.1), max_retries=(2, 0)), "max_retries entries must be >= 1"),
    (dict(stage_workers=(1,)), "stage_workers must have one entry per stage"),
    (dict(stage_workers=(1, 4)), r"stage_workers entries must lie in \[1, num_workers\]"),
])
def test_dag_validation_errors_are_the_references(bad, match):
    kw = dict(preds=((), (0,)), num_workers=3) | bad
    for pkg in (js, ts):
        with pytest.raises(ValueError, match=match):
            pkg.WorkflowDAG(**kw)


def test_dag_from_edges_diamond():
    dag = ts.WorkflowDAG.from_edges(4, DIAMOND, num_workers=2)
    assert dag.preds == js.WorkflowDAG.from_edges(4, DIAMOND, num_workers=2).preds
    assert dag.preds == ((), (0,), (0,), (1, 2))
    assert not dag.is_chain
    assert dag.sinks == (3,)
    assert dag.succs(0) == (1, 2)
    sto = dag.with_stochastic(rework_probs=(0.0, 0.2, 0.0, 0.0))
    assert sto.max_retries == (8,) * 4 and sto.is_stochastic  # the reference's default cap


def test_critical_path_lengths():
    dag = ts.WorkflowDAG.from_edges(4, DIAMOND, num_workers=2)
    means = np.asarray([1.0, 5.0, 2.0, 1.0], np.float32)
    through, crit = ts.path_lengths(dag, T(means))
    np.testing.assert_allclose(through.numpy(), [7.0, 7.0, 4.0, 7.0])
    assert float(crit) == 7.0
    jd = js.WorkflowDAG.from_edges(4, DIAMOND, num_workers=2)
    for seed in range(3):
        m = np.random.default_rng(seed).uniform(0.5, 9.0, 4).astype(np.float32)
        want, want_c = js.path_lengths(jd, jnp.asarray(m))
        got, got_c = ts.path_lengths(dag, T(m))
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        assert float(got_c) == float(want_c)


# --------------------------------------------------------------------------
# stacked estimation
# --------------------------------------------------------------------------
def test_stacked_estimation_matches_per_stage_calls():
    """Folding the stage axis into the fleet axis changes nothing: K1's
    stacked (S, K, N) entry equals S per-stage calls bitwise, and one
    ``gibbs_batch`` over the folded (S*K,) fleet equals the same program on
    (S, K) leaves, draw for draw (one generator, the same stream)."""
    t, f, _ = _pipeline_telemetry(seed=1)
    rng = np.random.default_rng(1)
    mu, lam = T(rng.uniform(5, 25, (S, K)).astype(np.float32)), T(rng.uniform(0.5, 2, (S, K)).astype(np.float32))
    a, b = torch.full((S, K), 0.8), torch.full((S, K), 0.7)
    prior = BetaParams(torch.full((S, K), 2.0), torch.full((S, K), 3.0))
    grid = exponent_grid(64)
    stacked = ops.posterior_grid_fleet(grid, T(t), T(f), mu, lam, a, b, prior, prior, symmetric_grid=True)
    for si in range(S):
        row = lambda x: x[si]
        per_stage = ops.posterior_grid_fleet(
            grid, T(t[si]), T(f[si]), mu[si], lam[si], a[si], b[si],
            BetaParams(*map(row, prior)), BetaParams(*map(row, prior)), symmetric_grid=True,
        )
        assert torch.equal(stacked[si], per_stage)

    seeded = lambda: torch.Generator().manual_seed(5)
    flat = tg.init_state(seeded(), shape=(S * K,))
    gen = seeded()
    tg.init_state(gen, shape=(S * K,))
    folded, ll_folded = tg.gibbs_batch(flat, T(t).reshape(S * K, N), T(f).reshape(S * K, N),
                                       generator=gen, n_iters=5, grid_size=64)
    gen = seeded()
    tg.init_state(gen, shape=(S * K,))
    unfolded, ll_unfolded = tg.gibbs_batch(tg.unfold_stage_axis(flat, S), T(t), T(f),
                                           generator=gen, n_iters=5, grid_size=64)
    for x, y in zip(_leaves(unfolded), _leaves(folded), strict=True):
        assert torch.equal(x, y)
    assert torch.equal(ll_unfolded.reshape(-1), ll_folded)


def test_fit_dag_recovers_stage_parameters():
    """One fit_dag call estimates the whole pipeline; both packages' posterior
    means land within the reference's 25 % of the truth."""
    t, f, true_mu = _pipeline_telemetry(seed=2, n=96)
    states, ll = tg.fit_dag(0, t, f, n_iters=8, grid_size=96, device="cpu")
    assert states.mu.shape == (S, K) and ll.shape == (S, K)
    np.testing.assert_allclose(states.ng.mu0.numpy(), true_mu, rtol=0.25)
    from repro.core import gibbs as jg

    ref, _ = jg.fit_dag(jax.random.PRNGKey(0), jnp.asarray(t), jnp.asarray(f), n_iters=8, grid_size=96)
    np.testing.assert_allclose(states.ng.mu0.numpy(), np.asarray(ref.ng.mu0), rtol=0.25)


def test_fit_dag_matches_fit_fleet_on_folded_axes():
    """fit_dag == fit_fleet on the stage-folded telemetry (same seed)."""
    t, f, _ = _pipeline_telemetry(seed=3)
    st_dag, ll_dag = tg.fit_dag(9, t, f, n_iters=5, grid_size=64, device="cpu")
    st_fleet, ll_fleet = tg.fit_fleet(9, t.reshape(S * K, N), f.reshape(S * K, N),
                                      n_iters=5, grid_size=64, device="cpu")
    for a, b in zip(_leaves(st_dag), _leaves(st_fleet), strict=True):
        assert torch.equal(a, b)
    assert torch.equal(ll_dag.reshape(-1), ll_fleet)


def test_fit_dag_kernel_block_matches_pallas():
    """The folded (S*K, N) block that each of fit_dag's sweeps sends to K1,
    through the stacked entry, against the reference's Pallas kernel in
    interpret mode (as tests/test_kernels.py runs it), both modes; on the
    CPU the wrapper takes the plain version and launches nothing."""
    from repro.kernels.posterior_grid import posterior_grid_fleet_pallas

    t, f, _ = _pipeline_telemetry(seed=4)
    rng = np.random.default_rng(4)
    per = lambda lo, hi: rng.uniform(lo, hi, (S, K)).astype(np.float32)
    mu, lam, a, b = per(5, 25), per(0.1, 2), per(0.6, 0.95), per(0.5, 0.9)
    pa, pb = (per(1.5, 4), per(2, 3)), (per(2, 5), per(1.5, 2.5))
    mask = (rng.uniform(size=(S, K, N)) > 0.1).astype(np.float32)
    grid = np.asarray(exponent_grid(64))
    before = kernels.launch_counts()
    for sym in (True, False):
        got = ops.posterior_grid_fleet(T(grid), T(t), T(f), T(mu), T(lam), T(a), T(b),
                                       BetaParams(*map(T, pa)), BetaParams(*map(T, pb)), T(mask),
                                       symmetric_grid=sym)
        J = lambda x: jnp.asarray(x).reshape(S * K, *np.shape(x)[2:])
        want = posterior_grid_fleet_pallas(
            jnp.asarray(grid), J(t), J(f), J(mask), J(mu), J(lam), J(a), J(b),
            *map(J, pa), *map(J, pb), interpret=True, block_g=64, block_n=256,
        )
        assert got.shape == (S, K, 2, 64)
        assert_logp_close(got.reshape(S * K, 2, 64).numpy(), want)
    assert kernels.launch_counts() == before


def test_observe_dag_advances():
    t, f, _ = _pipeline_telemetry(seed=5)
    dag = ts.WorkflowDAG.chain(S, K)
    state = ts.init_dag(TCFG, dag, seed=1, device="cpu")
    assert state.gibbs.mu.shape == (S, K)
    state2, ll = ts.observe_dag(state, _telem(t, f), TCFG)
    assert int(state2.step) == 1
    assert ll.shape == (S, K) and bool(torch.isfinite(ll).all())


def test_observe_dag_is_advance_fleet_on_the_folded_block():
    """observe_dag is one advance_fleet over the S*K folded fleet with the
    DAG's generator (bitwise), and the dead columns of narrow stages enter
    its mask."""
    t, f, _ = _pipeline_telemetry(seed=6)
    dag = ts.WorkflowDAG.chain(S, K).with_stage_workers((2, 4, 3))
    state = ts.init_dag(TCFG, dag, seed=3, device="cpu")
    got, ll = ts.observe_dag(state, _telem(t, f), TCFG, dag=dag)
    again = ts.init_dag(TCFG, dag, seed=3, device="cpu")
    live = dag.stage_live("cpu")[:, :, None].expand(S, K, N).reshape(S * K, N)
    fleet, ll_fleet = ts.advance_fleet(tg.fold_stage_axis(again.gibbs), T(t).reshape(S * K, N),
                                       T(f).reshape(S * K, N), TCFG, again.generator, mask=live)
    for a, b in zip(_leaves(got.gibbs), _leaves(fleet), strict=True):
        assert torch.equal(a, b)
    assert torch.equal(ll.reshape(-1), ll_fleet)


# --------------------------------------------------------------------------
# composition
# --------------------------------------------------------------------------
def _stage_params(rng, lo=(8.0, 0.5), hi=(25.0, 2.0)):
    mu = rng.uniform(lo[0], hi[0], (S, K)).astype(np.float32)
    sig = rng.uniform(lo[1], hi[1], (S, K)).astype(np.float32)
    return mu, sig


def test_chain_moments_match_reference_and_monte_carlo():
    """Chain-composed (E, Var) against the reference's (1e-5 relative), and
    against Monte Carlo of summed stage makespans at the reference's 1e-2
    (mean) and 5e-2 (variance)."""
    rng = np.random.default_rng(7)
    mu, sig = _stage_params(rng)
    fracs = np.full((S, K), 1.0 / K, np.float32)
    tp = tf.UnitParams.of(mu, sig)
    stage_e, stage_v = tf.mean_var_completion(T(fracs), tp, 2048)
    e_chain, v_chain = tf.serial_moments(stage_e, stage_v)
    jp = jf.UnitParams.of(mu, sig)
    je, jv = jax.vmap(lambda fr, p: jf.mean_var_completion(fr, p, 2048))(jnp.asarray(fracs), jp)
    _close_moments((e_chain, v_chain), jf.serial_moments(je, jv))

    n_mc = 400_000
    total = np.zeros(n_mc)
    for si in range(S):
        mean, std = tf.component_mean_std(T(fracs[si]), tf.UnitParams(*(x[si] for x in tp)))
        total += rng.normal(mean.numpy(), std.numpy(), size=(n_mc, K)).max(axis=1)
    np.testing.assert_allclose(float(e_chain), total.mean(), rtol=1e-2)
    np.testing.assert_allclose(float(v_chain), total.var(), rtol=5e-2)


def test_parallel_max_moments_match_reference_and_monte_carlo():
    rng = np.random.default_rng(8)
    means = np.asarray([10.0, 12.0, 9.0], np.float32)
    variances = np.asarray([4.0, 1.0, 9.0], np.float32)
    e_q, v_q = tf.parallel_max_moments(T(means), T(variances), 2048)
    _close_moments((e_q, v_q), jf.parallel_max_moments(jnp.asarray(means), jnp.asarray(variances), 2048))
    draws = rng.normal(means, np.sqrt(variances), size=(400_000, 3)).max(axis=1)
    np.testing.assert_allclose(float(e_q), draws.mean(), rtol=1e-2)
    np.testing.assert_allclose(float(v_q), draws.var(), rtol=5e-2)


def test_dag_moments_chain_reduces_to_serial_sum():
    preds = ts.WorkflowDAG.chain(S, K).preds
    stage_e, stage_v = T([3.0, 5.0, 2.0]), T([0.5, 0.2, 0.1])
    e_dag, v_dag = tf.dag_completion_moments(preds, stage_e, stage_v)
    np.testing.assert_allclose(float(e_dag), 10.0, rtol=1e-6)
    np.testing.assert_allclose(float(v_dag), 0.8, rtol=1e-6)
    e_s, v_s = tf.serial_moments(stage_e, stage_v)
    assert float(e_dag) == float(e_s)


def test_dag_moments_diamond_matches_reference_and_monte_carlo():
    """Fork/join, end to end = t0 + max(t1, t2) + t3: the reduction against
    the reference's (1e-5 relative) and against Monte Carlo as the reference
    checks it (PERT independence, conservative on the mean)."""
    preds = ts.WorkflowDAG.from_edges(4, DIAMOND, num_workers=2).preds
    stage_e = np.asarray([4.0, 6.0, 5.0, 3.0], np.float32)
    stage_v = np.asarray([0.4, 1.0, 2.0, 0.3], np.float32)
    e_dag, v_dag = tf.dag_completion_moments(preds, T(stage_e), T(stage_v), num_points=2048)
    _close_moments((e_dag, v_dag), jf.dag_completion_moments(
        preds, jnp.asarray(stage_e), jnp.asarray(stage_v), num_points=2048))
    rng = np.random.default_rng(9)
    n_mc = 400_000
    t_s = rng.normal(stage_e, np.sqrt(stage_v), size=(n_mc, 4))
    total = t_s[:, 0] + np.maximum(t_s[:, 1], t_s[:, 2]) + t_s[:, 3]
    np.testing.assert_allclose(float(e_dag), total.mean(), rtol=1e-2)
    fin1 = rng.normal(stage_e[0] + stage_e[1], np.sqrt(stage_v[0] + stage_v[1]), n_mc)
    fin2 = rng.normal(stage_e[0] + stage_e[2], np.sqrt(stage_v[0] + stage_v[2]), n_mc)
    pert = np.maximum(fin1, fin2) + t_s[:, 3]
    np.testing.assert_allclose(float(e_dag), pert.mean(), rtol=1e-2)
    np.testing.assert_allclose(float(v_dag), pert.var(), rtol=5e-2)
    assert float(e_dag) >= total.mean() - 0.05


# --------------------------------------------------------------------------
# partitioning
# --------------------------------------------------------------------------
def _true_params(true_mu, sigma=1.0, alpha=0.9, beta=0.9):
    full = lambda v: np.full((S, K), v, np.float32)
    return tf.UnitParams.of(true_mu, full(sigma), full(alpha), full(beta))


def test_propose_dag_beats_uniform_end_to_end():
    """Stage-wise splits learned by the port beat uniform splits end to end
    at the true parameters, and every stage shifts work to its fastest
    worker (tests/test_dag.py's acceptance)."""
    rng = np.random.default_rng(10)
    true_mu = np.stack([rng.permutation([4.0, 8.0, 16.0, 24.0]) for _ in range(S)]).astype(np.float32)
    t, f, _ = _pipeline_telemetry(seed=10, n=96, true_mu=true_mu)
    dag = ts.WorkflowDAG.chain(S, K)
    state = ts.init_dag(TCFG, dag, seed=3, device="cpu")
    for _ in range(3):
        state, _ = ts.observe_dag(state, _telem(t, f), TCFG)
    fracs, stats = ts.propose_dag(state, dag, TCFG)
    assert fracs.shape == (S, K)
    np.testing.assert_allclose(fracs.sum(-1).numpy(), 1.0, atol=1e-5)
    true_params = _true_params(true_mu)
    e_bayes = ts.dag_stats(dag, fracs, true_params).e_t
    e_uni = ts.dag_stats(dag, ts.uniform_fractions(dag, "cpu"), true_params).e_t
    assert float(e_bayes) < float(e_uni)
    for si in range(S):
        assert float(fracs[si, np.argmin(true_mu[si])]) > float(fracs[si, np.argmax(true_mu[si])])


def test_propose_dag_var_budget_allocates_across_stages():
    """A feasible end-to-end variance budget is met by the stage-wise
    allocation, paying expected time against the unconstrained optimum."""
    t, f, _ = _pipeline_telemetry(seed=11, n=96)
    dag = ts.WorkflowDAG.chain(S, K)
    state = ts.init_dag(TCFG, dag, seed=4, device="cpu")
    for _ in range(2):
        state, _ = ts.observe_dag(state, _telem(t, f), TCFG)
    _, st_mean = ts.propose_dag(state, dag, TCFG)
    cfg0 = dataclasses.replace(TCFG, objective=ts.Objective.variance_budget(1e-8))
    _, st_min = ts.propose_dag(state, dag, cfg0)
    budget = 0.5 * (float(st_min.var) + float(st_mean.var))
    cfg_b = dataclasses.replace(TCFG, objective=ts.Objective.variance_budget(budget))
    _, st_b = ts.propose_dag(state, dag, cfg_b)
    assert float(st_b.var) <= budget * 1.01
    assert float(st_b.e_t) >= float(st_mean.e_t) - 1e-5


def test_propose_dag_critical_path_spends_risk_where_it_hurts():
    rng = np.random.default_rng(12)
    true_mu = np.stack([[5.0, 10.0], [40.0, 60.0], [4.0, 6.0], [5.0, 8.0]]).astype(np.float32)
    dag = ts.WorkflowDAG.from_edges(4, DIAMOND, num_workers=2)
    f = rng.uniform(0.05, 0.95, (4, 2, 96)).astype(np.float32)
    t = np.maximum(f**0.9 * true_mu[..., None] + 0.5 * rng.normal(size=(4, 2, 96)), 1e-3).astype(np.float32)
    cfg = dataclasses.replace(TCFG, objective=ts.Objective.mean_var(2.0))
    state = ts.init_dag(cfg, dag, seed=6, device="cpu")
    for _ in range(2):
        state, _ = ts.observe_dag(state, _telem(t, f), cfg)
    _, st_cp = ts.propose_dag(state, dag, cfg, critical_path_aware=True)
    _, st_flat = ts.propose_dag(state, dag, cfg, critical_path_aware=False)
    assert float(st_cp.e_t) <= float(st_flat.e_t) + 1e-3
    assert np.isfinite(float(st_cp.var)) and np.isfinite(float(st_flat.var))


def test_propose_dag_deadline_lower_bound_is_valid():
    t, f, _ = _pipeline_telemetry(seed=13, n=96)
    dag = ts.WorkflowDAG.chain(S, K)
    state = ts.init_dag(TCFG, dag, seed=8, device="cpu")
    for _ in range(2):
        state, _ = ts.observe_dag(state, _telem(t, f), TCFG)
    _, st_mean = ts.propose_dag(state, dag, TCFG)
    cfg_d = dataclasses.replace(TCFG, objective=ts.Objective.deadline_quantile(1.15 * float(st_mean.e_t)))
    fr_d, st_d = ts.propose_dag(state, dag, cfg_d)
    np.testing.assert_allclose(fr_d.sum(-1).numpy(), 1.0, atol=1e-5)
    assert -1.0 - 1e-6 <= float(st_d.score) <= 0.0


def test_kernel_reshape_shim_folds_stage_axes():
    """ops.posterior_grid_fleet takes stacked (S, K, N) blocks and matches the
    reference's unified oracle on every stage (the reference's 2e-4)."""
    t, f, _ = _pipeline_telemetry(seed=14, n=32)
    rng = np.random.default_rng(14)
    mu = rng.uniform(5, 25, (S, K)).astype(np.float32)
    lam = rng.uniform(0.5, 2.0, (S, K)).astype(np.float32)
    alpha, beta = np.full((S, K), 0.8, np.float32), np.full((S, K), 0.7, np.float32)
    two = np.full((S, K), 2.0, np.float32)
    grid = np.asarray(exponent_grid(64))
    out = ops.posterior_grid_fleet(T(grid), T(t), T(f), T(mu), T(lam), T(alpha), T(beta),
                                   BetaParams(T(two), T(two)), BetaParams(T(two), T(two)))
    assert out.shape == (S, K, 2, 64)
    J = jnp.asarray
    prior = jm.BetaParams(J(two), J(two))
    oracle = jm.log_posterior_grid(J(grid), J(t), J(f), J(mu), J(lam), J(alpha), J(beta), prior, prior)
    np.testing.assert_allclose(out.numpy(), np.asarray(oracle), rtol=2e-4, atol=2e-4)


# --------------------------------------------------------------------------
# deterministic parity: the same beliefs through both packages
# --------------------------------------------------------------------------
OBJECTIVES = {
    "mean": ("mean",),
    "mean_var": ("mean_var", 1.5),
    "var_budget": ("variance_budget", 0.5),
    "deadline": ("deadline_quantile", 12.0),
}
PROPOSE_CFG = dict(opt_steps=60, num_points=256, n_iters=4, grid_size=64, mu_guess=10.0)


def _objective(pkg, name):
    kind, *args = OBJECTIVES[name]
    return getattr(pkg.Objective, kind)(*args)


def _diamond_case(stochastic, widths=None, k=3):
    dags = []
    for pkg in (js, ts):
        dag = pkg.WorkflowDAG.from_edges(4, DIAMOND, num_workers=k)
        if stochastic:
            dag = dag.with_stochastic(exec_probs=(1.0, 0.3, 1.0, 0.8),
                                      rework_probs=(0.0, 0.2, 0.4, 0.0), max_retries=(1, 3, 4, 1))
        if widths is not None:
            dag = dag.with_stage_workers(widths)
        dags.append(dag)
    rng = np.random.default_rng(31)
    leaves = [rng.uniform(4, 20, (4, k)), rng.uniform(0.5, 3, (4, k)),
              rng.uniform(0.7, 0.95, (4, k)), rng.uniform(0.5, 0.8, (4, k))]
    leaves = [x.astype(np.float32) for x in leaves]
    return dags, jf.UnitParams(*map(jnp.asarray, leaves)), tf.UnitParams(*map(T, leaves))


def _carried_state(jdag, jcfg):
    """A reference DagState after one observe, and the port's copy of it."""
    state = js.init_dag(jcfg, jdag, jax.random.PRNGKey(0))
    rng = np.random.default_rng(32)
    s, k = jdag.num_stages, jdag.num_workers
    f = rng.uniform(0.1, 0.9, (s, k, 24)).astype(np.float32)
    t = (f**0.9 * rng.uniform(4, 20, (s, k, 1)) + 0.3 * rng.normal(size=f.shape)).astype(np.float32)
    state, _ = js.observe_dag(state, js.Telemetry(jnp.asarray(f), jnp.asarray(t)), jcfg, dag=jdag)
    return state, convert.to_dag_state(jax.tree_util.tree_map(np.asarray, state), seed=0, device="cpu")


def _assert_proposals_close(got, want):
    (gf, gs), (wf, ws) = got, want
    np.testing.assert_allclose(gf.numpy(), np.asarray(wf), atol=1e-4)
    _assert_stats_close(gs, ws, rtol=1e-4, var_ulps=2e-5)


def _assert_stats_close(got, want, rtol, var_ulps):
    for e, v in (("stage_e", "stage_var"), ("e_t", "var")):
        _close_moments((getattr(got, e), getattr(got, v)), (getattr(want, e), getattr(want, v)),
                       var_ulps=var_ulps, rtol=rtol)
    np.testing.assert_allclose(got.score.numpy(), np.asarray(want.score), rtol=rtol)


@pytest.mark.parametrize("stochastic", [False, True], ids=["deterministic", "stochastic"])
@pytest.mark.parametrize("objective", list(OBJECTIVES))
def test_propose_dag_with_params_matches_reference(objective, stochastic):
    """propose_dag under params= on a state carried over by to_dag_state:
    the whole allocation (presolve, criticality, budget or deadline slices,
    the batched stage solves, the joint refinement on a stochastic DAG) is
    deterministic, so it is held to the reference: fractions within 1e-4,
    statistics within 1e-4 relative."""
    (jdag, tdag), jp, tp = _diamond_case(stochastic)
    jcfg = js.SchedulerConfig(objective=_objective(js, objective), **PROPOSE_CFG)
    tcfg = ts.SchedulerConfig(objective=_objective(ts, objective), **PROPOSE_CFG)
    jstate, tstate = _carried_state(jdag, jcfg)
    assert int(tstate.step) == 1 and tstate.gibbs.mu.shape == (4, 3)
    _assert_proposals_close(ts.propose_dag(tstate, tdag, tcfg, params=tp),
                            js.propose_dag(jstate, jdag, jcfg, params=jp))


def test_propose_dag_from_carried_beliefs_matches_reference():
    """Without params=, both packages read the same carried-over posterior
    means (stage_params) and propose alike; narrow stages get exactly 0."""
    (jdag, tdag), _, _ = _diamond_case(True, widths=(3, 2, 3, 1))
    jcfg = js.SchedulerConfig(objective=_objective(js, "mean_var"), **PROPOSE_CFG)
    tcfg = ts.SchedulerConfig(objective=_objective(ts, "mean_var"), **PROPOSE_CFG)
    jstate, tstate = _carried_state(jdag, jcfg)
    for a, b in zip(ts.stage_params(tstate), js.stage_params(jstate)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
    got = ts.propose_dag(tstate, tdag, tcfg)
    _assert_proposals_close(got, js.propose_dag(jstate, jdag, jcfg))
    assert (got[0][tdag.stage_live("cpu") == 0] == 0).all()


@pytest.mark.parametrize("stochastic", [False, True], ids=["deterministic", "stochastic"])
def test_propose_dag_per_stage_objectives_match_reference(stochastic):
    """The per-stage objectives branch: one objective of every kind, and two
    stages sharing one, against the reference."""
    (jdag, tdag), jp, tp = _diamond_case(stochastic)
    objs = lambda pkg: (pkg.Objective.mean(), pkg.Objective.variance_budget(0.4),
                        pkg.Objective.mean_var(1.0), pkg.Objective.variance_budget(0.4))
    tcfg = ts.SchedulerConfig(**PROPOSE_CFG)
    jcfg = js.SchedulerConfig(**PROPOSE_CFG)
    jstate, tstate = _carried_state(jdag, jcfg)
    _assert_proposals_close(ts.propose_dag(tstate, tdag, tcfg, params=tp, objectives=objs(ts)),
                            js.propose_dag(jstate, jdag, jcfg, params=jp, objectives=objs(js)))
    deadline = lambda pkg: (pkg.Objective.deadline_quantile(9.0),) * 4
    _assert_proposals_close(ts.propose_dag(tstate, tdag, tcfg, params=tp, objectives=deadline(ts)),
                            js.propose_dag(jstate, jdag, jcfg, params=jp, objectives=deadline(js)))


@pytest.mark.parametrize("objective", list(OBJECTIVES))
def test_dag_stats_matches_reference(objective):
    (jdag, tdag), jp, tp = _diamond_case(True, widths=(3, 3, 2, 3))
    fr = np.random.default_rng(33).dirichlet(np.ones(3), size=4).astype(np.float32)
    fr = fr * np.asarray(jdag.stage_live())
    fr = fr / fr.sum(-1, keepdims=True)
    got = ts.dag_stats(tdag, T(fr), tp, _objective(ts, objective), num_points=512)
    want = js.dag_stats(jdag, jnp.asarray(fr), jp, _objective(js, objective), num_points=512)
    _assert_stats_close(got, want, rtol=1e-5, var_ulps=VAR_ULPS)


def test_attempt_var_budget_and_effective_moments_match_reference():
    from repro.sched import dag as jdag_mod
    from repro_torch.sched import dag as tdag_mod

    (jdag, tdag), _, _ = _diamond_case(True)
    rng = np.random.default_rng(34)
    e, v, b = (rng.uniform(1, 9, 4).astype(np.float32) for _ in range(3))
    got = ts.effective_stage_moments(tdag, T(e), T(v))
    want = js.effective_stage_moments(jdag, jnp.asarray(e), jnp.asarray(v))
    for a, w in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-5)
    p, n_mean, n_var = tdag_mod._stochastic_factors(tdag, "cpu")
    for a, w in zip((p, n_mean, n_var), jdag_mod._stochastic_factors(jdag)):
        np.testing.assert_allclose(a.numpy(), np.asarray(w), rtol=1e-5, atol=1e-7)
    got_b = tdag_mod._attempt_var_budget(T(b), T(e), p, n_mean, n_var)
    want_b = jdag_mod._attempt_var_budget(jnp.asarray(b), jnp.asarray(e),
                                          *jdag_mod._stochastic_factors(jdag))
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), rtol=1e-5)
