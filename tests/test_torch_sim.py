"""Port parity: the Monte-Carlo workflow simulator (``repro_torch.sim``).

The port's simulator samples the reference's generative process from torch
generators, which cannot reproduce threefry streams, so the two simulators
are compared statistically on the same topology, fractions and
parameters: a two-sample Kolmogorov-Smirnov test on 2e5 completion times
each (p > 1e-3), and their means within 4 standard errors of the
difference.  Its normalization of topologies (``topology_spec``) is the
reference's exactly.  ``examples/pipeline_dag_torch.py`` runs end to end
here on the CPU with its three assertions.
"""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from scipy import stats

from repro import sched as js
from repro import sim as jsim
from repro.core import frontier as jf
from repro_torch import sched as ts
from repro_torch import sim
from repro_torch.core import frontier as tf

ROOT = Path(__file__).resolve().parents[1]
T = torch.as_tensor
DIAMOND = ((0, 1), (0, 2), (1, 3), (2, 3))
ANNOTATIONS = dict(exec_probs=(1.0, 0.3, 1.0, 0.7), rework_probs=(0.0, 0.0, 0.4, 0.25),
                   max_retries=(1, 1, 4, 3))


def _case(seed, s=4, k=3):
    rng = np.random.default_rng(seed)
    leaves = [rng.uniform(4, 20, (s, k)), rng.uniform(0.5, 3, (s, k)),
              np.full((s, k), 0.9), np.full((s, k), 0.7)]
    leaves = [x.astype(np.float32) for x in leaves]
    fracs = rng.dirichlet(np.ones(k), size=s).astype(np.float32)
    return fracs, leaves


@pytest.mark.parametrize("topology", ["chain", "diamond", "intree"])
def test_simulator_matches_reference_simulator_in_distribution(topology):
    """The same stochastic workflow through both simulators: the completion
    times agree in distribution and in mean."""
    edges = {"chain": ((0, 1), (1, 2), (2, 3)), "diamond": DIAMOND, "intree": ((0, 2), (1, 2), (2, 3))}
    fracs, leaves = _case(50 + len(topology))
    tdag = ts.WorkflowDAG.from_edges(4, edges[topology], num_workers=3).with_stochastic(**ANNOTATIONS)
    jdag = js.WorkflowDAG.from_edges(4, edges[topology], num_workers=3).with_stochastic(**ANNOTATIONS)
    got = sim.simulate_workflow(7, tdag, fracs, tf.UnitParams(*map(T, leaves)),
                                num_samples=200_000, device="cpu").numpy().astype(np.float64)
    want = np.asarray(jsim.simulate_workflow(jax.random.PRNGKey(7), jdag, jnp.asarray(fracs),
                                             jf.UnitParams(*map(jnp.asarray, leaves)),
                                             num_samples=200_000), np.float64)
    assert got.shape == want.shape == (25 * 8192,)  # rounded up to whole batches
    assert stats.ks_2samp(got, want).pvalue > 1e-3
    se = np.sqrt(got.var() / got.size + want.var() / want.size)
    assert abs(got.mean() - want.mean()) < 4 * se


def test_topology_spec_is_the_references():
    for topo in (((), (0,), (0, 1)),
                 ts.WorkflowDAG.from_edges(4, DIAMOND, num_workers=2).with_stochastic(**ANNOTATIONS),
                 ts.WorkflowDAG.chain(3, 2).with_stochastic(rework_probs=(0.1, 0.0, 0.2))):
        assert sim.topology_spec(topo) == jsim.topology_spec(topo)

    class Bad:
        preds = ((), (0,))
        exec_probs = (1.0,)

    for mod in (sim, jsim):
        with pytest.raises(ValueError, match="one entry per stage"):
            mod.topology_spec(Bad())


def test_simulate_workflow_streams_batches_and_checks_shapes():
    """Samples come in whole batches (the batch bounds the draw tensor); one
    seed gives one stream; fracs must be (S, K)."""
    fracs, leaves = _case(60, s=2, k=2)
    params = tf.UnitParams(*map(T, leaves))
    run = lambda seed, n, b: sim.simulate_workflow(seed, ((), (0,)), fracs, params,
                                                   num_samples=n, batch_size=b, device="cpu")
    assert run(0, 1000, 300).shape == (1200,)
    assert run(0, 100, 8192).shape == (100,)  # one batch of num_samples
    assert torch.equal(run(3, 1000, 250), run(3, 1000, 250))
    assert not torch.equal(run(3, 1000, 250), run(4, 1000, 250))
    with pytest.raises(ValueError, match=r"fracs must be \(S, K\) with S == 1"):
        sim.simulate_workflow(0, ((),), fracs, params, device="cpu")
    e, v = sim.simulate_moments(0, ((), (0,)), fracs, params, num_samples=1000, batch_size=500,
                                device="cpu")
    t = run(0, 1000, 500)
    assert float(e) == float(t.mean()) and float(v) == float(t.var(correction=0))


def test_simulator_floors_are_the_analytic_paths():
    """A worker at a zero share takes the analytic path's floors (f 1e-9,
    std 1e-9): a one-worker stage with no noise is its mean exactly."""
    params = tf.UnitParams.of(mu=[[5.0, 7.0]], sigma=[[0.0, 0.0]])
    fracs = T([[1.0, 0.0]])
    t = sim.simulate_workflow(0, ((),), fracs, params, num_samples=64, device="cpu")
    mean, _ = tf.component_mean_std(fracs, params)
    assert bool((t == mean.max()).all())


def test_simulate_telemetry_matches_the_model():
    """(S, K, N) telemetry: its per-worker mean and spread are the model's
    f^alpha mu and f^beta sigma (within 4 standard errors; sigma is small
    enough here that the floor at 1e-6 never bites), floored at 1e-6;
    ``noise`` scales the spread."""
    s, k, n = 2, 3, 20_000
    fracs, leaves = _case(70, s=s, k=k)
    leaves[1] = leaves[1] / 10.0
    params = tf.UnitParams(*map(T, leaves))
    t = sim.simulate_telemetry(1, fracs, params, num_obs=n, device="cpu")
    assert t.shape == (s, k, n) and bool((t >= 1e-6).all())
    mean, std = tf.component_mean_std(T(fracs), params)
    assert bool(((t.mean(-1) - mean).abs() < 4 * std / n**0.5).all())
    np.testing.assert_allclose(t.std(-1).numpy(), std.numpy(), rtol=0.03)
    wide = sim.simulate_telemetry(1, fracs, params, num_obs=n, noise=2.0, device="cpu")
    np.testing.assert_allclose(wide.std(-1).numpy(), 2.0 * std.numpy(), rtol=0.03)
    tiny = sim.simulate_telemetry(1, [[1e-3]], tf.UnitParams.of([[1e-3]], [[5.0]]), num_obs=64,
                                  device="cpu")
    assert float(tiny.min()) == float(np.float32(1e-6))


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points would use it")
    dag = ts.WorkflowDAG.chain(2, 2)
    params = tf.UnitParams.of(np.ones((2, 2)), np.ones((2, 2)))
    calls = [
        lambda: sim.simulate_workflow(0, dag, np.full((2, 2), 0.5), params),
        lambda: sim.simulate_telemetry(0, np.full((2, 2), 0.5), params),
        lambda: ts.init_dag(ts.SchedulerConfig(), dag),
        lambda: ts.uniform_fractions(dag),
        lambda: dag.with_stage_workers((1, 2)).stage_live(),
    ]
    for call in calls:
        with pytest.raises(RuntimeError, match="device='cpu'"):
            call()


def test_pipeline_dag_example_runs_on_the_cpu():
    """examples/pipeline_dag_torch.py --device cpu: both parts, with the
    reference example's three assertions, at its full sample count."""
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "pipeline_dag_torch.py"), "--device", "cpu"],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    assert "OK: stage-wise Bayesian splits beat uniform splits end-to-end." in proc.stdout
    assert "OK: stochastic-aware splits beat both baselines on the simulator." in proc.stdout
