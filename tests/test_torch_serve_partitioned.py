"""``examples/serve_partitioned_torch.py`` on the CPU, and its tail modes
against the reference.

The example runs end to end (reduced tinyllama-1.1b, torch on one thread as
in tests/test_torch_dag.py): the service proposes at least once and skips at
least once, the learned split beats the equal one on the oracle makespan,
and the risk-averse split's variance is no more than the min-mean split's.
Its tail modes on the reference's beliefs: the reference's ``ServiceLoop``
gets the example's config and the same numpy telemetry, and its state,
carried over by ``convert.to_serve_state``, gives the port's ``propose``
the reference's fractions (atol 1e-3) and scores (rtol 1e-4), the
tolerance of tests/test_torch_sched.py's propose parity.
"""
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import sched as js
from repro import serve as jsv
from repro.distributed.simulated_cluster import SimulatedCluster, WorkerSpec
from repro_torch import convert
from repro_torch import sched as ts
from repro_torch.configs import get_arch, reduced

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "examples"))
import serve_partitioned_torch as example  # noqa: E402


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_example_runs_on_the_cpu():
    """The script as a user runs it, ``--device cpu``."""
    proc = subprocess.run(
        [sys.executable, str(ROOT / "examples" / "serve_partitioned_torch.py"), "--device", "cpu"],
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin",
                       "OMP_NUM_THREADS": "1"},
        capture_output=True, text=True, timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    lines = proc.stdout.splitlines()
    assert sum(line.startswith("  ") and "proposed=" in line for line in lines) == example.ROUNDS
    counters = next(line for line in lines if line.startswith("service counters:")).split()
    drains, proposes = int(counters[2]), int(counters[4])
    assert drains == example.ROUNDS and drains > proposes >= 1
    for prefix in ("learned split", "true expected batch latency", "risk-averse split",
                   "deadline("):
        assert any(line.startswith(prefix) for line in lines), prefix


def test_example_learns_the_split_and_its_tail_modes(one_thread):
    out = example.serve_partitioned(reduced(get_arch("tinyllama-1.1b")), "cpu")
    c = out["counters"]
    assert c["drains"] == example.ROUNDS and c["drains"] > c["proposes"] >= 1
    assert c["pushes"] == example.ROUNDS * example.PUSHES and c["dropped"] == 0
    assert out["oracle_learned"] < out["oracle_equal"]
    assert abs(out["fractions"].sum() - 1.0) < 1e-5
    assert all(r["counts"].sum() == example.BATCH for r in out["rounds"])
    # the risk-averse split buys variance: no more than the min-mean split's,
    # the published one and one solved on the same beliefs
    _, same = ts.propose(out["state"], ts.SchedulerConfig(objective=ts.Objective.mean()))
    assert out["risk_var"] <= out["var"] and out["risk_var"] <= float(same.var)
    assert 0.0 < out["deadline_p"] <= 1.0
    for fr in (out["risk_fractions"], out["deadline_fractions"]):
        assert np.isfinite(fr).all() and abs(fr.sum() - 1.0) < 1e-5


def _reference_service():
    """The reference's service on the example's config, its replicas and its
    loop (quantize the published split, push 8 rows, tick) without the model."""
    cluster = SimulatedCluster(
        [WorkerSpec(2.0, 0.2, 0.95, 0.9), WorkerSpec(5.0, 0.8, 0.9, 0.85),
         WorkerSpec(3.0, 0.3, 0.92, 0.88)], seed=0)
    config = jsv.ServeConfig(
        sched=js.SchedulerConfig(objective=js.Objective.mean(), n_iters=12, grid_size=128,
                                 mu_guess=3.0),
        capacity=8, drift_threshold=0.05, max_staleness=6)
    loop = jsv.ServiceLoop(3, config=config, seed=1)
    for _ in range(example.ROUNDS):
        counts = js.quantize_fractions(loop.fractions(), example.BATCH,
                                       js.unit_params(loop.state.sched),
                                       objective=config.sched.objective)
        fracs = counts / counts.sum()
        for _ in range(example.PUSHES):
            loop.push(fracs, cluster.step_times(fracs))
        loop.tick()
        cluster.step_times(fracs)  # the example's latency line draws once more
    return loop


@pytest.mark.parametrize("mode", ["mean_var", "deadline_quantile"])
def test_tail_modes_match_the_reference_on_its_beliefs(mode):
    jloop = _reference_service()
    port = convert.to_serve_state(jax.tree_util.tree_map(np.asarray, jloop.state), seed=1,
                                  device="cpu")
    eps = 1.2 * float(jloop.state.stats.e_t)
    make = dict(mean_var=lambda lib: lib.Objective.mean_var(5.0),
                deadline_quantile=lambda lib: lib.Objective.deadline_quantile(eps))[mode]
    want_f, want_s = js.propose(jloop.state.sched, js.SchedulerConfig(objective=make(js)))
    got_f, got_s = ts.propose(port.sched, ts.SchedulerConfig(objective=make(ts)))
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), atol=1e-3)
    np.testing.assert_allclose(float(got_s.score), float(want_s.score), rtol=1e-4)
    np.testing.assert_allclose(float(got_f.sum()), 1.0, rtol=1e-5)
