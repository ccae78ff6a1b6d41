"""The legacy partitioner API on the port (``repro_torch.sched.compat`` and
its deprecated import paths) against the reference's
(``repro.sched.compat``).

``optimize_fractions`` is deterministic given the parameters: held at
``tests/test_torch_sched.py``'s solver tolerances (atol 1e-3 on the
fractions, rtol 1e-4 on E[t]).  The legacy ``quantize_fractions`` must give
the reference's counts on tie-free inputs.  The reference's own
``tests/test_partitioner.py`` runs on the port, its slow online-learning
scenario included (a few seconds on one thread).
"""
import subprocess
import sys
import warnings
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.frontier import UnitParams as JUnit
from repro.sched import compat as jc
from repro_torch.core.frontier import UnitParams, mean_var_completion
from repro_torch.sched import Objective
from repro_torch.sched import compat as tc

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True)
def one_thread():
    """Six xdist workers with a thread per core each oversubscribe the CPU."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _params(k, seed):
    rng = np.random.default_rng(seed)
    cols = [rng.uniform(5, 40, k), rng.uniform(0.5, 3, k), rng.uniform(0.6, 1.0, k),
            rng.uniform(0.5, 1.0, k)]
    cols = [np.asarray(c, np.float32) for c in cols]
    return JUnit(*map(jnp.asarray, cols)), UnitParams(*map(torch.as_tensor, cols))


def _partitioner(*args, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return tc.HeterogeneityAwarePartitioner(*args, device="cpu", **kw)


@pytest.mark.parametrize("k,seed,ra", [(3, 0, 0.0), (6, 1, 0.0), (6, 2, 0.5)])
def test_optimize_fractions_matches_reference(k, seed, ra):
    jp, tp = _params(k, seed)
    want_f, want_e, want_v = jc.optimize_fractions(jp, risk_aversion=ra)
    got_f, got_e, got_v = tc.optimize_fractions(tp, risk_aversion=ra)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), atol=1e-3)
    np.testing.assert_allclose(float(got_e), float(want_e), rtol=1e-4)
    assert isinstance(got_v, torch.Tensor) and got_v.device == tp.mu.device


@pytest.mark.parametrize("with_params,ra", [(False, 0.0), (True, 0.0), (True, 2.0)])
def test_legacy_quantize_matches_reference_counts(with_params, ra):
    """Positional ``risk_aversion``, as legacy callers pass it; random
    fractions and parameters, so no two moves tie."""
    rng = np.random.default_rng(7)
    k, total = 8, 48
    fracs = rng.dirichlet(np.ones(k))
    jp, tp = _params(k, 11)
    want = jc.quantize_fractions(fracs, total, jp if with_params else None, ra)
    got = tc.quantize_fractions(fracs, total, tp if with_params else None, ra)
    np.testing.assert_array_equal(got, np.asarray(want))
    assert got.sum() == total and (got >= 1).all()


# --- tests/test_partitioner.py on the port ---------------------------------
def test_faster_worker_gets_more_work():
    p = UnitParams.of([10.0, 30.0], [1.0, 1.0])
    fr, e, v = tc.optimize_fractions(p)
    assert float(fr[0]) > float(fr[1])  # unit 0 is 3x faster
    e_eq, _ = mean_var_completion(torch.tensor([0.5, 0.5]), p)
    assert float(e) < float(e_eq)


def test_optimizer_near_closed_form_linear_case():
    """alpha = beta = 1, no variance aversion: f_k proportional to 1/mu_k."""
    mus = [8.0, 16.0, 32.0]
    p = UnitParams.of(mus, [0.01, 0.01, 0.01])
    fr, _, _ = tc.optimize_fractions(p)
    inv = np.array([1 / m for m in mus])
    np.testing.assert_allclose(fr.numpy(), inv / inv.sum(), atol=0.02)


def test_quantize_sums_and_bounds():
    counts = tc.quantize_fractions(np.array([0.61, 0.29, 0.10]), 16)
    assert counts.sum() == 16
    assert (counts >= 1).all()
    assert counts[0] > counts[1] > counts[2]


def test_quantize_refinement_improves_objective():
    p = UnitParams.of([10.0, 20.0, 40.0], [1.0, 2.0, 4.0])
    fr, _, _ = tc.optimize_fractions(p)
    counts = tc.quantize_fractions(fr.numpy(), 8, p)
    naive = np.array([3, 3, 2])

    def obj(c):
        e, _ = mean_var_completion(torch.as_tensor(c / 8.0, dtype=torch.float32), p)
        return float(e)

    assert obj(counts) <= obj(naive) + 1e-6


def test_online_partitioner_learns_and_rebalances():
    rng = np.random.default_rng(0)
    true_mu = np.array([5.0, 20.0])  # worker 0 is 4x faster
    part = _partitioner(2, seed=0, n_iters=10, grid_size=128, mu_guess=10.0)
    for _ in range(6):
        fracs = np.tile(part.propose_fractions()[0][:, None], (1, 32))
        times = np.stack([
            np.maximum(f**0.9 * m + 0.5 * rng.normal(size=32), 1e-3)
            for f, m in zip(fracs, true_mu)
        ])
        part.observe(tc.WorkerTelemetry(torch.as_tensor(fracs), torch.as_tensor(times)))
    fr, e, v = part.propose_fractions()
    assert fr[0] > 0.6  # the fast worker carries most of the load
    counts = part.propose_microbatches(8)
    assert counts.sum() == 8 and counts[0] > counts[1]


def test_elastic_add_remove():
    part = _partitioner(4, seed=1)
    part.remove_workers(np.array([False, True, False, False]))
    assert part.num_workers == 3
    part.add_workers(2)
    assert part.num_workers == 5
    fr, _, _ = part.propose_fractions()
    assert len(fr) == 5 and abs(fr.sum() - 1.0) < 1e-5


# --- the wrapper -----------------------------------------------------------
def test_constructor_warns_and_keeps_the_legacy_config():
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        part = tc.HeterogeneityAwarePartitioner(3, seed=2, risk_aversion=0.5, n_iters=7,
                                                grid_size=64, mu_guess=4.0, discount=0.8,
                                                device="cpu")
    dep = [w for w in caught if issubclass(w.category, DeprecationWarning)]
    assert len(dep) == 1 and dep[0].filename == __file__  # stacklevel 2: the caller
    assert str(dep[0].message) == ("HeterogeneityAwarePartitioner is deprecated; use "
                                   "repro_torch.sched.Scheduler or the pure repro_torch.sched API")
    cfg = part.config
    assert (cfg.n_iters, cfg.grid_size, cfg.mu_guess, cfg.discount) == (7, 64, 4.0, 0.8)
    assert cfg.objective == Objective.mean_var(0.5) and part.num_workers == 3
    assert part.device == torch.device("cpu")


def test_risk_aversion_reads_and_replaces_the_objective():
    part = _partitioner(2)
    assert part.risk_aversion == 0.0 and part.config.objective == Objective.mean()
    part.risk_aversion = 2.0
    assert part.risk_aversion == 2.0 and part.config.objective == Objective.mean_var(2.0)
    part.risk_aversion = 0.0
    assert part.config.objective == Objective.mean()
    assert jc._legacy_objective(2.0).kind == tc._legacy_objective(2.0).kind == "mean_var"


def test_without_a_device_it_raises_on_a_cpu_machine():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the partitioner would use it")
    with pytest.raises(RuntimeError, match="device='cpu'"), warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        tc.HeterogeneityAwarePartitioner(2)


def test_three_import_paths_give_the_same_names():
    from repro_torch import core
    from repro_torch.core import partitioner

    for name in ("HeterogeneityAwarePartitioner", "WorkerTelemetry", "optimize_fractions",
                 "quantize_fractions"):
        assert getattr(core, name) is getattr(partitioner, name) is getattr(tc, name)
        assert name in core.__all__ and name in dir(partitioner)
    assert partitioner._legacy_objective is tc._legacy_objective
    assert tc.WorkerTelemetry is __import__("repro_torch.sched", fromlist=["x"]).Telemetry
    with pytest.raises(AttributeError):
        partitioner.nothing_here  # noqa: B018


def test_importing_core_leaves_sched_unimported():
    code = (
        "import sys\n"
        "import repro_torch.core as core\n"
        "assert 'repro_torch.sched' not in sys.modules, 'core imported sched'\n"
        "import repro_torch.core.partitioner\n"
        "assert 'repro_torch.sched' not in sys.modules, 'the shim imported sched'\n"
        "core.HeterogeneityAwarePartitioner\n"
        "assert 'repro_torch.sched.compat' in sys.modules\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"),
                                                      "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr
