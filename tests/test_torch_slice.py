"""The port's first slice end to end: observe -> propose -> quantize.

A reference scheduler state crosses over through ``repro_torch.convert``
and the port's decisions from it agree with the reference's; the port's own
cycle rebalances a heterogeneous fleet on the CPU; the package stands alone
(no JAX, no ``repro``); and the entry points refuse to run on the CPU unasked.
"""
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sched as js
from repro_torch import convert
from repro_torch import sched as ts

ROOT = Path(__file__).resolve().parents[1]
CFG = dict(n_iters=4, grid_size=32, num_points=128, opt_steps=40)


def _telemetry(rng, fracs, mu, n):
    f = (fracs[:, None] * np.exp(rng.uniform(-0.5, 0.5, (len(fracs), n)))).astype(np.float32)
    t = (f**0.9 * mu[:, None] + f**0.7 * 0.3 * rng.normal(size=f.shape)).astype(np.float32)
    return f, t


def test_decisions_from_a_carried_over_state_match_reference():
    k = 4
    jcfg = js.SchedulerConfig(**CFG, mu_guess=10.0)
    tcfg = ts.SchedulerConfig(**CFG, mu_guess=10.0)
    rng = np.random.default_rng(0)
    mu = np.asarray([5.0, 10.0, 20.0, 40.0])
    state = js.init(jcfg, k, jax.random.PRNGKey(0))
    for _ in range(2):
        f, t = _telemetry(rng, np.full(k, 1.0 / k), mu, 24)
        state, _ = js.observe(state, js.Telemetry(jnp.asarray(f), jnp.asarray(t)), jcfg)
    port = convert.to_scheduler_state(jax.tree_util.tree_map(np.asarray, state), seed=0, device="cpu")
    assert int(port.step) == 2

    for got, want in zip(ts.unit_params(port), js.unit_params(state)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-6)

    want_f, want_s = js.propose(state, jcfg)
    got_f, got_s = ts.propose(port, tcfg)
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), atol=1e-3)
    np.testing.assert_allclose(float(got_s.score), float(want_s.score), rtol=1e-4)

    want_c = js.quantize_fractions(np.asarray(want_f), 8 * k, js.unit_params(state))
    got_c = ts.quantize_fractions(got_f.numpy(), 8 * k, ts.unit_params(port))
    np.testing.assert_array_equal(got_c, want_c)


def test_port_cycle_rebalances_a_heterogeneous_fleet():
    """K = 16 workers, the fastest 8x faster than the slowest: after three
    observe -> propose -> quantize cycles the fast worker carries the most
    work and the counts sum to the total (tests/test_partitioner.py's
    acceptance scenario, at fleet width).  One refinement pass keeps the
    CPU test short."""
    k, total = 16, 8 * 16
    cfg = ts.SchedulerConfig(**CFG, mu_guess=10.0)
    rng = np.random.default_rng(1)
    mu = np.linspace(5.0, 40.0, k)
    state = ts.init(cfg, k, seed=0, device="cpu")
    fracs = np.full(k, 1.0 / k)
    for _ in range(3):
        f, t = _telemetry(rng, fracs, mu, 32)
        state, ll = ts.observe(state, ts.Telemetry(torch.as_tensor(f), torch.as_tensor(t)), cfg)
        assert torch.isfinite(ll).all()
        proposal, stats = ts.propose(state, cfg)
        fracs = proposal.numpy().astype(np.float64)
        counts = ts.quantize_fractions(fracs, total, ts.unit_params(state), refine_passes=1)
        assert counts.sum() == total and (counts >= 1).all()
    np.testing.assert_allclose(fracs.sum(), 1.0, rtol=1e-5)
    assert int(np.argmax(fracs)) == 0 and fracs[0] > 3 * fracs[-1]
    assert counts[0] == counts.max() and counts[0] > counts[-1]
    assert int(state.step) == 3


def test_port_imports_no_jax_and_no_reference():
    code = (
        "import sys\n"
        "sys.modules.update(jax=None, jaxlib=None, repro=None)  # any import of them raises\n"
        "import repro_torch, repro_torch.core, repro_torch.kernels, repro_torch.sched\n"
        "import repro_torch.convert, repro_torch.kernels.ops, repro_torch.core.gibbs\n"
        "import repro_torch.models, repro_torch.configs, repro_torch.train\n"
        "import repro_torch.launch, repro_torch.launch.serve\n"
        "import repro_torch.hier, repro_torch.serve, repro_torch.distributed\n"
        "import repro_torch.core.compress, repro_torch.configs.smollm_135m\n"
        "import repro_torch.sim, repro_torch.sim.workflow, repro_torch.sched.dag\n"
        "bad = [m for m, mod in sys.modules.items()\n"
        "       if mod is not None and m.split('.')[0] in ('jax', 'jaxlib', 'repro')]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run(
        [sys.executable, "-c", code], cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"),
                                                      "PATH": "/usr/bin:/bin"},
        capture_output=True, text=True, timeout=120,
    )
    assert proc.returncode == 0, proc.stderr


# Names of the reference's ``__all__`` that the port does not export yet,
# each with the ROADMAP item (queue 1) that ports it.
STILL_TO_PORT = {
    "core": {"ShardingConfig": 10, "constrain_fleet": 10, "shard_fleet_map": 10,
             "HeterogeneityAwarePartitioner": 11, "WorkerTelemetry": 11,
             "optimize_fractions": 11, "quantize_fractions": 11},
    "sched": {"ShardingConfig": 10},
    "hier": {"fit_hyperprior_sharded": 10},
    "distributed": {"ShardingConfig": 10},
    "models": {"MeshInfo": 10, "ApplyCtx": 12, "encdec": 12, "moe": 12},
    "configs": {"ALL_SHAPES": 13, "RunConfig": 13, "SHAPES": 13, "applicable": 13, "get_shape": 13},
}
# Pallas kernels and their oracle module, and the port's CUDA counterparts.
KERNEL_COUNTERPARTS = {
    "posterior_grid_fleet_pallas": "posterior_grid_cuda",
    "posterior_grid_pallas": "posterior_grid_fleet",  # its slices: ops.posterior_grid_alpha/_beta
    "decode_attention_pallas": "decode_attention_cuda",
    "lru_scan_pallas": "lru_scan_cuda",
    "ref": "posterior_grid_plain",  # its three oracles are the kernels' plain versions
}


@pytest.mark.parametrize("name", ["core", "sched", "sim", "hier", "serve", "kernels", "models",
                                  "configs", "train", "distributed", "launch"])
def test_port_exports_what_the_reference_exports(name):
    """For every subpackage the port has, its ``__all__`` holds the
    reference's, less the names still to port (each tagged with its ROADMAP
    item), so a name cannot be dropped silently; every exported name
    resolves."""
    import importlib

    ref = importlib.import_module(f"repro.{name}")
    port = importlib.import_module(f"repro_torch.{name}")
    want = set(getattr(ref, "__all__", ()))
    have = set(getattr(port, "__all__", ()))
    missing = want - have - set(STILL_TO_PORT.get(name, {}))
    if name == "kernels":
        assert {k for k in missing if k not in KERNEL_COUNTERPARTS} == set()
        assert set(KERNEL_COUNTERPARTS.values()) <= have
    else:
        assert missing == set(), f"repro_torch.{name} lacks {sorted(missing)}"
    assert not (set(STILL_TO_PORT.get(name, {})) & have), "ported: drop it from STILL_TO_PORT"
    assert [n for n in have if not hasattr(port, n)] == []


def test_core_exports_compression_and_dag_composition():
    from repro_torch import core

    for n in ("CompressionReport", "beta_moments", "compression_report", "fit_lognormal_moments",
              "fit_surrogate", "grid_moments", "select_active", "surrogate_gap", "surrogate_moments",
              "serial_moments", "parallel_max_moments", "dag_completion_moments"):
        assert n in core.__all__ and hasattr(core, n)


def test_single_mode_oracles_are_slices_of_the_reference_grid():
    """core.log_posterior_alpha_ref / _beta_ref, the single-mode oracles of
    K1, against the reference's at its kernel tolerance."""
    from repro.core import moments as jm
    from repro_torch.core import moments as tm
    from test_torch_moments import assert_logp_close, fleet_case

    c = fleet_case(3, 40, seed=5)
    grid = np.linspace(1e-4, 1 - 1e-4, 33, dtype=np.float32)
    J, T = jnp.asarray, torch.as_tensor
    got = tm.log_posterior_alpha_ref(T(grid), T(c["t"]), T(c["f"]), T(c["mu"]), T(c["lam"]),
                                     T(c["beta"]), tm.BetaParams(*map(T, c["ap"])), T(c["mask"]))
    want = jm.log_posterior_alpha_ref(J(grid), J(c["t"]), J(c["f"]), J(c["mu"]), J(c["lam"]),
                                      J(c["beta"]), jm.BetaParams(*map(J, c["ap"])), J(c["mask"]))
    assert_logp_close(got.numpy(), want)
    got = tm.log_posterior_beta_ref(T(grid), T(c["t"]), T(c["f"]), T(c["mu"]), T(c["lam"]),
                                    T(c["alpha"]), tm.BetaParams(*map(T, c["bp"])), T(c["mask"]))
    want = jm.log_posterior_beta_ref(J(grid), J(c["t"]), J(c["f"]), J(c["mu"]), J(c["lam"]),
                                     J(c["alpha"]), jm.BetaParams(*map(J, c["bp"])), J(c["mask"]))
    assert_logp_close(got.numpy(), want)


def test_init_without_a_device_raises_on_a_cpu_machine():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: init would use it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ts.init(ts.SchedulerConfig(), 4)
