"""The drivers' traffic arithmetic is what it was copied from."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from conftest import ROOT
from perfbench import harness
from perfbench.drivers import fleet, serve


def test_replicas_draw_what_the_simulated_cluster_draws():
    from repro_torch.distributed.simulated_cluster import SimulatedCluster, WorkerSpec

    mix = harness.load_json(ROOT / "perfbench/mixes/code.json")
    mus = np.linspace(*mix["replica_mu"], mix["replicas"])
    ours = serve.Replicas(mus, mix["sigma_share"], mix["alpha"], mix["beta"], seed=7)
    theirs = SimulatedCluster([WorkerSpec(mu=float(m), sigma=mix["sigma_share"] * float(m),
                                          alpha=mix["alpha"], beta=mix["beta"]) for m in mus],
                              seed=7)
    rng = np.random.default_rng(1)
    for _ in range(20):
        counts = rng.integers(1, 12, mix["replicas"])
        fr = counts / counts.sum()
        np.testing.assert_array_equal(ours.step_times(fr), theirs.step_times(fr))


def test_fleet_truth_is_the_chip_smoke_service_law_around_its_shares():
    """The chip smoke's service draws t = f^0.9 mu + f^0.8 0.05 mu N(0, 1) at
    the shares proportional to 1 / mu; each row here moves the split up to
    half a share either way and renormalises, under the same law."""
    import chip_smoke

    cfg = dict(harness.load_json(ROOT / "perfbench/configs/fleet-100k.json"), workers=1000)
    fracs, draw = fleet.truth(cfg, "cpu", 5)
    want_fracs, _ = chip_smoke.service_truth(1000, "cpu", 5)
    torch.testing.assert_close(fracs, want_fracs, rtol=0, atol=0)
    gen = torch.Generator().manual_seed(5)
    mu = torch.linspace(0.5, 2.0, 1000)
    for _ in range(3):
        f, t = draw()
        u = torch.rand((1000,), generator=gen)
        want_f = fracs * (1.0 + 0.5 * (2.0 * u - 1.0))
        want_f = want_f / want_f.sum()
        z = torch.randn((1000,), generator=gen)
        torch.testing.assert_close(f, want_f, rtol=0, atol=0)
        torch.testing.assert_close(t, want_f ** 0.9 * mu + want_f ** 0.8 * 0.05 * mu * z,
                                   rtol=0, atol=0)
        assert float(f.sum()) == pytest.approx(1.0, abs=1e-5)
        assert float((f / fracs).min()) > 0.45 and float((f / fracs).max()) < 1.55


def test_seeds_are_fixed_by_the_seed_and_fit_a_generator():
    a = fleet.seeds(2**31 + 5, 4)
    assert a == fleet.seeds(2**31 + 5, 4) and a != fleet.seeds(2**31 + 6, 4)
    assert all(0 <= s < 2**63 for s in a)
    torch.Generator().manual_seed(a[0])


def test_the_service_config_is_the_mixs():
    cfg = harness.load_json(ROOT / "perfbench/configs/fleet-100k.json")
    for name in ("every-drain", "gated"):
        mix = harness.load_json(ROOT / f"perfbench/mixes/{name}.json")
        c = fleet.service_config(cfg, mix)
        assert c.capacity == 8 and c.sched.grid_size == 512 and c.sched.n_iters == 20
        assert c.sched.min_fraction == 1 / 800_000 and c.async_propose
        assert c.drift_threshold == mix["drift_threshold"] and c.max_staleness == mix["max_staleness"]
