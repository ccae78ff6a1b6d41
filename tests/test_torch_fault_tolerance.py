"""The fault-tolerance monitor on the port
(``repro_torch.distributed.fault_tolerance``) against the reference's.

The reference's three tests run on the port.  Then a warmed reference
scheduler state is carried into the port (``convert.to_scheduler_state``)
and both monitors see the same steps, missed heartbeats (``inf``, ``nan``)
and a straggler included: scores at ``tests/test_torch_sched.py``'s anomaly
tolerance (rtol 1e-5), failure and straggler masks and ``events`` exactly;
then eviction and admission against the reference's fleet size and health
list.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sched as js
from repro.distributed import fault_tolerance as jft
from repro_torch import convert
from repro_torch import sched
from repro_torch.distributed.fault_tolerance import FaultToleranceMonitor, WorkerHealth

CFG = sched.SchedulerConfig(n_iters=6, grid_size=64, mu_guess=5.0, opt_steps=40)
JCFG = js.SchedulerConfig(n_iters=6, grid_size=64, mu_guess=5.0, opt_steps=40)


@pytest.fixture(autouse=True)
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _warm_scheduler(k=4, steps=3, seed=0):
    rng = np.random.default_rng(seed)
    part = sched.Scheduler(k, config=CFG, seed=seed, device="cpu")
    for _ in range(steps):
        fr = np.full((k, 16), 1.0 / k, np.float32)
        t = np.abs(rng.normal(5.0, 0.3, (k, 16))).astype(np.float32)
        part.observe(sched.Telemetry(torch.as_tensor(fr), torch.as_tensor(t)))
    return part, rng


# --- tests/test_fault_tolerance.py on the port -----------------------------
def test_hard_failure_never_enters_soft_anomaly_stats():
    part, rng = _warm_scheduler()
    mon = FaultToleranceMonitor(part, heartbeat_timeout=1e9)
    fr = np.full(4, 0.25)
    base = np.abs(rng.normal(5.0, 0.3, 4))
    mon.observe_step(fr, base, now=0.0)
    ewma_before = part.state.ewma_ll.numpy().copy()

    dead_times = base.copy()
    dead_times[1] = np.inf
    out = mon.observe_step(fr, dead_times, now=1.0)
    assert out["failures"][1]
    assert not out["stragglers"][1]  # failed, not straggling

    np.testing.assert_allclose(float(part.state.ewma_ll[1]), ewma_before[1])
    assert np.isfinite(part.state.ewma_ll.numpy()).all()
    assert float(part.state.ewma_ll.max()) < 1e3


def test_live_fleet_scores_match_failure_free_run():
    part_a, rng_a = _warm_scheduler(seed=1)
    part_b, _ = _warm_scheduler(seed=1)
    fr = np.full(4, 0.25)
    times = np.abs(rng_a.normal(5.0, 0.3, 4))

    mon_a = FaultToleranceMonitor(part_a, heartbeat_timeout=1e9)
    mon_b = FaultToleranceMonitor(part_b, heartbeat_timeout=1e9)
    mon_a.observe_step(fr, times, now=0.0)
    broken = times.copy()
    broken[2] = np.nan
    mon_b.observe_step(fr, broken, now=0.0)

    a = part_a.state.ewma_ll.numpy()
    b = part_b.state.ewma_ll.numpy()
    keep = [0, 1, 3]
    np.testing.assert_array_equal(a[keep], b[keep])


def test_straggler_detection_survives_concurrent_failure():
    part, rng = _warm_scheduler(k=5, seed=2)
    mon = FaultToleranceMonitor(part, heartbeat_timeout=1e9, straggler_sigma=2.0)
    fr = np.full(5, 0.2)
    for step in range(4):
        times = np.abs(rng.normal(5.0, 0.3, 5))
        times[3] *= 6.0  # persistent straggler
        times[4] = np.inf  # hard failure alongside
        out = mon.observe_step(fr, times, now=float(step))
    assert out["failures"][4]
    assert out["stragglers"][3]
    assert not out["stragglers"][4]


# --- against the reference -------------------------------------------------
def _twin_monitors(k, seed, **kw):
    """A warmed reference ``Scheduler`` and its state carried into the port,
    each wrapped in its package's monitor."""
    rng = np.random.default_rng(seed)
    jpart = js.Scheduler(k, config=JCFG, seed=seed)
    mu = np.linspace(4.0, 8.0, k)
    for _ in range(3):
        f = rng.uniform(0.1, 0.3, (k, 16)).astype(np.float32)
        t = (f**0.9 * mu[:, None] + 0.2 * rng.normal(size=(k, 16))).astype(np.float32)
        jpart.observe(js.Telemetry(jnp.asarray(f), jnp.asarray(t)))
    tpart = sched.Scheduler(k, config=CFG, seed=seed, device="cpu")
    tpart.state = convert.to_scheduler_state(jax.tree_util.tree_map(np.asarray, jpart.state),
                                             seed=seed, device="cpu")
    return jft.FaultToleranceMonitor(jpart, **kw), FaultToleranceMonitor(tpart, **kw), rng, mu


def _assert_health_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.alive, g.last_heartbeat, g.flagged) == (w.alive, w.last_heartbeat, w.flagged)
        np.testing.assert_allclose(g.anomaly_score, w.anomaly_score, rtol=1e-5)
        assert [f.name for f in dataclasses.fields(WorkerHealth)] == \
            [f.name for f in dataclasses.fields(jft.WorkerHealth)]


def test_observe_step_matches_reference_with_missed_heartbeats():
    """Worker 3 runs 6x slow throughout; worker 5 reports inf from step 2
    on, worker 1 nan at step 3 only (a missed heartbeat, then back)."""
    k = 8
    jmon, tmon, rng, mu = _twin_monitors(k, seed=3, heartbeat_timeout=2.5, straggler_sigma=2.0)
    fr = np.full(k, 1.0 / k)
    seen_failure = seen_straggler = False
    for step in range(6):
        times = fr**0.9 * mu + 0.05 * rng.normal(size=k)
        times[3] *= 6.0
        if step >= 2:
            times[5] = np.inf
        if step == 3:
            times[1] = np.nan
        want = jmon.observe_step(fr, times, now=float(step))
        got = tmon.observe_step(fr, times, now=float(step))
        for name in ("failures", "stragglers"):
            assert got[name].dtype == np.bool_
            np.testing.assert_array_equal(got[name], np.asarray(want[name]), err_msg=name)
        np.testing.assert_allclose(tmon.partitioner.state.ewma_ll.numpy(),
                                   np.asarray(jmon.partitioner.state.ewma_ll), rtol=1e-5)
        _assert_health_equal(tmon.health, jmon.health)
        seen_failure |= bool(got["failures"].any())
        seen_straggler |= bool(got["stragglers"][3])
    assert seen_failure and seen_straggler
    assert tmon.events == jmon.events
    assert all(type(w) is int for e in tmon.events for w in e.get("workers", []))

    failures = got["failures"]
    jmon.evict(np.asarray(want["failures"]))
    tmon.evict(failures)
    assert tmon.partitioner.num_workers == jmon.partitioner.num_workers == k - 1
    jmon.admit(3, seed=1)
    tmon.admit(3, seed=1)
    assert tmon.partitioner.num_workers == jmon.partitioner.num_workers == k + 2
    _assert_health_equal(tmon.health, jmon.health)
    assert tmon.events == jmon.events
    assert [e["type"] for e in tmon.events[-2:]] == ["evict", "admit"]
    assert type(tmon.events[-2]["count"]) is int and tmon.events[-2]["count"] == 1
