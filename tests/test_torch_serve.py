"""Port parity: the always-on service (repro_torch.serve): ring, drift,
cadence, async propose, the active set, state conversion and the driver.

Exact against the reference: the ring's push/drain/overflow layout
(tests/test_serve.py's cases) and every state ``convert`` carries over.  At
float32 tolerance: ``posterior_drift`` (rtol 1e-5).  Against the port's own
paths, bit for bit: ring drains through ``gibbs_batch`` against the
synchronous ``fit``, the async service's decisions against the synchronous
one's, and an empty tick against the state before it (generator included).
Statistically, as tests/test_serve.py and test_serve_async.py: the cadence
fires on drift and not on steady-state noise, the service learns its split,
and under ``active_size`` every worker is refreshed in turn.
"""
import os
import subprocess
import sys
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sched as js
from repro import serve as jsv
from repro.core.frontier import UnitParams as JUnit
from repro_torch import convert
from repro_torch import sched as ts
from repro_torch import serve as tsv
from repro_torch.core import gibbs as tg
from repro_torch.core.frontier import UnitParams as TUnit
from repro_torch.device import no_sync

ROOT = Path(__file__).resolve().parents[1]
N_ITERS, GRID = 3, 64
SCHED = ts.SchedulerConfig(n_iters=2, grid_size=32, num_points=64, opt_steps=10)


def _leaves(tree):
    """Tensor leaves of a state; the generator and absent leaves are skipped."""
    if isinstance(tree, torch.Tensor):
        return [tree]
    if tree is None or isinstance(tree, torch.Generator):
        return []
    return [x for part in tree for x in _leaves(part)]


def _equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


def _stream(n, seed=0):
    rng = np.random.default_rng(seed)
    f = rng.uniform(0.1, 0.9, n).astype(np.float32)
    t = (f**0.85 * 10.0 + f**0.8 * 0.5 * rng.standard_normal(n)).astype(np.float32)
    return t, f


# ------------------------------------------------------------ ring parity
def _ring_case(ring_init, push, drain, as_array):
    """tests/test_serve.py's ring cases: overflow, a wrapped partial drain,
    a fleet ring with an invalid element.  Returns every observable."""
    out = []
    ring = ring_init(4)
    for i in range(6):
        ring = push(ring, 0.5, 10.0 + i)
    batch, ring = drain(ring)
    out += [batch.times, batch.fracs, batch.mask, batch.count, ring.dropped, ring.total, ring.count]
    t, f = _stream(20 + 8, seed=1)
    ring = ring_init(8)
    for i in range(5):
        ring = push(ring, f[i], t[i])
    batch, ring = drain(ring)
    out += [batch.times, batch.mask]
    for i in range(5, 16):  # wraps and overflows
        ring = push(ring, f[i], t[i])
    batch, ring = drain(ring)
    out += [batch.times, batch.fracs, batch.mask, ring.head, ring.dropped]
    ring = ring_init(3, num_workers=2)
    ring = push(ring, as_array([0.6, 0.4]), as_array([3.0, np.inf]), valid=as_array([1.0, 0.0]))
    ring = push(ring, as_array([0.5, 0.5]), as_array([2.0, 4.0]))
    batch, ring = drain(ring)
    out += [batch.times, batch.fracs, batch.mask, ring.fracs, ring.times, ring.valid]
    return out


def test_ring_push_drain_overflow_layout_matches_reference():
    want = _ring_case(jsv.ring_init, jsv.push, jsv.drain, jnp.asarray)
    got = _ring_case(lambda c, num_workers=None: tsv.ring_init(c, num_workers, device="cpu"),
                     tsv.push, tsv.drain, lambda x: torch.as_tensor(x, dtype=torch.float32))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert np.isfinite(got[-2].numpy()).all()  # the invalid inf was never stored


def test_ring_drains_bitwise_match_synchronous_fit():
    """Pushes plus whole-ring drains advanced through ``gibbs_batch`` are the
    port's synchronous ``fit`` over the same observations, bit for bit."""
    cap = 32
    t, f = _stream(2 * cap)
    gen = torch.Generator().manual_seed(7)
    state = tg.init_state(gen, mu_guess=10.0)
    ring = tsv.ring_init(cap, device="cpu")
    for i in range(len(t)):
        ring = tsv.push(ring, f[i], t[i])
        if (i + 1) % cap == 0:
            batch, ring = tsv.drain(ring)
            state, _ = tg.gibbs_batch(state, batch.times, batch.fracs, batch.mask,
                                      generator=gen, n_iters=N_ITERS, grid_size=GRID)
    ref, _ = tg.fit(7, t, f, batch_size=cap, n_iters=N_ITERS, grid_size=GRID, mu_guess=10.0,
                    device="cpu")
    assert _equal(state, ref)


def test_ring_wraparound_drain_is_bitwise_the_padded_batches():
    cap = 32
    t, f = _stream(20 + cap, seed=1)
    run = lambda: torch.Generator().manual_seed(3)
    gen = run()
    state = tg.init_state(gen, mu_guess=10.0)
    ring = tsv.ring_init(cap, device="cpu")
    for i in range(20):
        ring = tsv.push(ring, f[i], t[i])
    batch, ring = tsv.drain(ring)
    state, _ = tg.gibbs_batch(state, batch.times, batch.fracs, batch.mask, generator=gen,
                              n_iters=N_ITERS, grid_size=GRID)
    for i in range(20, 20 + cap):
        ring = tsv.push(ring, f[i], t[i])
    batch, ring = tsv.drain(ring)
    np.testing.assert_array_equal(batch.times.numpy(), t[20:])
    state, _ = tg.gibbs_batch(state, batch.times, batch.fracs, batch.mask, generator=gen,
                              n_iters=N_ITERS, grid_size=GRID)
    gen = run()
    ref = tg.init_state(gen, mu_guess=10.0)
    pad = lambda x, v: torch.as_tensor(np.concatenate([x, np.full(12, v, np.float32)]))
    ref, _ = tg.gibbs_batch(ref, pad(t[:20], 1.0), pad(f[:20], 0.5),
                            pad(np.ones(20, np.float32), 0.0), generator=gen,
                            n_iters=N_ITERS, grid_size=GRID)
    ref, _ = tg.gibbs_batch(ref, torch.as_tensor(t[20:]), torch.as_tensor(f[20:]),
                            torch.ones(cap), generator=gen, n_iters=N_ITERS, grid_size=GRID)
    assert _equal(state, ref)


def test_posterior_drift_matches_reference():
    rng = np.random.default_rng(5)
    cols = lambda: [rng.uniform(lo, hi, 32).astype(np.float32)
                    for lo, hi in ((1, 20), (0.1, 3), (0.5, 1), (0.5, 1))]
    ref, cur = cols(), cols()
    want = jsv.posterior_drift(JUnit(*map(jnp.asarray, ref)), JUnit(*map(jnp.asarray, cur)))
    got = tsv.posterior_drift(TUnit(*map(torch.as_tensor, ref)), TUnit(*map(torch.as_tensor, cur)))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-5)


# ---------------------------------------------------------- state transfer
def _jconfig(**kw):
    base = dict(sched=js.SchedulerConfig(n_iters=2, grid_size=32, num_points=64, opt_steps=10,
                                         hierarchical=True, hyper_refit_every=2),
                capacity=8, max_staleness=4, active_size=2)
    base.update(kw)
    return jsv.ServeConfig(**base)


def _tconfig(**kw):
    base = dict(sched=ts.SchedulerConfig(n_iters=2, grid_size=32, num_points=64, opt_steps=10,
                                         hierarchical=True, hyper_refit_every=2),
                capacity=8, max_staleness=4, active_size=2)
    base.update(kw)
    return tsv.ServeConfig(**base)


def _jloop_after_ticks():
    loop = jsv.ServiceLoop(4, config=_jconfig(), seed=0)
    rng = np.random.default_rng(0)
    for _ in range(3):
        for _ in range(8):
            f = rng.uniform(0.2, 0.8, 4).astype(np.float32)
            loop.push(f, f**0.9 * np.array([2.0, 4.0, 6.0, 8.0], np.float32))
        loop.tick()
    f = np.full(4, 0.25, np.float32)
    loop.push(f, f * 3.0)  # one row left buffered
    return loop


def test_convert_carries_a_serve_state_over_bitwise():
    """A reference service state after hierarchical, active-set ticks, with
    telemetry still buffered, becomes the port's state leaf for leaf."""
    jstate = _jloop_after_ticks().state
    host = jax.tree_util.tree_map(np.asarray, jstate)
    got = convert.to_serve_state(host, seed=0, device="cpu")
    keyless = jstate.sched._replace(key=None, gibbs=jstate.sched.gibbs._replace(key=None))
    want = [np.asarray(x) for x in jax.tree_util.tree_leaves(jstate._replace(sched=keyless))]
    assert len(_leaves(got)) == len(want)
    for g, w in zip(_leaves(got), want):
        assert g.dtype == (torch.int32 if w.dtype == np.int32 else torch.float32)
        np.testing.assert_array_equal(g.numpy(), w)
    ring = convert.to_ring(host.ring, "cpu")
    assert _equal(ring, got.ring) and int(ring.count) == 1


def test_a_carried_state_ticks_on_in_the_port():
    """The port's loop resumes a reference state: it drains the buffered row,
    keeps the refresh ages and the hyperprior's cadence, and publishes a
    split that sums to 1."""
    jloop = _jloop_after_ticks()
    state = convert.to_serve_state(jax.tree_util.tree_map(np.asarray, jloop.state), seed=0,
                                   device="cpu")
    loop = tsv.ServiceLoop(4, config=_tconfig(), state=state)
    info = loop.tick()
    assert info.drained == 1 and int(loop.state.n_drains) == int(jloop.state.n_drains) + 1
    assert int((loop.state.refresh_age == 0).sum()) == 2
    assert int(loop.state.hyper_age) in (0, int(jloop.state.hyper_age) + 1)
    if info.proposed:
        assert abs(float(loop.fractions().sum()) - 1.0) < 1e-5


# ----------------------------------------------------------------- cadence
def _steady_cfg(**kw):
    base = dict(sched=ts.SchedulerConfig(n_iters=4, grid_size=64, num_points=128, opt_steps=40,
                                         mu_guess=3.0),
                capacity=8, drift_threshold=0.25, max_staleness=100)
    base.update(kw)
    return tsv.ServeConfig(**base)


def _push_rounds(loop, mu, rounds, rng):
    fr = np.full(len(mu), 1.0 / len(mu), np.float32)
    infos = []
    for _ in range(rounds):
        for _ in range(loop.config.capacity):
            times = fr**0.9 * mu + fr**0.8 * 0.05 * mu * rng.standard_normal(len(mu))
            loop.push(fr, times.astype(np.float32))
        infos.append(loop.tick())
    return infos


def test_cadence_fires_on_drift_not_steady_state_noise():
    rng = np.random.default_rng(0)
    mu = np.array([2.0, 4.0, 6.0])
    loop = tsv.ServiceLoop(3, config=_steady_cfg(), seed=2, device="cpu")
    infos = _push_rounds(loop, mu, 8, rng)
    assert infos[0].proposed  # saturated staleness: the first drain solves
    assert not all(i.proposed for i in infos[4:]), "steady-state noise must not re-solve"
    v0 = loop.version
    infos = _push_rounds(loop, mu * np.array([4.0, 1.0, 1.0]), 2, rng)
    assert any(i.proposed for i in infos), "a regime change must re-solve"
    assert max(float(i.drift) for i in infos) > loop.config.drift_threshold
    assert loop.version > v0


def test_empty_tick_leaves_beliefs_and_generator_untouched():
    loop = tsv.ServiceLoop(2, config=_steady_cfg(), seed=0, device="cpu")
    before = [x.clone() for x in _leaves(loop.state.sched)]
    gen_state = loop.state.sched.generator.get_state()
    info = loop.tick()
    assert info.drained == 0 and not info.proposed
    assert all(torch.equal(a, b) for a, b in zip(before, _leaves(loop.state.sched)))
    assert torch.equal(loop.state.sched.generator.get_state(), gen_state)
    assert loop.counters()["drains"] == 0 and loop.version == 0
    state, info = tsv.tick(loop.state, loop.config)  # the functional tick agrees
    assert info.drained == 0 and torch.equal(state.sched.generator.get_state(), gen_state)


def test_service_loop_learns_split_end_to_end():
    rng = np.random.default_rng(1)
    mu = np.array([2.0, 8.0])  # worker 0 is 4x faster
    loop = tsv.ServiceLoop(2, config=_steady_cfg(max_staleness=4), seed=3, device="cpu")
    fr_eq = np.full(2, 0.5, np.float32)
    for _ in range(10):
        for _ in range(loop.config.capacity):
            times = fr_eq**0.9 * mu + fr_eq**0.8 * 0.05 * mu * rng.standard_normal(2)
            loop.push(fr_eq, times.astype(np.float32))
        loop.tick()
    fr = loop.fractions()
    assert fr[0] > fr[1]
    np.testing.assert_array_equal(fr, loop.state.fractions.numpy())
    c = loop.counters()
    assert c["drains"] == 10 and 1 <= c["proposes"] <= c["drains"]
    assert c["pushes"] == 10 * loop.config.capacity and c["dropped"] == 0


def test_fixed_threshold_never_touches_gate_or_hyper():
    cfg = tsv.ServeConfig(sched=SCHED, capacity=4, drift_threshold=0.25, max_staleness=4)
    loop = tsv.ServiceLoop(2, config=cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    for _ in range(2):
        for _ in range(4):
            f = rng.uniform(0.2, 0.8, 2).astype(np.float32)
            loop.push(f, f**0.9 * np.array([4.0, 8.0], np.float32))
        loop.tick()
    assert int(loop.state.gate.count) == 0 and float(loop.state.hyper.n_workers) == 0.0
    assert loop.counters()["proposes"] >= 1


def test_hierarchical_tick_end_to_end():
    cfg = tsv.ServeConfig(
        sched=ts.SchedulerConfig(n_iters=2, grid_size=32, num_points=64, opt_steps=10,
                                 hierarchical=True, hyper_refit_every=2),
        capacity=4, max_staleness=4)
    loop = tsv.ServiceLoop(2, config=cfg, seed=0, device="cpu")
    rng = np.random.default_rng(0)
    for _ in range(6):
        for _ in range(4):
            f = rng.uniform(0.2, 0.8, 2).astype(np.float32)
            loop.push(f, f**0.9 * np.array([2.0, 8.0], np.float32))
        info = loop.tick()
    assert float(loop.state.hyper.n_workers) == 2.0 and int(loop.state.gate.count) >= 1
    assert np.isfinite(float(info.drift)) and loop.counters()["proposes"] >= 1
    fr = loop.fractions()
    assert abs(float(fr.sum()) - 1.0) < 1e-5 and fr[0] > fr[1]


# ------------------------------------------------------------ async propose
def _config(**kw):
    base = dict(sched=SCHED, capacity=16, drift_threshold=0.05, max_staleness=4)
    base.update(kw)
    return tsv.ServeConfig(**base)


def _feed(loop, rounds=2, rows=8, k=3, seed=1, guard=None):
    """``guard``: makes the context manager each tick's advance runs in."""
    rng = np.random.default_rng(seed)
    mu = np.linspace(5.0, 20.0, k).astype(np.float32)
    infos = []
    for _ in range(rounds):
        for _ in range(rows):
            f = rng.uniform(0.1, 0.9, k).astype(np.float32)
            loop.push(f, f**0.9 * mu)
        infos.append(loop.tick(guard() if guard else None))
    return infos


class _Recorder:
    """A tick guard that notes when it is entered and left."""

    def __init__(self):
        self.spans = []

    def __enter__(self):
        self.spans.append([time.perf_counter(), None])

    def __exit__(self, *exc):
        self.spans[-1][1] = time.perf_counter()
        return False


def test_tick_guard_spans_the_advance_and_dispatch_is_timed_after_it():
    loop = tsv.ServiceLoop(3, config=_config(async_propose=True), seed=0, device="cpu")
    assert loop.last_dispatch is None
    guard = _Recorder()
    (info,) = _feed(loop, rounds=1, guard=lambda: guard)
    (entered, left), = guard.spans
    start, end = loop.last_dispatch
    assert info.proposed and entered <= left <= start <= end
    empty = _Recorder()
    assert not loop.tick(empty).proposed and len(empty.spans) == 1  # an empty tick too


class _NeverReady:
    """Stands in for an in-flight solve that has not finished."""

    def is_ready(self):
        return False


def test_async_tick_does_not_publish_until_poll():
    loop = tsv.ServiceLoop(3, config=_config(async_propose=True), seed=0, device="cpu")
    infos = _feed(loop, rounds=1)
    assert infos[0].proposed
    assert loop._pending is not None and loop.version == 0
    np.testing.assert_allclose(loop.fractions(), 1 / 3)
    assert loop.poll() is True and loop.version == 1
    fr = loop.fractions()
    assert abs(float(fr.sum()) - 1.0) < 1e-5 and np.all(fr > 0)
    assert np.isfinite(float(loop.state.stats.e_t))
    assert loop.poll() is False


def test_async_pending_solve_suppresses_redispatch():
    loop = tsv.ServiceLoop(3, config=_config(async_propose=True), seed=0, device="cpu")
    marker = _NeverReady()
    loop._pending = marker
    infos = _feed(loop, rounds=1)
    assert infos[0].proposed and loop._pending is marker and loop.version == 0


def test_async_bookkeeping_and_splits_match_sync():
    """Decisions, staleness, counters — and, once published, the splits —
    are the synchronous service's, bit for bit: the solve draws nothing."""
    sync = tsv.ServiceLoop(3, config=_config(), seed=0, device="cpu")
    later = tsv.ServiceLoop(3, config=_config(async_propose=True), seed=0, device="cpu")
    for s, a in zip(_feed(sync, rounds=3), _feed(later, rounds=3)):
        assert s.proposed == a.proposed and s.drained == a.drained
    assert sync.counters() == later.counters()
    assert int(sync.state.staleness) == int(later.state.staleness)
    later.poll()
    np.testing.assert_array_equal(later.fractions(), sync.fractions())


def test_async_with_hierarchical():
    config = _config(async_propose=True, sched=ts.SchedulerConfig(
        n_iters=2, grid_size=32, num_points=64, opt_steps=10, hierarchical=True,
        hyper_refit_every=2))
    loop = tsv.ServiceLoop(3, config=config, seed=0, device="cpu")
    _feed(loop, rounds=3)
    loop.poll()
    assert loop.version >= 1 and abs(float(loop.fractions().sum()) - 1.0) < 1e-5


def test_active_set_tick_refreshes_every_worker_round_robin():
    loop = tsv.ServiceLoop(4, config=_config(active_size=2), seed=0, device="cpu")
    assert loop.state.refresh_age is not None
    seen = torch.zeros(4, dtype=torch.bool)
    for _ in range(2):  # ceil(K / M) data ticks
        _feed(loop, rounds=1, k=4)
        seen |= loop.state.refresh_age == 0
    assert bool(seen.all())
    _feed(loop, rounds=2, k=4)
    ages = loop.state.refresh_age.numpy()
    assert ages.max() <= 3 and int((ages == 0).sum()) == 2
    assert abs(float(loop.fractions().sum()) - 1.0) < 1e-5


def test_active_set_none_is_structurally_legacy():
    assert tsv.ServiceLoop(3, config=_config(), seed=0, device="cpu").state.refresh_age is None
    full = tsv.ServiceLoop(3, config=_config(active_size=3), seed=0, device="cpu")
    dense = tsv.ServiceLoop(3, config=_config(), seed=0, device="cpu")
    _feed(full, rounds=1)
    _feed(dense, rounds=1)
    assert _equal(full.state.sched, dense.state.sched)  # active_size >= K is the dense path


def test_active_set_with_async_propose_end_to_end():
    loop = tsv.ServiceLoop(4, config=_config(active_size=2, async_propose=True), seed=0,
                           device="cpu")
    _feed(loop, rounds=3, k=4)
    loop.poll()
    fr = loop.fractions()
    assert loop.version >= 1 and abs(float(fr.sum()) - 1.0) < 1e-5 and np.all(fr > 0)


def test_non_hierarchical_tick_ignores_hyper_knobs_bitwise():
    make = lambda every, strength: tsv.ServiceLoop(3, config=_config(sched=ts.SchedulerConfig(
        n_iters=2, grid_size=32, num_points=64, opt_steps=10, hierarchical=False,
        hyper_refit_every=every, hyper_strength=strength)), seed=0, device="cpu")
    a, b = make(1, 0.9), make(64, 0.1)
    _feed(a, rounds=3)
    _feed(b, rounds=3)
    zero = torch.zeros((), dtype=torch.int32)
    assert _equal(a.state._replace(hyper_age=zero), b.state._replace(hyper_age=zero))
    np.testing.assert_array_equal(a.fractions(), b.fractions())


def test_service_entry_points_without_a_device_raise_on_a_cpu_machine():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points would use it")
    for make in (lambda: tsv.init(_config(), 3), lambda: tsv.ServiceLoop(3, config=_config()),
                 lambda: ts.Scheduler(3), lambda: ts.init(ts.SchedulerConfig(), 3, capacity=4)):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            make()


# -------------------------------------------------------------- the driver
def test_launch_serve_smoke_subprocess():
    """``python -m repro_torch.launch.serve --serve-smoke --device cpu``: real
    model serving rounds fed through the service, at least one propose and
    at least one drift-gated skip, exit 0."""
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--serve-smoke", "--device", "cpu"],
        capture_output=True, text=True, timeout=600, cwd=ROOT,
        env={**os.environ, "PYTHONPATH": str(ROOT / "src")},
    )
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "serve-smoke OK" in proc.stdout and "oracle makespan" in proc.stdout


def _partitioned_service(sched_mod, serve_mod, cluster_mod, seed, threshold, rounds=16,
                         replicas=4, batch=16, drain_every=4, **loop_kw):
    """The service side of ``launch.serve --rounds`` (both packages' drivers
    build it alike): quantize the published split, push the simulated
    replicas' times, tick every ``drain_every`` rounds.  The model the
    driver also serves touches none of it.  Returns (proposes, drains, the
    drift of every drain)."""
    specs = [cluster_mod.WorkerSpec(mu=float(m), sigma=0.1 * float(m))
             for m in np.linspace(2.0, 6.0, replicas)]
    cluster = cluster_mod.SimulatedCluster(specs, seed=0)
    config = serve_mod.ServeConfig(
        sched=sched_mod.SchedulerConfig(n_iters=4, grid_size=64, num_points=128, opt_steps=40,
                                        mu_guess=float(np.mean([s.mu for s in specs]))),
        capacity=2 * drain_every, drift_threshold=threshold, max_staleness=8)
    loop = serve_mod.ServiceLoop(replicas, config=config, seed=seed, **loop_kw)
    drifts = []
    for rnd in range(rounds):
        counts = sched_mod.quantize_fractions(loop.fractions(), batch,
                                              sched_mod.unit_params(loop.state.sched),
                                              objective=config.sched.objective)
        fr = counts / counts.sum()
        times = cluster.step_times(fr)
        loop.push(fr, times, valid=np.isfinite(times))
        if (rnd + 1) % drain_every == 0:
            drifts.append(float(loop.tick().drift))
    c = loop.counters()
    return c["proposes"], c["drains"], drifts


def test_partitioned_serving_gate_at_the_default_threshold_skips_as_the_reference():
    """``launch.serve --rounds 16 --replicas 4 --batch 16 --drain-every 4`` at
    the default drift gate 0.05, over the service's seeds 1-24 in both
    packages.  The smoke condition (a propose, and a skip: drains > proposes)
    fails for a large share of seeds in the reference as in the port, which
    is why chip_smoke.py's full-width run asserts it at the reference
    ``--serve-smoke``'s own gate, 0.12.  The port's gate behaves as the
    reference's: the smoke condition's pass counts agree (Fisher's exact
    test, p > 0.01) and so do the converged drifts, those of drains 3 and 4
    (Mann-Whitney U, p > 0.01).  The two draw different random streams, so
    the comparison is of distributions, not of seeds."""
    from scipy import stats

    from repro.distributed import simulated_cluster as jcl
    from repro_torch.distributed import simulated_cluster as tcl

    seeds = range(1, 25)
    ref = [_partitioned_service(js, jsv, jcl, s, 0.05) for s in seeds]
    port = [_partitioned_service(ts, tsv, tcl, s, 0.05, device="cpu") for s in seeds]
    smoke = lambda runs: sum(p >= 1 and d > p for p, d, _ in runs)
    fails = [len(seeds) - smoke(ref), len(seeds) - smoke(port)]
    assert min(fails) >= len(seeds) // 4, fails
    table = [[smoke(ref), fails[0]], [smoke(port), fails[1]]]
    assert stats.fisher_exact(table).pvalue > 0.01, table
    late = lambda runs: [x for _, _, drifts in runs for x in drifts[2:]]
    assert stats.mannwhitneyu(late(ref), late(port)).pvalue > 0.01


# ------------------------------------------------------------- on the card
def _needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")


@pytest.mark.cuda
def test_ticks_on_the_card_are_sync_free_and_do_not_grow_memory():
    """chip_smoke.py's phase 9 (e) in small: every advance under sync-debug
    "error", async solves on the side stream, allocated memory flat."""
    _needs_card()
    loop = tsv.ServiceLoop(64, config=_config(active_size=16, async_propose=True), seed=0,
                           device="cuda")
    memory = []
    for _ in range(4):
        _feed(loop, rounds=1, k=64, guard=lambda: no_sync("cuda"))
        torch.cuda.synchronize()
        loop.poll()
        torch.cuda.synchronize()
        torch.empty((), device="cuda")
        memory.append(torch.cuda.memory_allocated())
    assert max(memory[1:]) <= memory[0] and loop.version >= 1
