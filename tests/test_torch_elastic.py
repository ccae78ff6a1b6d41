"""Port parity: elastic membership on capacity slots (sched.init(capacity=),
admit_workers, retire_workers, grow_capacity, add/remove_workers, the live
mask in observe/propose/anomaly/quantize, and the Scheduler shell).

Exact against the reference, from capacity states the reference builds and
``convert`` carries over: the slots ``admit_workers`` picks (a stable sort of
the live mask) and its guard against live slots, the priors it writes (the
global prior is deterministic), ``retire_workers`` and ``grow_capacity``'s
masks and EWMA leaves, and ``quantize_fractions(live=)``'s rounding.  At
float32 tolerance: ``solve_fractions(live=)`` at fixed parameters (score
rtol 1e-4 and fractions atol 1e-3, as tests/test_torch_sched.py: 200 Adam
steps compound float32 gradient noise).
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
from test_torch_serve import _leaves

JCFG = js.SchedulerConfig(n_iters=2, grid_size=32, num_points=64, opt_steps=10)
TCFG = ts.SchedulerConfig(n_iters=2, grid_size=32, num_points=64, opt_steps=10)


def _telemetry(seed, k, n=16):
    rng = np.random.default_rng(seed)
    f = rng.uniform(0.1, 0.9, (k, n)).astype(np.float32)
    t = (f**0.9 * np.linspace(5.0, 25.0, k, dtype=np.float32)[:, None]).astype(np.float32)
    return f, t


def _jtel(seed, k):
    f, t = _telemetry(seed, k)
    return js.Telemetry(fracs=jnp.asarray(f), times=jnp.asarray(t))


def _ttel(seed, k):
    f, t = _telemetry(seed, k)
    return ts.Telemetry(fracs=torch.as_tensor(f), times=torch.as_tensor(t))


def _port(jstate, seed=0):
    return convert.to_scheduler_state(jax.tree_util.tree_map(np.asarray, jstate), seed=seed,
                                      device="cpu")


def _ref_capacity_state():
    """5 live of 8 slots, observed and scored, slot 2 retired: a reference
    state with learned posteriors, EWMA statistics and a hole."""
    state = js.init(JCFG, num_workers=5, key=jax.random.PRNGKey(0), capacity=8)
    state, _ = js.observe(state, _jtel(1, 8), JCFG)
    state, _ = js.anomaly(state, _jtel(1, 8), JCFG)
    dead = np.zeros(8, bool)
    dead[2] = True
    return js.retire_workers(state, jnp.asarray(dead))


def test_capacity_init_matches_reference():
    want = js.init(JCFG, num_workers=3, key=jax.random.PRNGKey(0), capacity=8)
    got = ts.init(TCFG, 3, seed=0, device="cpu", capacity=8)
    np.testing.assert_array_equal(got.live.numpy(), np.asarray(want.live))
    assert ts.capacity(got) == js.capacity(want) == 8
    assert ts.num_workers(got) == js.num_workers(want) == 3
    assert got.ewma_ll.shape == got.gibbs.mu.shape == (8,)
    assert ts.init(TCFG, 3, seed=0, device="cpu").live is None
    with pytest.raises(ValueError):
        ts.init(TCFG, 9, seed=0, device="cpu", capacity=8)


def test_convert_carries_a_capacity_state_over():
    jstate = js.admit_workers(_ref_capacity_state(), 2, JCFG)
    got = _port(jstate)
    for g, w in zip(jax.tree_util.tree_leaves(jstate.gibbs), _leaves(got.gibbs)):
        np.testing.assert_array_equal(w.numpy(), np.asarray(g))
    for name in ("ewma_ll", "ewma_count", "step", "live"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(jstate, name)))




@pytest.mark.parametrize("count", [1, 2, 3, 5])  # 5 > the 4 free slots: guarded
def test_admit_workers_picks_the_references_slots(count):
    """Same slots, same guard, same deterministic priors and EWMA resets;
    rows that are not admitted stay bitwise as they were."""
    jstate = _ref_capacity_state()
    want = js.admit_workers(jstate, count, JCFG)
    before = _port(jstate)
    got = ts.admit_workers(before, count, TCFG)
    np.testing.assert_array_equal(got.live.numpy(), np.asarray(want.live))
    np.testing.assert_array_equal(got.ewma_ll.numpy(), np.asarray(want.ewma_ll))
    np.testing.assert_array_equal(got.ewma_count.numpy(), np.asarray(want.ewma_count))
    changed = np.asarray(want.live) != np.asarray(jstate.live)
    for g, w, b in zip(_leaves(got.gibbs.ng), jax.tree_util.tree_leaves(want.gibbs.ng),
                       _leaves(before.gibbs.ng)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))  # the global prior, exactly
        np.testing.assert_array_equal(g.numpy()[~changed], b.numpy()[~changed])
    for g, b in zip(_leaves(got.gibbs), _leaves(before.gibbs)):
        np.testing.assert_array_equal(g.numpy()[~changed], b.numpy()[~changed])


def test_retire_and_grow_capacity_match_reference():
    jstate = _ref_capacity_state()
    dead = np.zeros(8, bool)
    dead[[0, 4]] = True
    want = js.retire_workers(jstate, jnp.asarray(dead))
    got = ts.retire_workers(_port(jstate), torch.as_tensor(dead))
    for name in ("live", "ewma_ll", "ewma_count"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
    want_g = js.grow_capacity(want, 12, JCFG)
    got_g = ts.grow_capacity(got, 12, TCFG)
    for name in ("live", "ewma_ll", "ewma_count"):
        np.testing.assert_array_equal(getattr(got_g, name).numpy(),
                                      np.asarray(getattr(want_g, name)))
    np.testing.assert_array_equal(got_g.gibbs.ng.mu0.numpy(), np.asarray(want_g.gibbs.ng.mu0))
    for g, b in zip(_leaves(got_g.gibbs), _leaves(got.gibbs)):
        assert g.shape == (12,) and torch.equal(g[:8], b)
    assert ts.grow_capacity(got_g, 4, TCFG) is got_g
    with pytest.raises(ValueError):
        ts.retire_workers(ts.init(TCFG, 3, seed=0, device="cpu"), torch.zeros(3))
    with pytest.raises(ValueError):
        ts.admit_workers(ts.init(TCFG, 3, seed=0, device="cpu"), 1, TCFG)


def test_add_and_remove_workers_match_reference_shapes_and_masks():
    jstate = js.init(JCFG, num_workers=3, key=jax.random.PRNGKey(0), capacity=4)
    tstate = _port(jstate)
    want = js.remove_workers(js.add_workers(jstate, 2, JCFG), np.asarray([0, 1, 0, 0, 0, 0], bool))
    got = ts.remove_workers(ts.add_workers(tstate, 2, TCFG), np.asarray([0, 1, 0, 0, 0, 0], bool))
    for name in ("live", "ewma_ll", "ewma_count"):
        np.testing.assert_array_equal(getattr(got, name).numpy(), np.asarray(getattr(want, name)))
    np.testing.assert_array_equal(got.gibbs.ng.mu0.numpy(), np.asarray(want.gibbs.ng.mu0))
    seeded = lambda: ts.add_workers(tstate, 2, TCFG, seed=9, mu_guess=3.0)
    assert torch.equal(seeded().gibbs.mu, seeded().gibbs.mu)  # an explicit seed repeats
    assert bool((seeded().gibbs.ng.mu0[4:] == 3.0).all())


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_live_mask_matches_reference(seed):
    """Dead slots get exactly 0 and are exempt from the floor; the live
    rounding is the reference's, count for count."""
    rng = np.random.default_rng(seed)
    k = 12
    live = rng.uniform(size=k) > 0.3
    fracs = np.where(live, rng.dirichlet(np.full(k, 0.5)), 0.0)
    fracs = fracs / fracs.sum()
    total = 4 * int(live.sum()) + 3
    want = js.quantize_fractions(fracs, total, live=live, min_per_worker=2)
    got = ts.quantize_fractions(fracs, total, live=live, min_per_worker=2)
    np.testing.assert_array_equal(got, want)
    assert (got[~live] == 0).all() and (got[live] >= 2).all() and got.sum() == total


def test_quantize_live_mask_with_refinement_keeps_dead_slots_out():
    rng = np.random.default_rng(4)
    k = 10
    live = np.ones(k, bool)
    live[[1, 6]] = False
    params = TUnit(*(torch.as_tensor(rng.uniform(lo, hi, k).astype(np.float32))
                     for lo, hi in ((5, 40), (0.5, 3), (0.6, 1.0), (0.5, 1.0))))
    fracs = np.where(live, 1.0 / live.sum(), 0.0)
    counts = ts.quantize_fractions(fracs, 64, params, live=live)
    assert (counts[~live] == 0).all() and (counts[live] >= 1).all() and counts.sum() == 64


def test_solve_fractions_live_matches_reference():
    rng = np.random.default_rng(3)
    k = 8
    cols = [rng.uniform(lo, hi, k).astype(np.float32)
            for lo, hi in ((5, 40), (0.5, 3), (0.6, 1.0), (0.5, 1.0))]
    live = np.ones(k, np.float32)
    live[[2, 5]] = 0.0
    kw = dict(steps=60, num_points=256)
    want_f, want_s = js.solve_fractions(JUnit(*map(jnp.asarray, cols)), live=jnp.asarray(live), **kw)
    got_f, got_s = ts.solve_fractions(TUnit(*map(torch.as_tensor, cols)),
                                      live=torch.as_tensor(live), **kw)
    assert (got_f.numpy()[live == 0] == 0.0).all() and (np.asarray(want_f)[live == 0] == 0.0).all()
    np.testing.assert_allclose(got_f.numpy(), np.asarray(want_f), atol=1e-3)
    np.testing.assert_allclose(float(got_s.score), float(want_s.score), rtol=1e-4)


# ------------------------------------------------- the port's own behaviour
def test_dead_slots_get_exactly_zero_fraction_and_no_anomaly():
    state = ts.init(TCFG, 6, seed=0, device="cpu", capacity=6)
    state, _ = ts.observe(state, _ttel(1, 6), TCFG)
    dead = torch.zeros(6, dtype=torch.bool)
    dead[[1, 4]] = True
    state = ts.retire_workers(state, dead)
    fr, stats = ts.propose(state, TCFG)
    fr = fr.numpy()
    assert fr[1] == 0.0 and fr[4] == 0.0 and abs(fr.sum() - 1.0) < 1e-5
    assert (fr[[0, 2, 3, 5]] > 0.0).all() and np.isfinite(float(stats.e_t))
    state, scores = ts.anomaly(state, _ttel(1, 6), TCFG)
    assert int(state.ewma_count[1]) == 0 and float(scores[1]) == 0.0


def test_dead_slots_telemetry_is_a_no_op_in_observe():
    """Whatever a dead slot's telemetry holds, the observed fleet is the same
    bit for bit (same generator draws, the slot masked out)."""
    state = ts.init(TCFG, 3, seed=0, device="cpu", capacity=4)
    tel = _ttel(1, 4)
    garbage = tel.times.clone()
    garbage[3] = 1e6
    run = lambda times: ts.observe(ts.init(TCFG, 3, seed=0, device="cpu", capacity=4),
                                   tel._replace(times=times), TCFG)[0]
    a, b = run(tel.times), run(garbage)
    assert all(torch.equal(x, y) for x, y in zip(_leaves(a.gibbs), _leaves(b.gibbs)))
    assert float(a.gibbs.ng.nu0[0]) > float(state.gibbs.ng.nu0[0])  # live slots learned


def test_scheduler_shell_elastic_api():
    """tests/test_elastic.py's shell test on the port."""
    s = ts.Scheduler(3, config=TCFG, seed=0, capacity=4, device="cpu")
    assert s.capacity == 4 and s.num_workers == 3
    f, t = _telemetry(1, 4)
    s.observe(ts.Telemetry(fracs=f, times=t))
    s.admit_workers(1)
    assert s.num_workers == 4 and s.capacity == 4
    s.admit_workers(2)  # full -> the shell grows capacity
    assert s.num_workers == 6 and s.capacity >= 6
    s.retire_workers(np.asarray([True] + [False] * (s.capacity - 1)))
    assert s.num_workers == 5
    counts = s.propose_microbatches(64)
    assert counts[0] == 0 and counts.sum() == 64
    assert not s.flag_stragglers()[0]  # dead slots are never flagged
    fr, e_t, var = s.propose_fractions()
    assert fr[0] == 0.0 and np.isfinite(e_t) and np.isfinite(var)
    scores = s.anomaly_scores(np.full((s.capacity, 4), 0.2), np.full((s.capacity, 4), 2.0))
    assert scores.shape == (s.capacity,) and scores[0] == 0.0


@pytest.mark.parametrize("path", ["dense", "active"])
def test_capacity_state_counts_every_observation(path):
    """Fault 3f: with every slot live (capacity = K = 6, N = 16) one observe
    leaves each worker's nu0 where the exact-size state's goes, discount x 1
    + N / 2 = 8.9: the (K, 1) live mask is broadcast to the times before it
    meets the Normal-Gamma update, so it counts N a worker a batch, not 1.
    "active" advances through the active-set path (M = 2 of K = 6), as the
    service does.  nu0 does not depend on the draws, so the reference is held
    to it too, given the explicit mask of ones: that takes its own broadcast
    branch (src/repro/sched/scheduler.py:244-246); without a mask it counts 1
    a worker, its fault, which the JAX package keeps."""
    k = 6
    tel = _ttel(1, k)
    full = ts.init(TCFG, k, seed=0, device="cpu", capacity=k)
    exact = ts.init(TCFG, k, seed=0, device="cpu")
    if path == "dense":
        got = ts.observe(full, tel, TCFG)[0].gibbs.ng.nu0
        want = ts.observe(exact, tel, TCFG)[0].gibbs.ng.nu0
    else:
        idx = torch.tensor([1, 4])
        run = lambda st, mask: ts.advance_fleet(st.gibbs, tel.times, tel.fracs, TCFG, st.generator,
                                             mask=mask, active_idx=idx)[0].ng.nu0
        got, want = run(full, full.live[:, None]), run(exact, None)
    n = tel.times.shape[1]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6)
    np.testing.assert_allclose(got.numpy(), TCFG.discount + n / 2, rtol=1e-6)
    jstate = js.init(JCFG, num_workers=k, key=jax.random.PRNGKey(0), capacity=k)
    jtel = _jtel(1, k)
    ref = js.observe(jstate, jtel, JCFG, mask=jnp.ones(jtel.times.shape))[0].gibbs.ng.nu0
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), rtol=1e-6)
    ref_fault = js.observe(jstate, jtel, JCFG)[0].gibbs.ng.nu0
    np.testing.assert_allclose(np.asarray(ref_fault), JCFG.discount + 0.5, rtol=1e-6)


@pytest.mark.cuda
def test_admit_observe_propose_retire_run_without_a_host_sync():
    """On the card the elastic cycle waits for nothing (chip_smoke.py's
    phase 9 (f) at 2 x 4096 slots)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    state = ts.init(TCFG, 6, seed=0, device="cuda", capacity=8)
    tel = ts.Telemetry(*(x.cuda() for x in _ttel(1, 8)))
    dead = torch.zeros(8, dtype=torch.bool, device="cuda")
    dead[1] = True
    torch.cuda.set_sync_debug_mode("error")
    try:
        state = ts.admit_workers(state, 2, TCFG)
        state, _ = ts.observe(state, tel, TCFG)
        state = ts.retire_workers(state, dead)
        fr, _ = ts.propose(state, TCFG)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    assert float(fr[1]) == 0.0 and abs(float(fr.sum()) - 1.0) < 1e-5
