"""Port parity: checkpointing (repro_torch.checkpoint) and resume of the
service and scheduler states.

The reference's checkpoint tests one for one (tests/test_runtime.py:14-103,
tests/test_sched.py:71-123, tests/test_serve.py:237), on the port's states:
a restored ``ServiceLoop``, scheduler or DAG state goes on bit for bit like
the one it was saved from, its generator included.  Across packages: the
manifests' key paths are the reference's letter for letter, and a
checkpoint of either package restores by name into the other's template,
skipping only the random-state leaves (the reference's ``key`` leaves, the
port's ``generator``); a bfloat16 leaf the reference wrote (``|V2`` on
disk) restores bitwise into a port bfloat16 leaf.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import sched as js
from repro import serve as jsv
from repro.checkpoint.checkpoint import CheckpointManager as JManager
from repro_torch import convert
from repro_torch import sched as ts
from repro_torch import serve as tsv
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.checkpoint import _flatten_with_paths

CFG = ts.SchedulerConfig(n_iters=8, grid_size=64, mu_guess=10.0, opt_steps=60)


def _named_leaves(tree):
    """{key path: leaf} with each generator as its state tensor."""
    paths, leaves = _flatten_with_paths(tree)
    return {p: (l.get_state() if isinstance(l, torch.Generator) else l)
            for p, l in zip(paths, leaves)}


def _bitwise(a, b):
    la, lb = _named_leaves(a), _named_leaves(b)
    assert list(la) == list(lb)
    for path in la:
        assert la[path].dtype == lb[path].dtype, path
        assert torch.equal(la[path], lb[path]), path
    return True


# ------------------------------------------ tests/test_runtime.py:14-103
def test_checkpoint_roundtrip(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_write=False)
    tree = {"a": torch.arange(10.0), "b": {"c": torch.ones((3, 3))}}
    mgr.save(5, tree, {"step": 5, "note": "x"})
    restored, extra = mgr.restore(tree)
    np.testing.assert_array_equal(restored["a"].numpy(), np.arange(10.0))
    assert isinstance(restored["b"]["c"], torch.Tensor) and extra == {"step": 5, "note": "x"}


def test_checkpoint_retention_and_latest(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_write=False)
    tree = {"w": torch.zeros(4)}
    for s in (1, 2, 3, 4):
        mgr.save(s, tree, {"step": s})
    assert mgr.steps() == [3, 4]
    assert mgr.latest_step() == 4


def test_checkpoint_ignores_partial_tmp(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=3, async_write=False)
    tree = {"w": torch.zeros(4)}
    mgr.save(1, tree, {"step": 1})
    # simulate a crash mid-write
    bad = tmp_path / "step_00000002.tmp"
    bad.mkdir()
    (bad / "arr_00000.npy").write_bytes(b"garbage")
    mgr2 = CheckpointManager(str(tmp_path), keep=3, async_write=False)
    assert mgr2.latest_step() == 1
    assert not bad.exists()  # purged


def test_checkpoint_async(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=1, async_write=True)
    tree = {"w": torch.full((8,), 7.0)}
    mgr.save(3, tree, {"step": 3})
    mgr.wait()
    restored, _ = mgr.restore(tree)
    np.testing.assert_array_equal(restored["w"].numpy(), np.full(8, 7.0))


def test_checkpoint_manifest_records_keypaths(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_write=False)
    tree = {"a": torch.arange(4.0), "b": {"c": torch.ones(2)}}
    mgr.save(1, tree, {"step": 1})
    manifest = json.loads((tmp_path / "step_00000001" / "manifest.json").read_text())
    assert manifest["keypaths"] == ["['a']", "['b']['c']"]
    assert (manifest["step"], manifest["num_arrays"], manifest["process_index"]) == (1, 2, 0)


def test_restore_by_name_subset_on_shape_drift(tmp_path):
    """A drifted leaf keeps its template value; matching leaves restore by
    name even though positional order shifted, and the report says which."""
    mgr = CheckpointManager(str(tmp_path), keep=2, async_write=False)
    saved = {
        "params": {"w": torch.full((3,), 7.0)},
        "sched": {"ewma_count": torch.zeros((), dtype=torch.int32)},  # legacy scalar
    }
    mgr.save(1, saved, {"step": 1})
    template = {
        "params": {"w": torch.zeros((3,))},
        "sched": {"ewma_count": torch.ones((2,), dtype=torch.int32)},  # now per-worker
    }
    tree, extra, report = mgr.restore_by_name(template)
    np.testing.assert_array_equal(tree["params"]["w"].numpy(), np.full(3, 7.0))
    assert tree["sched"]["ewma_count"] is template["sched"]["ewma_count"]  # template kept
    assert report["restored"] == ["['params']['w']"]
    assert report["skipped"] == ["['sched']['ewma_count']"]
    assert extra["step"] == 1
    # positional restore must refuse the same checkpoint (shape mismatch)
    with pytest.raises(ValueError):
        mgr.restore(template)


def test_restore_by_name_rejects_dtype_drift_and_prekeypath(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_write=False)
    mgr.save(1, {"x": torch.arange(4, dtype=torch.int32)}, {"step": 1})
    tree, _, report = mgr.restore_by_name({"x": torch.zeros(4, dtype=torch.float32)})
    assert report["skipped"] == ["['x']"]  # same shape, wrong dtype
    np.testing.assert_array_equal(tree["x"].numpy(), np.zeros(4))
    # pre-keypath checkpoints are explicit: positional restore only
    mpath = tmp_path / "step_00000001" / "manifest.json"
    manifest = json.loads(mpath.read_text())
    del manifest["keypaths"]
    mpath.write_text(json.dumps(manifest))
    with pytest.raises(ValueError, match="predates key-path"):
        mgr.restore_by_name({"x": torch.zeros(4, dtype=torch.int32)})


# ------------------------------------------- tests/test_sched.py:71-123
def _telemetry(rng, state, true_mu, n=16, alpha=0.9):
    fr = ts.propose(state, CFG)[0].numpy()
    fmat = np.tile(fr[:, None], (1, n)).astype(np.float32)
    tmat = np.stack([np.maximum(f[0] ** alpha * m + 0.3 * rng.normal(size=n), 1e-3)
                     for f, m in zip(fmat, true_mu)]).astype(np.float32)
    return ts.Telemetry(torch.as_tensor(fmat), torch.as_tensor(tmat))


def test_scheduler_state_roundtrip_bit_exact(tmp_path):
    rng = np.random.default_rng(1)
    state = ts.init(CFG, 3, seed=7, device="cpu")
    for _ in range(2):
        state, _ = ts.observe(state, _telemetry(rng, state, [4.0, 8.0, 16.0]), CFG)

    ckpt = CheckpointManager(str(tmp_path), async_write=False)
    ckpt.save(0, state)
    fresh = ts.init(CFG, 3, seed=0, device="cpu")  # structure template
    restored, _ = ckpt.restore(fresh)
    assert isinstance(restored, ts.SchedulerState) and restored.live is None
    assert restored.generator is not state.generator and _bitwise(state, restored)


def test_legacy_checkpoint_shape_drift_raises(tmp_path):
    """A checkpoint with the old fleet-global scalar ``ewma_count`` fails
    restore with ValueError (leaf shape drift)."""
    state = ts.init(CFG, 3, seed=0, device="cpu")
    legacy = state._replace(ewma_count=torch.zeros((), dtype=torch.int32))
    ckpt = CheckpointManager(str(tmp_path), async_write=False)
    ckpt.save(0, legacy)
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(ts.init(CFG, 3, seed=0, device="cpu"))


def test_restored_trajectory_matches_unrestored(tmp_path):
    """observe -> propose after restore reproduces the unrestored run, the
    Gibbs draws from the restored generator included."""
    rng = np.random.default_rng(2)
    state = ts.init(CFG, 2, seed=3, device="cpu")
    state, _ = ts.observe(state, _telemetry(rng, state, [5.0, 20.0]), CFG)

    ckpt = CheckpointManager(str(tmp_path), async_write=False)
    ckpt.save(0, state)
    restored, _ = ckpt.restore(ts.init(CFG, 2, seed=0, device="cpu"))

    telem = _telemetry(rng, state, [5.0, 20.0])
    s1, ll1 = ts.observe(state, telem, CFG)
    s2, ll2 = ts.observe(restored, telem, CFG)
    assert torch.equal(ll1, ll2) and _bitwise(s1, s2)
    f1, _ = ts.propose(s1, CFG)
    f2, _ = ts.propose(s2, CFG)
    assert torch.equal(f1, f2)


def test_scheduler_shell_takes_the_restored_state(tmp_path):
    """The ``Scheduler`` shell's ``state`` is the checkpointable tree: save
    it, assign the restored tree to a fresh shell, and both shells observe
    and propose alike."""
    rng = np.random.default_rng(5)
    shell = ts.Scheduler(3, config=CFG, seed=2, device="cpu")
    shell.observe(_telemetry(rng, shell.state, [4.0, 8.0, 16.0]))
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(0, shell.state)
    ckpt.wait()
    other = ts.Scheduler(3, config=CFG, seed=0, device="cpu")
    other.state, _ = ckpt.restore(other.state)
    telem = _telemetry(rng, shell.state, [4.0, 8.0, 16.0])
    assert torch.equal(shell.observe(telem), other.observe(telem))
    np.testing.assert_array_equal(shell.propose_microbatches(48), other.propose_microbatches(48))
    assert _bitwise(shell.state, other.state)


def test_dag_state_resumes_bitwise(tmp_path):
    """A ``DagState`` goes through save and restore with no special case:
    observe_dag -> propose_dag after restore is the unrestored run."""
    dag = ts.WorkflowDAG.chain(3, 2)
    rng = np.random.default_rng(4)
    mu = np.array([[4.0, 8.0], [2.0, 6.0], [5.0, 5.0]])

    def telemetry():
        f = rng.uniform(0.2, 0.8, (3, 2, 8)).astype(np.float32)
        t = (f**0.9 * mu[..., None] + 0.1 * rng.normal(size=f.shape)).astype(np.float32)
        return ts.Telemetry(torch.as_tensor(f), torch.as_tensor(t))

    state = ts.init_dag(CFG, dag, seed=5, device="cpu")
    state, _ = ts.observe_dag(state, telemetry(), CFG)
    ckpt = CheckpointManager(str(tmp_path), async_write=False)
    ckpt.save(0, state)
    restored, _ = ckpt.restore(ts.init_dag(CFG, dag, seed=0, device="cpu"))
    assert _bitwise(state, restored)
    telem = telemetry()
    s1, _ = ts.observe_dag(state, telem, CFG)
    s2, _ = ts.observe_dag(restored, telem, CFG)
    assert _bitwise(s1, s2)
    assert torch.equal(ts.propose_dag(s1, dag, CFG)[0], ts.propose_dag(s2, dag, CFG)[0])


# ------------------------------------------------ tests/test_serve.py:237
def _steady_cfg(**kw):
    base = dict(sched=ts.SchedulerConfig(n_iters=4, grid_size=64, num_points=128, opt_steps=40,
                                         mu_guess=3.0),
                capacity=8, drift_threshold=0.25, max_staleness=100)
    base.update(kw)
    return tsv.ServeConfig(**base)


def _push_rounds(loop, mu, rounds, rng):
    fr = np.full(len(mu), 1.0 / len(mu), np.float32)
    for _ in range(rounds):
        for _ in range(loop.config.capacity):
            times = fr**0.9 * mu + fr**0.8 * 0.05 * mu * rng.standard_normal(len(mu))
            loop.push(fr, times.astype(np.float32))
        loop.tick()
        loop.poll()


@pytest.mark.parametrize("async_propose", [False, True])
def test_serve_state_checkpoints_and_resumes_bitwise(tmp_path, async_propose):
    """With telemetry left buffered, a restored ``ServiceLoop`` ticks bit for
    bit like the one it was saved from.  A solve that async propose has
    dispatched is not part of the state: the async case polls it in before
    the save and after the tick."""
    rng = np.random.default_rng(2)
    mu = np.array([3.0, 5.0])
    config = _steady_cfg(async_propose=async_propose, max_staleness=1)
    loop = tsv.ServiceLoop(2, config=config, seed=4, device="cpu")
    _push_rounds(loop, mu, 3, rng)
    # leave telemetry BUFFERED so restore must bring the ring back too
    fr = np.full(2, 0.5, np.float32)
    loop.push(fr, (fr**0.9 * mu).astype(np.float32))

    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(1, loop.state._asdict(), {"step": 1})
    ckpt.wait()

    template = tsv.init(loop.config, 2, seed=0, device="cpu")._asdict()
    restored, _ = ckpt.restore(template)
    state2 = tsv.ServeState(**restored)
    assert _bitwise(loop.state, state2)

    # both copies tick identically from here
    loop2 = tsv.ServiceLoop(2, config=loop.config, state=state2)
    i1, i2 = loop.tick(), loop2.tick()
    assert i1.drained == i2.drained == 1 and i1.proposed and i2.proposed
    assert loop.poll() == loop2.poll() == async_propose
    assert _bitwise(loop.state, loop2.state)
    np.testing.assert_array_equal(loop.fractions(), loop2.fractions())


def test_save_snapshots_buffers_written_in_place_later(tmp_path):
    """The ring's buffers are written in place by later pushes; the async
    writer still writes the state as it was at ``save``."""
    loop = tsv.ServiceLoop(2, config=_steady_cfg(), seed=0, device="cpu")
    loop.push(np.full(2, 0.5), np.array([1.0, 2.0]))
    before = {p: x.clone() for p, x in _named_leaves(loop.state._asdict()).items()}
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(1, loop.state._asdict())
    for _ in range(3):
        loop.push(np.full(2, 0.5), np.array([9.0, 9.0]))
    ckpt.wait()
    restored, _ = ckpt.restore(tsv.init(loop.config, 2, device="cpu")._asdict())
    got = _named_leaves(restored)
    assert all(torch.equal(got[p], before[p]) for p in before)
    assert not torch.equal(got["['ring'].times"], loop.state.ring.times)


# ------------------------------------------------------- across packages
def _mixed_tree(lib):
    from typing import NamedTuple

    class A(NamedTuple):
        x: object
        y: object = None

    return {"b": A(lib.ones(2), (lib.zeros(1), [lib.ones(3)])), "a": [lib.zeros(2), None],
            "c": {"z": lib.ones(1), "d": lib.zeros(())}}


def test_manifest_keypaths_equal_the_reference(tmp_path):
    """The same tree, saved by both managers, gives the same manifest key
    paths and arrays; so does a service state, but for the random state."""
    JManager(str(tmp_path / "ref"), async_write=False).save(1, _mixed_tree(jnp))
    CheckpointManager(str(tmp_path / "port"), async_write=False).save(1, _mixed_tree(torch))
    read = lambda d: json.loads((tmp_path / d / "step_00000001" / "manifest.json").read_text())
    ref, port = read("ref"), read("port")
    assert port["keypaths"] == ref["keypaths"] and len(ref["keypaths"]) == 6
    for i in range(ref["num_arrays"]):
        a, b = (np.load(tmp_path / d / "step_00000001" / f"arr_{i:05d}.npy") for d in ("ref", "port"))
        assert a.dtype == b.dtype and np.array_equal(a, b)

    jpaths, _ = _flatten_with_paths(jsv.init(jsv.ServeConfig(), 3, jax.random.PRNGKey(0))._asdict())
    kl, _ = jax.tree_util.tree_flatten_with_path(
        jsv.init(jsv.ServeConfig(), 3, jax.random.PRNGKey(0))._asdict())
    assert jpaths == [jax.tree_util.keystr(k) for k, _ in kl] and len(jpaths) == 49
    tpaths, _ = _flatten_with_paths(tsv.init(tsv.ServeConfig(), 3, device="cpu")._asdict())
    want = [("['sched'].generator" if p == "['sched'].key" else p) for p in jpaths
            if p != "['sched'].gibbs.key"]
    assert tpaths == want


def _jcfg():
    return jsv.ServeConfig(sched=js.SchedulerConfig(n_iters=2, grid_size=32, num_points=64,
                                                     opt_steps=10),
                           capacity=8, max_staleness=2, active_size=2)


def _tcfg():
    return tsv.ServeConfig(sched=ts.SchedulerConfig(n_iters=2, grid_size=32, num_points=64,
                                                     opt_steps=10),
                           capacity=8, max_staleness=2, active_size=2)


def _fill(loop, rounds=2, seed=0):
    rng = np.random.default_rng(seed)
    for _ in range(rounds):
        for _ in range(8):
            f = rng.uniform(0.2, 0.8, 4).astype(np.float32)
            loop.push(f, f**0.9 * np.array([2.0, 4.0, 6.0, 8.0], np.float32))
        loop.tick()
    f = np.full(4, 0.25, np.float32)
    loop.push(f, f * 3.0)  # one row left buffered


def test_reference_serve_checkpoint_restores_by_name_into_the_port(tmp_path):
    """A reference ``ServeState`` checkpoint restores by name into the port's
    template: only the port's generator is skipped (the reference's ``key``
    leaves have no port leaf to fill), and every restored leaf is
    ``convert.to_serve_state``'s."""
    jloop = jsv.ServiceLoop(4, config=_jcfg(), seed=0)
    _fill(jloop)
    JManager(str(tmp_path), async_write=False).save(3, jloop.state._asdict(), {"step": 3})
    template = tsv.init(_tcfg(), 4, seed=9, device="cpu")._asdict()
    tree, extra, report = CheckpointManager(str(tmp_path)).restore_by_name(template)
    assert report["skipped"] == ["['sched'].generator"] and extra == {"step": 3}
    assert len(report["restored"]) == 48  # 49 leaves with refresh_age
    assert tree["sched"].generator is template["sched"].generator
    want = _named_leaves(convert.to_serve_state(
        jax.tree_util.tree_map(np.asarray, jloop.state), seed=9, device="cpu")._asdict())
    got = _named_leaves(tree)
    for path in report["restored"]:
        assert got[path].dtype == want[path].dtype and torch.equal(got[path], want[path]), path
    loop = tsv.ServiceLoop(4, config=_tcfg(), state=tsv.ServeState(**tree))
    assert loop.tick().drained == 1


def test_port_serve_checkpoint_restores_by_name_into_the_reference(tmp_path):
    """The converse: the reference's manager restores a port checkpoint into
    its own template, skipping only its ``key`` leaves (the port's
    ``GibbsState`` carries none; its one generator is ``['sched'].generator``)."""
    loop = tsv.ServiceLoop(4, config=_tcfg(), seed=0, device="cpu")
    _fill(loop)
    CheckpointManager(str(tmp_path), async_write=False).save(2, loop.state._asdict())
    template = jsv.init(_jcfg(), 4, jax.random.PRNGKey(0))._asdict()
    tree, _, report = JManager(str(tmp_path)).restore_by_name(template)
    assert report["skipped"] == ["['sched'].gibbs.key", "['sched'].key"]
    assert len(report["restored"]) == 48  # 49 leaves with refresh_age
    port = _named_leaves(loop.state._asdict())
    kl, _ = jax.tree_util.tree_flatten_with_path(tree)
    for k, leaf in kl:
        path = jax.tree_util.keystr(k)
        if path in report["restored"]:
            np.testing.assert_array_equal(np.asarray(leaf), port[path].numpy())
    jloop = jsv.ServiceLoop(4, config=_jcfg(), state=jsv.ServeState(**tree))
    assert int(jloop.tick().drained) == 1


def test_reference_bfloat16_leaf_restores_bitwise_into_the_port(tmp_path):
    """The reference writes bfloat16 as ``|V2``; the port takes those bits
    back into a bfloat16 leaf, positionally and by name, on a tree shaped as
    a model's parameters."""
    rng = np.random.default_rng(0)
    w = jnp.asarray(rng.normal(size=(3, 5)), jnp.bfloat16)
    ref_tree = {"embed": w, "layers": [{"scale": jnp.ones(5, jnp.float32)}]}
    JManager(str(tmp_path), async_write=False).save(1, ref_tree)
    assert np.load(tmp_path / "step_00000001" / "arr_00000.npy").dtype.str == "|V2"
    template = {"embed": torch.zeros((3, 5), dtype=torch.bfloat16),
                "layers": [{"scale": torch.zeros(5)}]}
    want_bits = np.asarray(w).view(np.int16)
    mgr = CheckpointManager(str(tmp_path))
    by_name, _, report = mgr.restore_by_name(template)
    positional, _ = mgr.restore(template)
    assert report["skipped"] == []
    for tree in (by_name, positional):
        assert tree["embed"].dtype == torch.bfloat16
        np.testing.assert_array_equal(tree["embed"].view(torch.int16).numpy(), want_bits)
        np.testing.assert_array_equal(tree["layers"][0]["scale"].numpy(), np.ones(5))


def test_port_bfloat16_leaf_is_the_reference_layout(tmp_path):
    """The port writes a bfloat16 tensor as the reference does (``|V2``
    bits): the reference's positional restore gives the same bits back.  Its
    ``restore_by_name`` skips such a leaf (a void array never equals its
    bfloat16 template's dtype), where the port's restores it (ROADMAP,
    recorded differences)."""
    t = torch.randn(4, 3, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    CheckpointManager(str(tmp_path), async_write=False).save(1, {"w": t})
    jtemplate = {"w": jnp.zeros((4, 3), jnp.bfloat16)}
    restored, _ = JManager(str(tmp_path)).restore(jtemplate)
    np.testing.assert_array_equal(restored["w"].view(np.int16), t.view(torch.int16).numpy())
    _, _, report = JManager(str(tmp_path)).restore_by_name(jtemplate)
    assert report["skipped"] == ["['w']"]
    tree, _, report = CheckpointManager(str(tmp_path)).restore_by_name(
        {"w": torch.zeros((4, 3), dtype=torch.bfloat16)})
    assert report["restored"] == ["['w']"] and torch.equal(tree["w"], t)


# ---------------------------------------------------------- on the card
@pytest.mark.cuda
def test_generator_state_round_trip_on_the_card(tmp_path):
    """A scheduler state on the card: its CUDA generator's state is saved
    and set on a new generator on the card, and observe -> propose from the
    restored state is the unrestored run, bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels have no CPU mode")
    rng = np.random.default_rng(3)
    mu = np.array([4.0, 6.0, 8.0, 16.0])

    def telemetry():
        f = rng.uniform(0.1, 0.5, (4, 16)).astype(np.float32)
        t = (f**0.9 * mu[:, None] + 0.3 * rng.normal(size=f.shape)).astype(np.float32)
        return ts.Telemetry(torch.as_tensor(f).cuda(), torch.as_tensor(np.maximum(t, 1e-3)).cuda())

    state = ts.init(CFG, 4, seed=11, device="cuda")
    state, _ = ts.observe(state, telemetry(), CFG)
    ckpt = CheckpointManager(str(tmp_path))
    ckpt.save(0, state)
    ckpt.wait()
    restored, _ = ckpt.restore(ts.init(CFG, 4, seed=0, device="cuda"))
    assert restored.generator.device.type == "cuda" and restored.gibbs.mu.is_cuda
    assert _bitwise(state, restored)
    telem = telemetry()
    s1, _ = ts.observe(state, telem, CFG)
    s2, _ = ts.observe(restored, telem, CFG)
    assert _bitwise(s1, s2)
    assert torch.equal(ts.propose(s1, CFG)[0], ts.propose(s2, CFG)[0])
