"""Fleet sharding of the estimator (``repro_torch.core.sharding``) on a world
of 4 gloo ranks, against the port's unsharded calls and the reference's
sharded ones.

One module-scoped world (``torch_sharding_world.run_world``: spawned ranks,
a ``FileStore`` in a temporary directory, torch on one thread a rank) runs
every case once and writes each rank's results to npz files; beside it a
JAX process of 8 host devices runs the reference's sharded calls on the
same numpy inputs.  The tests read both.

What holds on the CPU: the sharded Gibbs chains, ``observe``, ``propose``
and ``observe_dag`` are bitwise the unsharded ones and leave the generator
bitwise where the unsharded call leaves it.  The per-row work (reductions
over N, K1's plain version) gives each row the same bits whatever the
number of rows, so the gathered posterior parameters are bitwise the
unsharded ones, and ``torch._standard_gamma``, whose use of the stream
depends on its parameters' values, draws the same.  The hyperprior refit
sums its 13 statistics in another order (a rank's rows, then an
``all_reduce``), so it and what is born from it agree to float32 rounding.
"""
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

import torch_sharding_world as world
from repro_torch.core.sharding import (
    ShardingConfig,
    constrain_fleet,
    pad_fleet_axis,
    pad_fleet_mask,
    unpad_fleet_axis,
)

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(scope="module")
def run(tmp_path_factory):
    """(the ranks' results, their failed cases, the reference's results)."""
    d = tmp_path_factory.mktemp("sharding")
    env = dict(os.environ, XLA_FLAGS="--xla_force_host_platform_device_count=8",
               JAX_PLATFORMS="cpu", PYTHONPATH=str(ROOT / "src"))
    ref = subprocess.Popen([sys.executable, str(ROOT / "tests" / "torch_sharding_world.py"), str(d)],
                           env=env, cwd=ROOT, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                           text=True)
    try:
        world.run_world(d)
    finally:
        _, err = ref.communicate(timeout=300)
    assert ref.returncode == 0, err[-3000:]
    ranks = [dict(np.load(d / f"rank{r}.npz")) for r in range(world.WORLD)]
    errors = [json.loads((d / f"rank{r}.json").read_text()) for r in range(world.WORLD)]
    return ranks, errors, dict(np.load(d / "reference.npz"))


def case(run, name, rank=0):
    """{key: array} of one case on one rank, failing with the rank's
    traceback if the case raised."""
    ranks, errors, _ = run
    for r, e in enumerate(errors):
        assert name not in e, f"rank {r}: {e[name]}"
    prefix = f"{name}/"
    return {k[len(prefix):]: v for k, v in ranks[rank].items() if k.startswith(prefix)}


def pairs(got, a, b):
    """[(key, got[a + rest], got[b + rest])] for every key under ``a``."""
    out = [(k, got[k], got[b + k[len(a):]]) for k in got if k.startswith(a)]
    assert out, f"no results under {a!r}"
    return out


def assert_bitwise(got, a, b):
    for key, x, y in pairs(got, a, b):
        np.testing.assert_array_equal(x, y, err_msg=key)


def assert_close(got, a, b, rtol):
    for key, x, y in pairs(got, a, b):
        if x.dtype.kind == "f":
            np.testing.assert_allclose(x, y, rtol=rtol, atol=rtol, err_msg=key)
        else:  # generator states, masks
            np.testing.assert_array_equal(x, y, err_msg=key)


# --------------------------------------------------------------------------
# plumbing
# --------------------------------------------------------------------------
def test_sharding_config_validates_axis(run):
    got = case(run, "plumbing")
    assert str(got["bad_axis"]).startswith("ValueError") and "'workers'" in str(got["bad_axis"])
    assert int(got["other_axis_shards"]) == world.WORLD


def test_sharding_config_is_hashable_and_equal_by_value(run):
    got = case(run, "plumbing")
    assert bool(got["equal"]) and bool(got["config_equal"])
    assert bool(got["bare_mesh_wrapped"])  # SchedulerConfig(mesh=<DeviceMesh>)


def test_auto_builds_a_mesh_over_the_process_group(run):
    assert [int(case(run, "plumbing", r)["rank"]) for r in range(world.WORLD)] == [0, 1, 2, 3]
    got = case(run, "plumbing")
    assert int(got["num_shards"]) == world.WORLD and int(got["pad10"]) == 2
    assert int(got["half_shards"]) == 2  # auto(num_devices=2)
    assert str(got["device_type"]) == "cpu"  # gloo serves host tensors


def test_auto_without_a_process_group_raises():
    assert not torch.distributed.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        ShardingConfig.auto()


def test_pad_unpad_roundtrip():
    tree = {"a": torch.arange(6.0).reshape(3, 2), "b": torch.arange(3)}
    padded = pad_fleet_axis(tree, 2)
    assert padded["a"].shape == (5, 2) and padded["b"].shape == (5,)
    assert bool((padded["a"][3:] == padded["a"][2]).all())  # copies of the last row
    back = unpad_fleet_axis(padded, 3)
    for key in tree:
        assert torch.equal(back[key], tree[key])
    assert pad_fleet_axis(tree, 0) is tree


def test_pad_fleet_mask_appends_zero_rows():
    m = torch.ones((3, 2))
    padded = pad_fleet_mask(m, 2)
    assert padded.shape == (5, 2) and torch.equal(padded[:3], m)
    assert not bool(padded[3:].any())  # dummy rows count for nothing
    assert pad_fleet_mask(m, 0) is m


def test_the_kernels_layer_does_not_import_core():
    """``kernels.ops`` takes ``sharding=`` from the torch-only
    ``repro_torch.sharding``: importing it leaves ``repro_torch.core``
    unimported, so the layers import downward."""
    code = (
        "import sys\n"
        "import repro_torch.kernels.ops\n"
        "up = [m for m in sys.modules if m.split('.')[:2] == ['repro_torch', 'core']]\n"
        "assert not up, up\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                          env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_constrain_fleet_is_the_identity():
    x = torch.ones((4, 3))
    assert constrain_fleet(x, None) is x
    tree = (x, {"y": torch.zeros(2, 4)})
    assert constrain_fleet(tree, None, axis=1) is tree


# --------------------------------------------------------------------------
# K1's wrapper
# --------------------------------------------------------------------------
def test_posterior_grid_fleet_sharded_matches_the_reference_and_unsharded(run):
    """K = 5 on 4 shards (3 pad rows, masked out): one K1 call a rank on its
    rows, the (K, 2, G) output gathered."""
    got = case(run, "k1")
    _, _, ref = run
    assert got["sharded"].shape == (world.K1_K, 2, world.K1_G)
    np.testing.assert_array_equal(got["sharded"], got["unsharded"])
    scale = 1.0 + np.max(np.abs(ref["k1"]), axis=-1, keepdims=True)  # each row's 1 + max|logp|
    assert np.all(np.abs(got["sharded"] - ref["k1"]) <= 1e-5 * scale)


# --------------------------------------------------------------------------
# Gibbs chains
# --------------------------------------------------------------------------
@pytest.mark.parametrize("k", [8, 6])
def test_gibbs_batch_sharded_is_the_unsharded_chain(run, k):
    """At K divisible by the 4 shards and not: states, log-likelihoods and
    the generator's state bitwise the unsharded call's."""
    got = case(run, "gibbs")
    assert_bitwise(got, f"k{k}.unsharded", f"k{k}.sharded")
    assert got[f"k{k}.sharded.ll"].shape == (k,)


@pytest.mark.parametrize("k", [8, 6])
def test_gibbs_batch_sharded_under_a_mask(run, k):
    got = case(run, "gibbs")
    assert_bitwise(got, f"k{k}.masked.unsharded", f"k{k}.masked.sharded")


def test_every_rank_holds_the_same_global_state(run):
    ranks, errors, _ = run
    assert errors == [{}] * world.WORLD, errors
    keys = [k for k in ranks[0] if k != "plumbing/rank"]
    assert len(keys) > 300 and all(set(r) == set(ranks[0]) for r in ranks)
    for r in range(1, world.WORLD):
        for key in keys:
            np.testing.assert_array_equal(ranks[r][key], ranks[0][key], err_msg=f"rank {r}: {key}")


def test_shards_do_not_share_noise(run):
    """Eight identical workers with identical telemetry, 2 a shard: drawing a
    shard's rows from the replicated generator would give the same row in
    every shard.  Every row differs from every other."""
    got = case(run, "gibbs")
    for leaf in ("mu", "lam", "alpha", "beta"):
        x = got[f"identical.{leaf}"]
        assert len(np.unique(x)) == len(x), (leaf, x)


def test_fit_dag_sharded_is_the_unsharded_fit(run):
    """S = 3, K = 4: the folded S*K = 12 axis split across the 4 shards."""
    got = case(run, "fit_dag")
    assert got["sharded.ll"].shape == (3, 4)
    assert_bitwise(got, "unsharded", "sharded")


def test_sharded_calls_refuse_active_idx(run):
    for name in ("k1", "gibbs"):
        msg = str(case(run, name)["active_idx"])
        assert msg.startswith("ValueError") and "single-device" in msg, (name, msg)


def test_a_fleet_off_the_mesh_device_raises(run):
    """A fleet on another device type than the mesh serves (here 'meta' on a
    gloo mesh) raises, naming both: nothing falls back to the unsharded path."""
    msg = str(case(run, "gibbs")["off_mesh_device"])
    assert msg.startswith("ValueError") and "'meta'" in msg and "'cpu'" in msg, msg


# --------------------------------------------------------------------------
# the hyperprior
# --------------------------------------------------------------------------
def _reference_leaves(ref, prefix, n):
    return [ref[f"{prefix}.{i}"] for i in range(n)]


@pytest.mark.parametrize("fit", ["fit", "fit_masked"])
def test_fit_hyperprior_sharded_matches_unsharded_and_reference(run, fit):
    """K = 5 on 4 shards (mask-0 pad rows), with and without a mask: the 13
    statistics summed a rank then all-reduced, at rtol 1e-5 of the port's
    one-device refit and of the reference's sharded one."""
    got = case(run, "hier")
    _, _, ref = run
    assert_close(got, f"{fit}.unsharded", f"{fit}.sharded", rtol=1e-5)
    mine = [v for _, v, _ in pairs(got, f"{fit}.sharded", f"{fit}.unsharded")]
    for a, b in zip(mine, _reference_leaves(ref, fit, len(mine)), strict=True):
        np.testing.assert_allclose(a, b, rtol=1e-5)


def test_shrink_and_surprise_sharded_match_unsharded_and_reference(run):
    """Per-worker: bitwise the one-device calls; within 1e-5 of the
    reference's sharded calls."""
    got = case(run, "hier")
    _, _, ref = run
    assert_bitwise(got, "shrink.unsharded", "shrink.sharded")
    np.testing.assert_array_equal(got["surprise.sharded"], got["surprise.unsharded"])
    mine = [v for _, v, _ in pairs(got, "shrink.sharded", "shrink.unsharded")]
    for a, b in zip(mine, _reference_leaves(ref, "shrink", len(mine)), strict=True):
        np.testing.assert_allclose(a, b, rtol=1e-5)
    np.testing.assert_allclose(got["surprise.sharded"], ref["surprise"], rtol=1e-5, atol=1e-5)


# --------------------------------------------------------------------------
# the scheduler
# --------------------------------------------------------------------------
@pytest.mark.parametrize("k", [8, 6])
def test_observe_and_propose_through_a_mesh(run, k):
    """SchedulerConfig(mesh=): observe's chains, the proposal and the
    generator bitwise the one-device scheduler's (the fractions are held
    within 1e-4 first, the reference's tolerance)."""
    got = case(run, "sched")
    np.testing.assert_allclose(got[f"k{k}.sharded.fracs"], got[f"k{k}.unsharded.fracs"], atol=1e-4)
    assert_bitwise(got, f"k{k}.unsharded", f"k{k}.sharded")


def test_observe_dag_through_a_mesh(run):
    got = case(run, "sched")
    assert got["dag.sharded.ll"].shape == (3, 4)
    assert_bitwise(got, "dag.unsharded", "dag.sharded")


def test_capacity_state_counts_every_observation_on_a_mesh(run):
    """Fault 3f over 4 ranks: a capacity state with every slot live (K = 8,
    N = 16) ends one sharded observe with the exact-size state's nu0,
    discount x 1 + N / 2 = 8.9 on every rank: the sharded branch broadcasts
    the (K, 1) live mask to the times, as the unsharded paths do
    (tests/test_torch_elastic.py::test_capacity_state_counts_every_observation)."""
    for rank in range(world.WORLD):
        got = case(run, "sched", rank)
        np.testing.assert_allclose(got["nu.capacity"], got["nu.exact"], rtol=1e-6)
        np.testing.assert_allclose(got["nu.capacity"], 0.9 + 16 / 2, rtol=1e-6)


@pytest.mark.parametrize("path", ["admit", "add"])
def test_hierarchical_admissions_on_a_mesh(run, path):
    """admit_workers into a capacity state's dead slots (the refit masks
    them) and add_workers, both hierarchical: the newcomers are born from the
    sharded refit, which agrees with the one-device refit to float32
    rounding; the generator ends in the same state (these draws consumed
    the same stream)."""
    got = case(run, "sched")
    assert_close(got, f"{path}.unsharded", f"{path}.sharded", rtol=1e-5)


def test_scheduler_shell_pools_over_the_mesh(run):
    """Scheduler.fit_hyperprior, surprise and shrink with a mesh, after an
    observe, within 1e-4 of the one-device shell (the reference's
    tolerance: kappa0 = 1 / (V_mu lambda_bar) takes V_mu = m2/n - mu0^2, whose
    cancellation lifts the sum order's rounding to ~1e-5 relative)."""
    got = case(run, "sched")
    assert_close(got, "shell.unsharded", "shell.sharded", rtol=1e-4)


def test_sharded_state_checkpoint_roundtrip(run):
    """The sharded scheduler's state is global on every rank: it saves and
    restores into a fresh template bit for bit, generator included."""
    got = case(run, "checkpoint")
    assert_bitwise(got, "saved", "restored")
