"""The port's trainer (``repro_torch.train.trainer``) and training driver
(``repro_torch.launch.train``) on the CPU.

The reference's six end-to-end tests (``tests/test_system.py``) run on the
port at the same reduced smollm-135m config; then the port's losses against
the reference trainer's from the same initial state, a reference trainer
checkpoint restored into the port, the driver as a subprocess, and the
refusal to run on the CPU unasked.
"""
import dataclasses
import json
import os
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro_torch import convert
from repro_torch.configs import RunConfig, get_arch, reduced
from repro_torch.configs.base import ShapeConfig
from repro_torch.distributed.simulated_cluster import SimulatedCluster, WorkerSpec
from repro_torch.models.params import leaves
from repro_torch.train.trainer import Trainer

ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread: the suite's worker processes would oversubscribe
    the cores (tests/test_torch_dag.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _run_cfg(tmp_path, steps=24, **kw):
    cfg = reduced(get_arch("smollm-135m"))
    shape = ShapeConfig("t", seq_len=32, global_batch=8, kind="train")
    return RunConfig(
        model=cfg, shape=shape, checkpoint_dir=str(tmp_path),
        total_steps=steps, warmup_steps=2, checkpoint_every=8,
        partitioner_refit_every=6, **kw,
    )


def trainer(run, cluster, m):
    return Trainer(run, cluster=cluster, num_microbatches=m, device="cpu")


# --- tests/test_system.py on the port ---------------------------------------


def test_training_converges_and_rebalances(tmp_path):
    run = _run_cfg(tmp_path, steps=24)
    cluster = SimulatedCluster([WorkerSpec(5.0, 0.5), WorkerSpec(20.0, 1.0)], seed=0)
    tr = trainer(run, cluster, 8)
    rep = tr.train(24)
    assert rep.losses[-1] < rep.losses[0]
    # learned split favors the 4x-faster worker 0
    assert rep.splits, "partitioner refits must have occurred"
    final = rep.splits[-1]
    assert final[0] > final[1]
    # makespan improves vs the initial equal split
    k = max(len(rep.makespans) // 4, 1)
    assert np.mean(rep.makespans[-k:]) < np.mean(rep.makespans[:k])


def test_failure_detection_and_elastic_continue(tmp_path):
    run = _run_cfg(tmp_path, steps=20)
    run = dataclasses.replace(run, shape=ShapeConfig("t", seq_len=32, global_batch=12, kind="train"))
    cluster = SimulatedCluster(
        [WorkerSpec(5.0, 0.5), WorkerSpec(6.0, 0.5), WorkerSpec(5.5, 0.5)], seed=1)
    tr = trainer(run, cluster, 6)
    tr.train(6)
    assert tr.partitioner.num_workers == 3
    cluster.fail(2)
    rep = tr.train(8)
    assert tr.partitioner.num_workers == 2  # evicted
    assert any(e["type"] == "failure" for e in tr.monitor.events)
    assert np.isfinite(rep.losses[-1])
    # all microbatches now assigned to survivors
    assert set(np.unique(tr._worker_of_mb)) <= {0, 1}


def test_checkpoint_restart_resumes_exactly(tmp_path):
    run = _run_cfg(tmp_path, steps=16)
    cluster = SimulatedCluster([WorkerSpec(5.0, 0.5), WorkerSpec(7.0, 0.5)], seed=2)
    tr1 = trainer(run, cluster, 4)
    tr1.train(8)
    tr1.save()
    tr1.ckpt.wait()
    loss_ref = tr1.train(4).losses

    tr2 = trainer(run, SimulatedCluster([WorkerSpec(5.0, 0.5), WorkerSpec(7.0, 0.5)], seed=2), 4)
    assert tr2.try_restore()
    assert tr2.step == 8
    loss_resumed = tr2.train(4).losses
    np.testing.assert_allclose(loss_resumed, loss_ref, rtol=1e-4)


def _legacy_checkpoint(tmp_path):
    """A trainer's checkpoint whose scheduler state has the pre-fleet scalar
    ``ewma_count`` (a drifted shape)."""
    run = _run_cfg(tmp_path, steps=8)
    mk_cluster = lambda: SimulatedCluster([WorkerSpec(5.0, 0.5), WorkerSpec(6.0, 0.5)], seed=4)
    tr = trainer(run, mk_cluster(), 4)
    tr.train(2)
    legacy_sched = tr.partitioner.state._replace(ewma_count=torch.zeros((), dtype=torch.int32))
    tr.ckpt.save(
        tr.step,
        {"params": tr.params, "opt_state": tr.opt_state, "sched": legacy_sched},
        {"step": tr.step, "data_state": tr.data.state_dict()},
    )
    tr.ckpt.wait()
    return run, mk_cluster, tr


def test_try_restore_salvages_params_from_shape_drifted_checkpoint(tmp_path):
    """The drifted leaf resets to the fresh template's shape, the model's
    parameters are adopted bit for bit, and training resumes."""
    run, mk_cluster, tr = _legacy_checkpoint(tmp_path)
    tr2 = trainer(run, mk_cluster(), 4)
    assert tr2.try_restore() is True  # model params salvaged by name
    assert all(torch.equal(a, b) for a, b in zip(leaves(tr.params), leaves(tr2.params)))
    assert tr2.partitioner.state.ewma_count.shape == (2,)
    assert not tr2.partitioner.state.ewma_count.any()
    rep = tr2.train(2)
    assert np.isfinite(rep.losses[-1])


def test_try_restore_fresh_start_on_pre_keypath_checkpoint(tmp_path):
    """A checkpoint without key paths and with a drifted structure cannot be
    matched by name nor by position: a fresh start, reported as False."""
    run, mk_cluster, tr = _legacy_checkpoint(tmp_path)
    mpath = tmp_path / f"step_{tr.step:08d}" / "manifest.json"
    manifest = json.loads(mpath.read_text())
    del manifest["keypaths"]
    mpath.write_text(json.dumps(manifest))

    tr2 = trainer(run, mk_cluster(), 4)
    assert tr2.try_restore() is False
    rep = tr2.train(2)  # fresh start still trains
    assert np.isfinite(rep.losses[-1])


def test_straggler_soft_detection(tmp_path):
    run = _run_cfg(tmp_path, steps=30, straggler_threshold_sigma=2.0)
    cluster = SimulatedCluster([WorkerSpec(5.0, 0.3) for _ in range(4)], seed=3)
    tr = trainer(run, cluster, 8)
    tr.train(12)  # learn the healthy regime
    cluster.degrade(1, mu_factor=6.0)  # worker 1 becomes a straggler
    tr.train(12)
    assert any(e["type"] == "straggler" and 1 in e["workers"] for e in tr.monitor.events)


# --- against the reference trainer ------------------------------------------


def _reference_trainer(tmp_path, steps, m=4, **kw):
    from repro.configs import RunConfig as JRunConfig, get_arch as jget_arch, reduced as jreduced
    from repro.configs.base import ShapeConfig as JShapeConfig
    from repro.distributed.simulated_cluster import SimulatedCluster as JCluster
    from repro.distributed.simulated_cluster import WorkerSpec as JSpec
    from repro.train.trainer import Trainer as JTrainer

    run = JRunConfig(
        model=jreduced(jget_arch("smollm-135m")),
        shape=JShapeConfig("t", seq_len=32, global_batch=8, kind="train"),
        checkpoint_dir=str(tmp_path), total_steps=steps, warmup_steps=2, checkpoint_every=100,
        partitioner_refit_every=6, **kw)
    return JTrainer(run, cluster=JCluster([JSpec(5.0, 0.5), JSpec(7.0, 0.5)], seed=2),
                    num_microbatches=m)


def _port_trainer(tmp_path, steps, m=4, **kw):
    run = dataclasses.replace(_run_cfg(tmp_path, steps=steps, **kw), checkpoint_every=100)
    return trainer(run, SimulatedCluster([WorkerSpec(5.0, 0.5), WorkerSpec(7.0, 0.5)], seed=2), m)


def _host(tree):
    return jax.tree_util.tree_map(np.asarray, tree)


def test_eight_steps_match_the_reference_trainer_from_the_same_state(tmp_path):
    """Both trainers from the reference's initial parameters and moments
    (``convert``): the losses of 8 steps.  They do not depend on the split
    (every microbatch weighs 1 in both packages), so the packages' own
    random streams leave them alone.  rtol 1e-5: float32 at reduced width,
    with steps 2-8 taken by AdamW from gradients held at 1e-5 of their
    largest entry (tests/test_torch_train_step.py)."""
    ref = _reference_trainer(tmp_path / "ref", 8)
    port = _port_trainer(tmp_path / "port", 8)
    port.params = convert.model_params_from_jax(_host(ref.params), "cpu")
    port.opt_state = convert.adamw_state_from_jax(_host(ref.opt_state), "cpu")
    want = ref.train(8).losses
    got = port.train(8).losses
    np.testing.assert_allclose(got, want, rtol=1e-5)


@pytest.mark.parametrize("optimizer_dtype", ["float32", "bfloat16"])
def test_a_reference_trainer_checkpoint_restores_into_the_port(tmp_path, optimizer_dtype):
    """A reference trainer's checkpoint after 2 steps restores by name into
    the port's ``Trainer``, skipping only the random-key leaves (the port's
    scheduler carries a generator where the reference carries keys): the
    model, the moments, the scheduler's beliefs, the telemetry ring and the
    data cursor bit for bit; then both train 2 more steps to the same
    losses (rtol 1e-5, as above).  Both trainers keep float32 moments
    whatever ``optimizer_dtype`` says (read by the dry run alone), so at
    "bfloat16" too no moment is skipped on its dtype."""
    ref = _reference_trainer(tmp_path, 4, optimizer_dtype=optimizer_dtype)
    ref.train(2)
    ref.save()
    ref.ckpt.wait()

    port = _port_trainer(tmp_path, 4, optimizer_dtype=optimizer_dtype)
    assert all(x.dtype == torch.float32
               for x in leaves(port.opt_state.m) + leaves(port.opt_state.v))
    _, _, report = port.ckpt.restore_by_name(port._ckpt_tree())
    assert report["skipped"] == ["['sched'].generator"]
    assert port.try_restore() and port.step == 2
    assert all(x.dtype == torch.float32
               for x in leaves(port.opt_state.m) + leaves(port.opt_state.v))
    got = [leaves(t) for t in (port.params, port.opt_state.m, port.opt_state.v)]
    want = [jax.tree_util.tree_leaves(t) for t in (ref.params, ref.opt_state.m, ref.opt_state.v)]
    for g, w in zip(sum(got, []), sum(want, [])):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    assert int(port.opt_state.count) == int(ref.opt_state.count) == 2
    np.testing.assert_array_equal(port.partitioner.state.ewma_ll.numpy(),
                                  np.asarray(ref.partitioner.state.ewma_ll))
    np.testing.assert_array_equal(port._ring.times.numpy(), np.asarray(ref._ring.times))
    assert int(port._ring.count) == int(ref._ring.count) == 2
    assert port.data.state_dict() == ref.data.state_dict()
    np.testing.assert_allclose(port.train(2).losses, ref.train(2).losses, rtol=1e-5)


# --- the driver and the entry point -------------------------------------------


def test_launch_train_runs_and_resumes_as_a_subprocess(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1")
    argv = [sys.executable, "-m", "repro_torch.launch.train", "--device", "cpu", "--steps", "4",
            "--seq-len", "32", "--global-batch", "8", "--microbatches", "4", "--workers", "2",
            "--ckpt-dir", str(tmp_path)]
    first = subprocess.run(argv, cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert first.returncode == 0, first.stderr
    assert "steps=4 loss:" in first.stdout
    assert sorted(p.name for p in tmp_path.iterdir()) == ["step_00000002", "step_00000004"]
    second = subprocess.run(argv + ["--resume"], cwd=ROOT, env=env, capture_output=True, text=True,
                            timeout=300)
    assert second.returncode == 0, second.stderr
    assert "resumed from step 4" in second.stdout and "steps=8 loss:" in second.stdout
    loss = float(second.stdout.split("steps=8 loss:")[1].split("->")[1].splitlines()[0])
    assert np.isfinite(loss)


def test_entry_points_without_a_device_raise_on_a_cpu_machine(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: the entry points would use it")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(_run_cfg(tmp_path))
    from repro_torch.launch import train as launch_train

    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--steps", "1", "--ckpt-dir", str(tmp_path)])


def test_a_trainer_given_a_mesh_info_trains_and_anything_else_is_refused(tmp_path):
    """A ``MeshInfo`` over a one-rank gloo world's (1, 1) mesh trains, its
    losses those of the unsharded trainer (the parameters replicated
    DTensors); any other ``mesh_info`` raises a TypeError.  The 4-rank
    meshes are tests/test_torch_model_sharding.py's."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.models import MeshInfo

    with pytest.raises(TypeError, match="MeshInfo"):
        Trainer(_run_cfg(tmp_path), mesh_info=object(), device="cpu")
    run = _run_cfg(tmp_path / "plain", partitioner_enabled=False)
    plain = Trainer(run, num_microbatches=2, device="cpu").train(2).losses
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
        run = _run_cfg(tmp_path / "mesh", partitioner_enabled=False)
        tr = Trainer(run, num_microbatches=2, mesh_info=MeshInfo(mesh, ("data",), "model"),
                     device="cpu")
        assert isinstance(tr.params["embed"], DTensor)
        losses = tr.train(2).losses
    finally:
        dist.destroy_process_group()
    np.testing.assert_allclose(losses, plain, rtol=1e-5)


@pytest.mark.parametrize("kind", ["int8_ef", "topk_ef"])
def test_a_compressing_trainer_on_a_mesh_trains_as_the_unsharded_one(tmp_path, kind):
    """Gradient compression on the one-rank gloo world's (1, 1) mesh: the
    error feedback takes the parameters' placements and each replicated
    leaf is compressed whole, so the losses are the unsharded compressed
    trainer's; the error feedback stays a tree of replicated DTensors."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import DTensor

    from repro_torch.models import MeshInfo

    run = _run_cfg(tmp_path / "plain", partitioner_enabled=False, grad_compression=kind)
    plain = Trainer(run, num_microbatches=2, device="cpu").train(2).losses
    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
        run = _run_cfg(tmp_path / "mesh", partitioner_enabled=False, grad_compression=kind)
        tr = Trainer(run, num_microbatches=2, mesh_info=MeshInfo(mesh, ("data",), "model"),
                     device="cpu")
        losses = tr.train(2).losses
        ef = leaves(tr._ef)
        assert all(isinstance(e, DTensor) and e.placements == tr.params["embed"].placements
                   for e in ef)
    finally:
        dist.destroy_process_group()
    np.testing.assert_allclose(losses, plain, rtol=1e-5)


def test_compression_refuses_a_leaf_split_over_a_mesh(tmp_path):
    """A gradient sharded over a mesh dim is not compressed shard by shard:
    the compressor raises and names the placements."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import Shard, distribute_tensor

    from repro_torch.distributed.compression import init_error_feedback, make_compressor

    dist.init_process_group("gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
                            world_size=1)
    try:
        mesh = init_device_mesh("cpu", (1,), mesh_dim_names=("data",))
        g = {"w": distribute_tensor(torch.ones(4, 2), mesh, [Shard(0)], src_data_rank=None)}
        compress, _ = make_compressor("int8_ef", None)
        with pytest.raises(ValueError, match="replicated on every mesh dim"):
            compress(g, init_error_feedback(g))
    finally:
        dist.destroy_process_group()
