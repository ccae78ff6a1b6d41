"""Production training loop with the paper's Bayesian partitioner in charge
of heterogeneous work assignment, plus checkpoint/restart and fault handling.

The port's counterpart of ``repro.train.trainer``.  Flow per step:
  1. data iterator -> (M, B/M, seq) microbatched global batch
  2. train step with per-microbatch weights (the current split)
  3. telemetry: per-worker step times (simulated by ``SimulatedCluster``)
     -> FaultToleranceMonitor
  4. every ``partitioner_refit_every`` steps: Gibbs-update posteriors, emit a
     new microbatch split (quantized efficient-frontier fractions)
  5. failures -> evict worker, re-split, continue (elastic); checkpoints are
     atomic and restart-resumable (params, optimizer, data cursor, the
     scheduler's beliefs and generator, the telemetry ring)

``Trainer`` is an entry point: it runs on the card unless ``device`` names
another device.  Given a ``models.MeshInfo`` it trains on that mesh, as the
reference's trainer does: the parameters and the AdamW state stay unplaced
(replicated DTensors), and the model stack places the batch and its
activations (``ApplyCtx.mesh_info``).  Its checkpoint tree keeps the reference's key paths
(``['params']``, ``['opt_state'].m``, ``['sched']``, ``['serve']``), so a
reference checkpoint restores into it by name, less the random-key leaves.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Optional

import numpy as np
import torch

from ..checkpoint.checkpoint import CheckpointManager
from ..configs.base import RunConfig
from ..data.pipeline import DataIterator
from ..device import resolve_device
from ..distributed.compression import make_compressor
from ..distributed.fault_tolerance import FaultToleranceMonitor
from ..distributed.simulated_cluster import SimulatedCluster
from ..hier.hyperprior import hyper_init
from ..distributed.sharding import replicated_specs, shard_tree
from ..models import model_zoo
from ..models.layers import ApplyCtx, MeshInfo
from ..optim import adamw
from ..sched import Objective, Scheduler, SchedulerConfig, Telemetry
from ..serve import ring as serve_ring
from ..serve.gate import GateState, gate_init, gate_update
from ..serve.service import posterior_drift
from . import train_step as ts


@dataclasses.dataclass
class TrainerReport:
    steps: int
    losses: List[float]
    splits: List[np.ndarray]
    makespans: List[float]
    events: List[Dict]


class Trainer:
    def __init__(
        self,
        run: RunConfig,
        *,
        cluster: Optional[SimulatedCluster] = None,
        num_microbatches: Optional[int] = None,
        mesh_info: Optional[MeshInfo] = None,
        scheduler_config: Optional[SchedulerConfig] = None,
        device=None,
    ):
        """``scheduler_config`` overrides the default partitioner config.  A
        config whose objective is the default (mean) still honors the run's
        ``partitioner_risk_aversion``; any non-default objective wins as-is.
        ``mesh_info`` (a ``MeshInfo`` over a ``DeviceMesh`` of the device's
        type, every rank running the same trainer) trains on the mesh.  The
        moments are float32 whatever ``run.optimizer_dtype`` says, as the
        reference's trainer keeps them; that setting is read by the dry run
        alone (ROADMAP item 13)."""
        if mesh_info is not None and not isinstance(mesh_info, MeshInfo):
            raise TypeError(f"mesh_info must be a repro_torch.models.MeshInfo or None, "
                            f"not {type(mesh_info).__name__}")
        self.device = resolve_device(device)
        self.run = run
        self.cfg = run.model
        self.cluster = cluster
        self.mesh_info = mesh_info
        self.m = num_microbatches or max(run.shape.global_batch // 8, 1)

        self.params = model_zoo.init_model_params(self.cfg, seed=run.seed, device=self.device)
        self.opt_state = adamw.init(self.params)
        if mesh_info is not None:  # every rank made the same values: replicate them
            mesh = mesh_info.mesh
            replicate = lambda tree: shard_tree(tree, replicated_specs(tree), mesh)
            self.params = replicate(self.params)
            self.opt_state = adamw.AdamWState(*(replicate(x) for x in self.opt_state))
        self.step = 0

        self.ctx = ApplyCtx(mode="train", mesh_info=mesh_info, remat=run.remat)
        compression = None
        self._ef = None
        if run.grad_compression != "none":
            compression, init_ef = make_compressor(run.grad_compression, None)
            self._ef = init_ef(self.params)

        self._step_fn = ts.make_train_step(self.cfg, run, ctx=self.ctx,
                                           num_microbatches=self.m, compression=compression)

        self.data = DataIterator(
            vocab_size=self.cfg.vocab_size,
            seq_len=run.shape.seq_len,
            global_batch=run.shape.global_batch,
            num_microbatches=self.m,
            seed=run.seed,
        )
        self.ckpt = CheckpointManager(run.checkpoint_dir, keep=run.keep_checkpoints)

        # --- the paper's scheduler -----------------------------------------
        self.partitioner = None
        self.monitor = None
        # never reassigned, as in the reference: the split moves the
        # simulated step times, not the gradient weights
        self._mb_weights = np.ones(self.m, np.float32)
        self._worker_of_mb = None
        if run.partitioner_enabled and cluster is not None:
            ra = run.partitioner_risk_aversion
            sched_cfg = scheduler_config or SchedulerConfig(mu_guess=1.0)
            if sched_cfg.objective == Objective():
                sched_cfg = dataclasses.replace(
                    sched_cfg,
                    objective=Objective.mean_var(ra) if ra else Objective.mean(),
                )
            self.partitioner = Scheduler(cluster.num_workers, config=sched_cfg, seed=run.seed,
                                         device=self.device)
            self.monitor = FaultToleranceMonitor(
                self.partitioner,
                straggler_sigma=run.straggler_threshold_sigma,
                heartbeat_timeout=1e9,  # simulated clock; evict on inf times
            )
            self._assign_microbatches(equal=True)
            self._init_serve_state()

    # ---------------------------------------------------------------- serve
    def _init_serve_state(self) -> None:
        """Fresh push-mode telemetry state: a device-resident ring buffering
        per-step telemetry between drains, the posterior snapshot at the last
        split, a staleness counter, the drift gate and the pooled fleet
        prior.  Rebuilt whenever the fleet changes shape."""
        k = self.partitioner.num_workers
        # 2x headroom so a late drain degrades to dropped-oldest telemetry
        self._ring = serve_ring.ring_init(2 * self.run.partitioner_refit_every, k,
                                          device=self.device)
        self._ref_params = self.partitioner.unit_params()
        # Saturated staleness: the first drain always proposes.
        self._staleness = self.run.partitioner_max_staleness
        self._gate = gate_init(self.device)
        self._hyper = hyper_init(self.partitioner.config.mu_guess, device=self.device)
        self._hyper_age = self.partitioner.config.hyper_refit_every

    # ------------------------------------------------------------------ utils
    def _assign_microbatches(self, equal: bool = False) -> np.ndarray:
        """Map microbatches to workers per the current frontier split."""
        k = self.partitioner.num_workers
        if equal:
            counts = np.full(k, self.m // k, np.int64)
            counts[: self.m % k] += 1
        else:
            counts = self.partitioner.propose_microbatches(self.m)
        self._worker_of_mb = np.repeat(np.arange(k), counts)[: self.m]
        return counts

    def current_fracs(self) -> np.ndarray:
        k = self.partitioner.num_workers
        counts = np.bincount(self._worker_of_mb, minlength=k)
        return counts / counts.sum()

    # ------------------------------------------------------------------ resume
    def _ckpt_tree(self) -> Any:
        """Everything checkpointed as one tree: the model, the optimizer, and
        with a partitioner its beliefs and the push-mode telemetry state."""
        tree = {"params": self.params, "opt_state": self.opt_state}
        if self.partitioner is not None:
            i32 = lambda x: torch.tensor(x, dtype=torch.int32, device=self.device)
            tree["sched"] = self.partitioner.state
            tree["serve"] = {
                "ring": self._ring,
                "ref": self._ref_params,
                "staleness": i32(self._staleness),
                "gate": self._gate,
                "hyper": self._hyper,
                "hyper_age": i32(self._hyper_age),
            }
        return tree

    def try_restore(self) -> bool:
        """Restore the latest checkpoint; False (a fresh start) if there is
        none or its model or optimizer state cannot be restored whole."""
        latest = self.ckpt.latest_step()
        if latest is None:
            return False
        template = self._ckpt_tree()
        try:
            restored, extra = self.ckpt.restore(template)
        except ValueError:
            # Structure drifted (partitioner toggled, a drifted scheduler
            # leaf, a reference checkpoint's key leaves): restore by name,
            # each drifted leaf resetting only itself, but the model and the
            # optimizer must restore completely.
            try:
                restored, extra, report = self.ckpt.restore_by_name(template)
                if any(kp.startswith(("['params']", "['opt_state']")) for kp in report["skipped"]):
                    return False
            except ValueError:
                # Pre-keypath checkpoint: the positional model-only layout is
                # the last resort; if even that fails, start fresh.
                try:
                    restored, extra = self.ckpt.restore(
                        {"params": self.params, "opt_state": self.opt_state})
                except ValueError:
                    return False
        self.params = restored["params"]
        self.opt_state = restored["opt_state"]
        sched_state = restored.get("sched")
        if self.partitioner is not None and sched_state is not None:
            # Adopt saved beliefs only if the fleet shape still matches.
            if len(sched_state.ewma_ll) == self.partitioner.num_workers:
                self.partitioner.state = sched_state
                serve_tree = restored.get("serve")
                if serve_tree is not None:
                    self._ring = serve_tree["ring"]
                    self._ref_params = serve_tree["ref"]
                    self._staleness = int(serve_tree["staleness"])
                    if "gate" in serve_tree:
                        self._gate = GateState(*serve_tree["gate"])
                    if "hyper" in serve_tree:
                        self._hyper = serve_tree["hyper"]
                    if "hyper_age" in serve_tree:
                        self._hyper_age = int(serve_tree["hyper_age"])
                self._assign_microbatches(equal=False)
        self.step = int(extra["step"])
        self.data.load_state_dict(extra["data_state"])
        return True

    def save(self) -> None:
        self.ckpt.save(self.step, self._ckpt_tree(),
                       {"step": self.step, "data_state": self.data.state_dict()})

    # ------------------------------------------------------------------ loop
    def train(self, steps: int, log_every: int = 10) -> TrainerReport:
        losses, splits, makespans = [], [], []
        run = self.run
        for _ in range(steps):
            batch = {k: torch.as_tensor(v).to(self.device) for k, v in next(self.data).items()}
            weights = torch.as_tensor(self._mb_weights).to(self.device)
            if self._ef is not None:
                self.params, self.opt_state, metrics, self._ef = self._step_fn(
                    self.params, self.opt_state, batch, self.step, weights, self._ef)
            else:
                self.params, self.opt_state, metrics = self._step_fn(
                    self.params, self.opt_state, batch, self.step, weights)
            losses.append(float(metrics["loss"]))
            self.step += 1

            # ---- telemetry + the paper's scheduler -------------------------
            if self.partitioner is not None:
                fracs = self.current_fracs()
                times = self.cluster.step_times(fracs)
                flags = self.monitor.observe_step(fracs, times)
                finite = np.isfinite(times)
                makespans.append(float(np.max(times[finite])) if finite.any() else float("inf"))
                # one ring push per step; non-finite times ride in masked out
                self._ring = serve_ring.push(
                    self._ring,
                    torch.as_tensor(fracs, dtype=torch.float32),
                    torch.as_tensor(np.where(finite, times, 1.0), dtype=torch.float32),
                    torch.as_tensor(finite, dtype=torch.float32),
                )

                if flags["failures"].any():
                    # elastic: evict, re-split, checkpoint the new world
                    alive = ~flags["failures"]
                    self.cluster.specs = [s for s, a in zip(self.cluster.specs, alive) if a]
                    self.monitor.evict(flags["failures"])
                    self._assign_microbatches(equal=False)
                    self._init_serve_state()
                    self.save()

                if self.step % run.partitioner_refit_every == 0 and int(self._ring.count) > 0:
                    drained, self._ring = serve_ring.drain(self._ring)
                    self.partitioner.observe(Telemetry(fracs=drained.fracs, times=drained.times),
                                             mask=drained.mask)
                    # re-solve the split only when the posterior moved (or
                    # the split got too stale): the serve cadence policy
                    cur = self.partitioner.unit_params()
                    if self.partitioner.config.hierarchical:
                        self._hyper_age += 1
                        if self._hyper_age >= self.partitioner.config.hyper_refit_every:
                            self._hyper = self.partitioner.fit_hyperprior()
                            self._hyper_age = 0
                        drift = float(np.max(self.partitioner.surprise(self._hyper)))
                    else:
                        drift = float(posterior_drift(self._ref_params, cur))
                    self._staleness += 1
                    thr = run.partitioner_drift_threshold
                    if thr is None:
                        fired, self._gate = gate_update(self._gate, drift)
                        moved = bool(fired)
                    else:
                        moved = drift > thr
                    if moved or self._staleness >= run.partitioner_max_staleness:
                        counts = self._assign_microbatches(equal=False)
                        splits.append(counts.copy())
                        self._ref_params = cur
                        self._staleness = 0

            if self.step % run.checkpoint_every == 0:
                self.save()
        self.ckpt.wait()
        events = self.monitor.events if self.monitor else []
        return TrainerReport(self.step, losses, splits, makespans, events)
