"""Simulated heterogeneous cluster for the partitioned-serving driver.

PyTorch counterpart of ``repro.distributed.simulated_cluster``.  Each worker
has ground-truth paper-model parameters (mu, sigma, alpha, beta):
processing a workload fraction f takes N(f^alpha mu, (f^beta sigma)^2)
seconds.  The estimator must recover them online and partition work
accordingly.  Supports drift (a worker's mu inflates) and failures (a worker
stops responding: its time is inf).  Times are drawn on the host with numpy.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from repro_torch.core.frontier import UnitParams, mean_var_completion


@dataclasses.dataclass
class WorkerSpec:
    mu: float
    sigma: float
    alpha: float = 0.9
    beta: float = 0.8
    alive: bool = True


class SimulatedCluster:
    def __init__(self, specs: List[WorkerSpec], seed: int = 0):
        self.specs = list(specs)
        self.rng = np.random.default_rng(seed)
        self.clock = 0.0

    @property
    def num_workers(self) -> int:
        return len(self.specs)

    def step_times(self, fracs: np.ndarray) -> np.ndarray:
        """Observed completion times for one parallel step with split fracs."""
        out = np.zeros(len(self.specs))
        for i, (spec, f) in enumerate(zip(self.specs, fracs)):
            if not spec.alive:
                out[i] = np.inf  # heartbeat timeout
                continue
            f = max(float(f), 1e-6)
            mean = f**spec.alpha * spec.mu
            std = f**spec.beta * spec.sigma
            out[i] = max(self.rng.normal(mean, std), 1e-6)
        self.clock += np.max(out[np.isfinite(out)]) if np.isfinite(out).any() else 0.0
        return out

    # -- dynamic events -----------------------------------------------------
    def degrade(self, worker: int, mu_factor: float = 3.0) -> None:
        """Make a worker a straggler (thermal throttle, noisy neighbour...)."""
        self.specs[worker].mu *= mu_factor

    def fail(self, worker: int) -> None:
        self.specs[worker].alive = False

    def recover(self, worker: int) -> None:
        self.specs[worker].alive = True

    def true_params(self) -> UnitParams:
        return UnitParams.of(
            [s.mu for s in self.specs],
            [s.sigma for s in self.specs],
            [s.alpha for s in self.specs],
            [s.beta for s in self.specs],
        )

    def oracle_makespan(self, fracs: np.ndarray) -> float:
        """Expected makespan under the TRUE parameters (evaluation metric),
        by the port's ``core.frontier`` on the CPU."""
        alive = [i for i, s in enumerate(self.specs) if s.alive]
        p = self.true_params()
        pa = UnitParams(*(x[alive] for x in p))
        f = torch.as_tensor(np.asarray(fracs, np.float32)[alive])
        e, _ = mean_var_completion(f, pa)
        return float(e)
