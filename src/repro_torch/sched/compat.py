"""Legacy partitioner API on the port, kept for pre-``sched`` callers.

Counterpart of ``repro.sched.compat``.  The online partitioning API lives in
``repro_torch.sched`` (``SchedulerState``, pluggable ``Objective``, the
``Scheduler`` shell).  This module keeps the original partitioner entry
points working:

  * ``optimize_fractions`` / ``quantize_fractions`` — thin delegates with the
    legacy ``risk_aversion`` float mapped onto ``Objective.mean_var``;
  * ``WorkerTelemetry`` — alias of ``sched.Telemetry``;
  * ``HeterogeneityAwarePartitioner`` — deprecated wrapper around
    ``sched.Scheduler`` (emits ``DeprecationWarning`` on construction).

It lives in ``sched`` (not ``core``) because it wraps the scheduler;
``repro_torch.core.partitioner`` re-exports these names lazily for the old
import path.  New code should import from ``repro_torch.sched`` directly.
"""
from __future__ import annotations

import warnings
from typing import Optional, Tuple

import numpy as np
from torch import Tensor

from repro_torch.core.frontier import UnitParams

from .objectives import Objective
from .quantize import quantize_fractions as _quantize
from .scheduler import Scheduler, SchedulerConfig, Telemetry, solve_fractions

# Legacy name: telemetry batches are plain (fracs, times) pairs.
WorkerTelemetry = Telemetry


def _legacy_objective(risk_aversion: float) -> Objective:
    return Objective.mean_var(risk_aversion) if risk_aversion else Objective.mean()


def optimize_fractions(
    params: UnitParams,
    *,
    risk_aversion: float = 0.0,
    steps: int = 300,
    lr: float = 0.05,
) -> Tuple[Tensor, Tensor, Tensor]:
    """Frontier point on the K-simplex: min E[max_k t_k] + ra * Var.

    Legacy signature; delegates to ``sched.solve_fractions``.  Returns
    (fractions, expected_makespan, variance) on ``params``' device.
    """
    fracs, stats = solve_fractions(
        params, objective=_legacy_objective(risk_aversion), steps=steps, lr=lr
    )
    return fracs, stats.e_t, stats.var


def quantize_fractions(
    fracs: np.ndarray,
    total_microbatches: int,
    params: Optional[UnitParams] = None,
    risk_aversion: float = 0.0,
    min_per_worker: int = 1,
    refine_passes: int = 4,
) -> np.ndarray:
    """Round simplex fractions to integer microbatch counts summing to total.

    Legacy signature (``risk_aversion`` positional); delegates to
    ``sched.quantize_fractions``, whose refinement runs on ``params``'
    device.
    """
    return _quantize(
        fracs,
        total_microbatches,
        params,
        objective=_legacy_objective(risk_aversion),
        min_per_worker=min_per_worker,
        refine_passes=refine_passes,
    )


class HeterogeneityAwarePartitioner(Scheduler):
    """Deprecated: use ``repro_torch.sched.Scheduler`` (or the pure functions).

    Preserves the original constructor and the mutable ``risk_aversion``
    attribute; everything else is inherited from the imperative shell.  An
    entry point: runs on CUDA unless ``device`` says otherwise.
    """

    def __init__(
        self,
        num_workers: int,
        *,
        seed: int = 0,
        risk_aversion: float = 0.0,
        n_iters: int = 20,
        grid_size: int = 256,
        mu_guess: float = 1.0,
        discount: float = 0.9,
        device=None,
    ):
        warnings.warn(
            "HeterogeneityAwarePartitioner is deprecated; use "
            "repro_torch.sched.Scheduler or the pure repro_torch.sched API",
            DeprecationWarning,
            stacklevel=2,
        )
        super().__init__(
            num_workers,
            config=SchedulerConfig(
                objective=_legacy_objective(risk_aversion),
                n_iters=n_iters,
                grid_size=grid_size,
                mu_guess=mu_guess,
                discount=discount,
            ),
            seed=seed,
            device=device,
        )

    @property
    def risk_aversion(self) -> float:
        return self.config.objective.risk_aversion

    @risk_aversion.setter
    def risk_aversion(self, value: float) -> None:
        self.objective = _legacy_objective(value)
