"""Online scheduler on PyTorch: learn from telemetry, propose a split,
quantize it, score anomalies.  Counterpart of ``repro.sched`` for a fleet of
fixed size (capacity slots, DAGs and the imperative shell come later).
"""
from .objectives import Objective, as_stage_objectives, evaluate
from .quantize import quantize_fractions
from .scheduler import (
    ProposeStats,
    SchedulerConfig,
    SchedulerState,
    Telemetry,
    advance_fleet,
    anomaly,
    flag_stragglers,
    init,
    observe,
    propose,
    solve_fractions,
    unit_params,
    unit_params_from_gibbs,
)

__all__ = [
    "Objective",
    "ProposeStats",
    "SchedulerConfig",
    "SchedulerState",
    "Telemetry",
    "advance_fleet",
    "anomaly",
    "as_stage_objectives",
    "evaluate",
    "flag_stragglers",
    "init",
    "observe",
    "propose",
    "quantize_fractions",
    "solve_fractions",
    "unit_params",
    "unit_params_from_gibbs",
]
