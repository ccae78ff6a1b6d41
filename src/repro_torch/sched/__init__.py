"""Online scheduler on PyTorch: learn from telemetry, propose a split,
quantize it, score anomalies, admit and retire workers.  Counterpart of
``repro.sched``; ``SchedulerConfig(mesh=ShardingConfig(...))`` splits the
fleet axis across the ranks of a torch ``DeviceMesh``.

Multi-stage pipelines lift the same API to workflow DAGs (``sched.dag``):

    state = sched.init_dag(config, dag, seed)                    # dag: WorkflowDAG
    state, ll    = sched.observe_dag(state, telemetry, config)  # (S, K, N)
    fracs, stats = sched.propose_dag(state, dag, config)        # (S, K)

Estimation of the whole DAG is one stacked (S*K)-worker fleet advance: one
K1 launch per Gibbs sweep on a card.

The legacy partitioner API (``HeterogeneityAwarePartitioner``,
``optimize_fractions``, the positional-``risk_aversion``
``quantize_fractions``) is the submodule ``sched.compat``, as in the
reference; its names are not exported here.
"""
from repro_torch.sharding import ShardingConfig

from .dag import (
    DagProposeStats,
    DagState,
    WorkflowDAG,
    dag_stats,
    effective_stage_moments,
    init_dag,
    observe_dag,
    path_lengths,
    propose_dag,
    stage_params,
    uniform_fractions,
)
from .objectives import Objective, as_stage_objectives, evaluate
from .quantize import quantize_dag_fractions, quantize_fractions
from .scheduler import (
    ProposeStats,
    Scheduler,
    SchedulerConfig,
    SchedulerState,
    Telemetry,
    add_workers,
    admit_workers,
    advance_fleet,
    anomaly,
    capacity,
    flag_stragglers,
    grow_capacity,
    init,
    num_workers,
    observe,
    propose,
    remove_workers,
    retire_workers,
    solve_fractions,
    unit_params,
    unit_params_from_gibbs,
)

__all__ = [
    "DagProposeStats",
    "DagState",
    "Objective",
    "ProposeStats",
    "Scheduler",
    "SchedulerConfig",
    "SchedulerState",
    "ShardingConfig",
    "Telemetry",
    "WorkflowDAG",
    "add_workers",
    "admit_workers",
    "advance_fleet",
    "anomaly",
    "as_stage_objectives",
    "capacity",
    "dag_stats",
    "effective_stage_moments",
    "evaluate",
    "flag_stragglers",
    "grow_capacity",
    "init",
    "init_dag",
    "num_workers",
    "observe",
    "observe_dag",
    "path_lengths",
    "propose",
    "propose_dag",
    "quantize_dag_fractions",
    "quantize_fractions",
    "remove_workers",
    "retire_workers",
    "solve_fractions",
    "stage_params",
    "uniform_fractions",
    "unit_params",
    "unit_params_from_gibbs",
]
