"""Fleet hyperprior on PyTorch: hierarchical empirical-Bayes pooling across
workers.  Counterpart of ``repro.hier``, the refit over a fleet mesh
(:func:`fit_hyperprior_sharded`) included.

:func:`fit_hyperprior` pools the per-worker posteriors into fleet-level
hyperparameters, :func:`shrink` blends cold workers toward the fleet mean
with an effective-sample-size weight, and :func:`surprise` scores each
worker against the pooled prior — the drift statistic behind the serve gate.
Opt in via ``sched.SchedulerConfig(hierarchical=True)``.
"""
from .hyperprior import (
    DEFAULT_STRENGTH,
    Hyperprior,
    HyperStats,
    effective_sample_size,
    fit_hyperprior,
    fit_hyperprior_sharded,
    hyper_from_stats,
    hyper_init,
    hyper_stats,
    init_from_hyperprior,
    shrink,
    shrinkage_weight,
    surprise,
)

__all__ = [
    "DEFAULT_STRENGTH",
    "Hyperprior",
    "HyperStats",
    "effective_sample_size",
    "fit_hyperprior",
    "fit_hyperprior_sharded",
    "hyper_from_stats",
    "hyper_init",
    "hyper_stats",
    "init_from_hyperprior",
    "shrink",
    "shrinkage_weight",
    "surprise",
]
