"""The paper's contribution on PyTorch: Bayesian estimation of
processing-unit models and frontier-optimal workflow partitioning (Chua &
Huberman 2015).  Counterpart of ``repro.core``; ``ShardingConfig`` splits the
fleet axis of the estimator across the ranks of a torch ``DeviceMesh``.

The legacy partitioner names (``HeterogeneityAwarePartitioner``,
``WorkerTelemetry``, ``optimize_fractions``, ``quantize_fractions``) resolve
lazily from ``repro_torch.sched.compat``, which builds on this package: so
importing ``core`` does not import ``sched``.
"""
from .distributions import (
    beta_logpdf,
    gamma_logpdf,
    normal_cdf,
    normal_logpdf,
    sample_beta,
    sample_gamma,
    sample_normal,
)
from .frontier import (
    UnitParams,
    completion_cdf,
    dag_completion_moments,
    mean_var_completion,
    optimal_two_way_fraction,
    parallel_max_moments,
    pareto_mask,
    serial_moments,
    sweep_two_way,
)
from .compress import (
    CompressionReport,
    beta_moments,
    compression_report,
    fit_lognormal_moments,
    fit_surrogate,
    grid_moments,
    select_active,
    surrogate_gap,
    surrogate_moments,
)
from .gibbs import GibbsState, fit, fit_dag, fit_fleet, gibbs_batch, init_state
from .moments import (
    BetaParams,
    exponent_grid,
    fit_beta_method_of_moments,
    log_posterior_alpha_ref,
    log_posterior_beta_ref,
    log_posterior_grid,
    moments_from_log_density,
    update_alpha_beta_params,
)
from .posterior import (
    NormalGammaParams,
    log_likelihood,
    posterior_predictive_logpdf,
    update_normal_gamma,
)
from .sharding import ShardingConfig, constrain_fleet, shard_fleet_map

__all__ = [
    "BetaParams",
    "CompressionReport",
    "GibbsState",
    "HeterogeneityAwarePartitioner",
    "NormalGammaParams",
    "ShardingConfig",
    "UnitParams",
    "WorkerTelemetry",
    "beta_logpdf",
    "beta_moments",
    "completion_cdf",
    "compression_report",
    "constrain_fleet",
    "dag_completion_moments",
    "exponent_grid",
    "fit",
    "fit_beta_method_of_moments",
    "fit_dag",
    "fit_fleet",
    "fit_lognormal_moments",
    "fit_surrogate",
    "gamma_logpdf",
    "gibbs_batch",
    "grid_moments",
    "init_state",
    "log_likelihood",
    "log_posterior_alpha_ref",
    "log_posterior_beta_ref",
    "log_posterior_grid",
    "mean_var_completion",
    "moments_from_log_density",
    "normal_cdf",
    "normal_logpdf",
    "optimal_two_way_fraction",
    "optimize_fractions",
    "parallel_max_moments",
    "pareto_mask",
    "posterior_predictive_logpdf",
    "quantize_fractions",
    "sample_beta",
    "sample_gamma",
    "sample_normal",
    "select_active",
    "serial_moments",
    "shard_fleet_map",
    "surrogate_gap",
    "surrogate_moments",
    "sweep_two_way",
    "update_alpha_beta_params",
    "update_normal_gamma",
]

from . import partitioner as _partitioner  # imports nothing of sched until a name is read


def __getattr__(name):
    if name in _partitioner.__all__:
        return getattr(_partitioner, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
