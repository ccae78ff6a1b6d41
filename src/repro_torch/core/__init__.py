"""The paper's contribution on PyTorch: Bayesian estimation of
processing-unit models and frontier-optimal workflow partitioning (Chua &
Huberman 2015).  Counterpart of ``repro.core`` for what the port has so far.
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
    mean_var_completion,
    optimal_two_way_fraction,
    pareto_mask,
    sweep_two_way,
)
from .gibbs import GibbsState, fit, fit_dag, fit_fleet, gibbs_batch, init_state
from .moments import (
    BetaParams,
    exponent_grid,
    fit_beta_method_of_moments,
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

__all__ = [
    "BetaParams",
    "GibbsState",
    "NormalGammaParams",
    "UnitParams",
    "beta_logpdf",
    "completion_cdf",
    "exponent_grid",
    "fit",
    "fit_beta_method_of_moments",
    "fit_dag",
    "fit_fleet",
    "gamma_logpdf",
    "gibbs_batch",
    "init_state",
    "log_likelihood",
    "log_posterior_grid",
    "mean_var_completion",
    "moments_from_log_density",
    "normal_cdf",
    "normal_logpdf",
    "optimal_two_way_fraction",
    "pareto_mask",
    "posterior_predictive_logpdf",
    "sample_beta",
    "sample_gamma",
    "sample_normal",
    "sweep_two_way",
    "update_alpha_beta_params",
    "update_normal_gamma",
]
