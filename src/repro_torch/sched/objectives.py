"""Pluggable partitioning objectives over the completion-time frontier.

PyTorch counterpart of ``repro.sched.objectives``.  One ``Objective`` value
encodes what "best split" means for every consumer — the K-simplex solver
(``sched.solve_fractions``), the two-way frontier sweep, and microbatch
quantization.  Scores are plain torch and differentiable; ``smooth=True``
swaps hard constraints and indicators for soft relaxations so the simplex
optimizer can follow gradients.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F
from torch import Tensor

# Hard-constraint violations are scored BIG + violation instead of inf so that
# argmin still orders infeasible points (and never returns NaN from inf-inf).
_BIG = 1e9


@dataclasses.dataclass(frozen=True)
class Objective:
    """What "best split" means.  Lower score is better.

    kind:
      "mean"        — E[t]                          (fastest expected)
      "mean_var"    — E[t] + risk_aversion * Var[t] (risk-sensitive)
      "var_budget"  — min E[t]  s.t.  Var[t] <= var_budget
      "deadline"    — max P(t <= deadline)          (QoS quantile target)

    >>> obj = Objective.mean_var(0.5)
    >>> float(obj.score_moments(torch.tensor(10.0), torch.tensor(4.0)))
    12.0
    """

    kind: str = "mean"
    risk_aversion: float = 0.0
    var_budget: float = math.inf
    deadline: float = 0.0

    def __post_init__(self):
        if self.kind not in ("mean", "mean_var", "var_budget", "deadline"):
            raise ValueError(f"unknown objective kind {self.kind!r}")

    @staticmethod
    def mean() -> "Objective":
        return Objective(kind="mean")

    @staticmethod
    def mean_var(risk_aversion: float) -> "Objective":
        return Objective(kind="mean_var", risk_aversion=float(risk_aversion))

    @staticmethod
    def variance_budget(var_budget: float) -> "Objective":
        return Objective(kind="var_budget", var_budget=float(var_budget))

    @staticmethod
    def deadline_quantile(deadline: float) -> "Objective":
        return Objective(kind="deadline", deadline=float(deadline))

    @staticmethod
    def from_legacy(
        objective: str,
        risk_aversion: float = 0.0,
        var_budget: float = math.inf,
        deadline: float = 0.0,
    ) -> "Objective":
        """Map the old ``frontier.optimal_two_way_fraction`` string API."""
        kind = {"constrained": "var_budget"}.get(objective, objective)
        return Objective(
            kind=kind,
            risk_aversion=float(risk_aversion),
            var_budget=float(var_budget),
            deadline=float(deadline),
        )

    def score_moments(self, e_t: Tensor, var: Tensor, *, smooth: bool = False) -> Tensor:
        """Score from completion-time moments alone (moment-based kinds only)."""
        return score_moments_dynamic(
            self.kind, e_t, var, self.risk_aversion, self.var_budget, smooth=smooth
        )

    def needs_cdf(self) -> bool:
        return self.kind == "deadline"


def as_stage_objectives(objectives, num_stages: int) -> tuple:
    """Normalize a per-stage objective spec to a validated tuple."""
    if isinstance(objectives, Objective):
        return (objectives,) * num_stages
    objectives = tuple(objectives)
    if len(objectives) != num_stages:
        raise ValueError(
            f"need one objective per stage: got {len(objectives)} "
            f"for {num_stages} stages"
        )
    for o in objectives:
        if not isinstance(o, Objective):
            raise TypeError(f"expected Objective, got {type(o).__name__}")
    return objectives


def score_moments_dynamic(
    kind: str,
    e_t: Tensor,
    var: Tensor,
    risk_aversion,
    var_budget,
    *,
    smooth: bool = False,
) -> Tensor:
    """Moment-based scoring with the parameters as floats or tensors."""
    if kind == "mean":
        return e_t
    if kind == "mean_var":
        return e_t + risk_aversion * var
    if kind == "var_budget":
        excess = var - var_budget
        if smooth:
            # softplus barrier keeps the score differentiable; the sharp
            # scale makes the feasible region's boundary steep.
            return e_t + F.softplus(20.0 * excess)
        return torch.where(excess <= 0, e_t, _BIG + excess)
    raise ValueError(f"objective {kind!r} is not moment-based")


def evaluate(
    objective: Objective,
    fracs: Tensor,
    params,
    *,
    num_points: int = 512,
    smooth: bool = False,
    risk_aversion=None,
    var_budget=None,
    deadline=None,
) -> Tensor:
    """Score fraction vectors (..., K) on the simplex -> (...).  Lower is better.

    Differentiable in ``fracs``; ``params`` is a ``frontier.UnitParams``.
    ``risk_aversion`` / ``var_budget`` / ``deadline`` override the
    objective's floats when given.
    """
    from repro_torch.core.frontier import completion_cdf, mean_var_completion

    if objective.needs_cdf():
        d = objective.deadline if deadline is None else deadline
        p_meet = completion_cdf(d, fracs, params)
        if smooth:
            return -torch.log(torch.clamp(p_meet, min=1e-12))
        return -p_meet
    e_t, var = mean_var_completion(fracs, params, num_points)
    return score_moments_dynamic(
        objective.kind,
        e_t,
        var,
        objective.risk_aversion if risk_aversion is None else risk_aversion,
        objective.var_budget if var_budget is None else var_budget,
        smooth=smooth,
    )
