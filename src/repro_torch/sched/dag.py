"""Stage-structured workflow DAGs: stacked estimation + composed frontier.

PyTorch counterpart of ``repro.sched.dag``.  The paper partitions one
workflow stage across K uncertain units; this module lifts the scheduler
from a simplex to a graph of S stages:

  * ``WorkflowDAG``: the static topology, a frozen, hashable dataclass of
    Python tuples.  ``preds[i]`` lists stage i's predecessors (every index
    < i).  Optional per-stage annotations make the topology stochastic:
    ``exec_probs`` (conditional branches), ``rework_probs`` with
    ``max_retries`` (geometric rework loops), and ``stage_workers``
    (narrower stages; columns past a stage's width are dead, masked out of
    estimation and given exactly 0 of the split).
  * ``DagState``: one ``GibbsState`` with (S, K) leaves and the DAG's
    ``torch.Generator``.  ``observe_dag`` folds the stage axis into the
    fleet axis and advances the whole (S, K, N) block through the port's
    ``advance_fleet``: on a card each Gibbs sweep is one K1 launch over S*K
    workers.  The annotations change nothing here: the estimator learns
    per-attempt worker behaviour.
  * ``propose_dag``: stage splits against the shared ``Objective`` (or a
    per-stage ``objectives`` tuple).  Every stage solve of one kind runs as
    one row-batched ``solve_fractions``, not as a loop over stages.  On a
    stochastic DAG the cross-stage allocation runs on effective stage
    moments (``effective_stage_moments``), and a joint refinement descends
    on all S*K logits against the composed objective, kept only if it
    scores better.

Degenerate annotations (p = 1 branches, zero rework, cap 1) are detected
statically (``is_stochastic``) and take the deterministic path bit for bit.
Nothing in ``observe_dag`` or ``propose_dag`` waits for the device: the
topology is Python, every choice is a tensor ``where``, and the per-stage
constants are copied to the card without a sync (``device.host_constant``).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
from torch import Tensor

from repro_torch.core import gibbs
from repro_torch.core.distributions import normal_cdf
from repro_torch.core.frontier import (
    UnitParams,
    dag_completion_moments,
    mean_var_completion,
    stochastic_stage_moments,
    truncated_geometric_moments,
)
from repro_torch.device import host_constant, resolve_device

from .objectives import Objective, as_stage_objectives, score_moments_dynamic
from .scheduler import (
    SchedulerConfig,
    Telemetry,
    advance_fleet,
    solve_fractions,
    unit_params_from_gibbs,
)


# --------------------------------------------------------------------------
# topology
# --------------------------------------------------------------------------
@dataclasses.dataclass(frozen=True)
class WorkflowDAG:
    """Static topology of a stage-structured workflow.

    ``preds[i]`` lists the stages that must finish before stage i starts;
    stages are numbered topologically (every predecessor index < i), so the
    graph is acyclic by construction.  ``num_workers`` is the per-stage
    fleet width K; ``stage_workers`` optionally narrows stages (K_s <= K).

    Stochastic annotations (optional per-stage tuples):

      exec_probs[i]    probability that stage i executes at all; a skipped
                       stage takes no time but forwards its predecessors'
                       finish.
      rework_probs[i]  probability that an attempt of stage i must be redone,
                       so attempt counts are Geometric(1 - rework_probs[i]) ...
      max_retries[i]   ... truncated at this cap (8 when ``rework_probs`` is
                       given without it).
    """

    preds: Tuple[Tuple[int, ...], ...]
    num_workers: int
    names: Optional[Tuple[str, ...]] = None
    exec_probs: Optional[Tuple[float, ...]] = None
    rework_probs: Optional[Tuple[float, ...]] = None
    max_retries: Optional[Tuple[int, ...]] = None
    stage_workers: Optional[Tuple[int, ...]] = None

    def __post_init__(self):
        if self.num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        for i, ps in enumerate(self.preds):
            for p in ps:
                if not 0 <= p < i:
                    raise ValueError(
                        f"stage {i} depends on stage {p}: stages must be "
                        "numbered topologically (predecessor < successor); "
                        "cycles are unrepresentable"
                    )
        s = len(self.preds)
        if self.names is not None and len(self.names) != s:
            raise ValueError("names must match num_stages")
        # Normalize annotations to plain tuples (hashable).
        for field in ("exec_probs", "rework_probs"):
            val = getattr(self, field)
            if val is None:
                continue
            val = tuple(float(x) for x in val)
            object.__setattr__(self, field, val)
            if len(val) != s:
                raise ValueError(f"{field} must have one entry per stage")
            if not all(0.0 <= x <= 1.0 for x in val):
                raise ValueError(f"{field} entries must lie in [0, 1]")
        if self.rework_probs is not None and any(x >= 1.0 for x in self.rework_probs):
            raise ValueError(
                "rework_probs must be < 1 (an always-failing stage never completes)"
            )
        if self.max_retries is not None and self.rework_probs is None:
            raise ValueError("max_retries without rework_probs is meaningless")
        if self.rework_probs is not None:
            caps = self.max_retries
            caps = (8,) * s if caps is None else tuple(int(r) for r in caps)
            object.__setattr__(self, "max_retries", caps)
            if len(caps) != s:
                raise ValueError("max_retries must have one entry per stage")
            if not all(r >= 1 for r in caps):
                raise ValueError("max_retries entries must be >= 1")
        if self.stage_workers is not None:
            widths = tuple(int(k) for k in self.stage_workers)
            object.__setattr__(self, "stage_workers", widths)
            if len(widths) != s:
                raise ValueError("stage_workers must have one entry per stage")
            if not all(1 <= k <= self.num_workers for k in widths):
                raise ValueError("stage_workers entries must lie in [1, num_workers]")

    # -- constructors ------------------------------------------------------
    @staticmethod
    def chain(num_stages: int, num_workers: int) -> "WorkflowDAG":
        """A serial pipeline: stage i feeds stage i+1."""
        preds = tuple(() if i == 0 else (i - 1,) for i in range(num_stages))
        return WorkflowDAG(preds=preds, num_workers=num_workers)

    @staticmethod
    def from_edges(
        num_stages: int, edges: Tuple[Tuple[int, int], ...], num_workers: int
    ) -> "WorkflowDAG":
        """Build from (upstream, downstream) pairs (topologically numbered)."""
        preds = [[] for _ in range(num_stages)]
        for u, v in edges:
            if not 0 <= v < num_stages:
                raise ValueError(f"edge ({u}, {v}) out of range")
            preds[v].append(u)
        return WorkflowDAG(
            preds=tuple(tuple(sorted(set(p))) for p in preds), num_workers=num_workers
        )

    # -- annotated copies --------------------------------------------------
    def with_stochastic(
        self,
        *,
        exec_probs: Optional[Sequence[float]] = None,
        rework_probs: Optional[Sequence[float]] = None,
        max_retries: Optional[Sequence[int]] = None,
    ) -> "WorkflowDAG":
        """Copy with branch/rework annotations (validated, tuple-normalized)."""
        return dataclasses.replace(
            self,
            exec_probs=None if exec_probs is None else tuple(exec_probs),
            rework_probs=None if rework_probs is None else tuple(rework_probs),
            max_retries=None if max_retries is None else tuple(max_retries),
        )

    def with_stage_workers(self, widths: Sequence[int]) -> "WorkflowDAG":
        """Copy with heterogeneous per-stage fleet widths (K_s <= K)."""
        return dataclasses.replace(self, stage_workers=tuple(widths))

    # -- structure ---------------------------------------------------------
    @property
    def num_stages(self) -> int:
        return len(self.preds)

    @property
    def sinks(self) -> Tuple[int, ...]:
        has_succ = {p for pp in self.preds for p in pp}
        return tuple(i for i in range(self.num_stages) if i not in has_succ)

    @property
    def is_chain(self) -> bool:
        return all(ps == (() if i == 0 else (i - 1,)) for i, ps in enumerate(self.preds))

    def succs(self, i: int) -> Tuple[int, ...]:
        return tuple(j for j in range(self.num_stages) if i in self.preds[j])

    @property
    def is_stochastic(self) -> bool:
        """True only for non-degenerate randomness: p = 1 branches and zero
        (or cap-1) rework change no number, so they take the deterministic
        path."""
        if self.exec_probs is not None and any(p < 1.0 for p in self.exec_probs):
            return True
        if self.rework_probs is not None:
            return any(r > 0.0 and cap > 1 for r, cap in zip(self.rework_probs, self.max_retries))
        return False

    def stage_live(self, device=None) -> Optional[Tensor]:
        """(S, K) {0, 1} per-stage worker mask on ``device``, or None when
        every stage is full width.  The dataclass holds no tensor, so the
        device is named here: the card unless another is given."""
        if self.stage_workers is None:
            return None
        device = resolve_device(device)
        col = torch.arange(self.num_workers, device=device)[None, :]
        widths = host_constant(self.stage_workers, device, torch.int64)[:, None]
        return (col < widths).to(torch.float32)


def path_lengths(dag: WorkflowDAG, stage_means: Tensor) -> Tuple[Tensor, Tensor]:
    """Longest expected path through each stage, and the critical-path length.

    ``through[i] = fwd[i] + bwd[i] - mean[i]`` with fwd/bwd the longest
    expected path ending at / starting from stage i; ``through / max`` is the
    criticality weight of the budget allocator.  On a stochastic DAG pass
    effective means.
    """
    s = dag.num_stages
    zero = stage_means.new_zeros(())
    fwd: list = [None] * s
    for i in range(s):
        up = [fwd[p] for p in dag.preds[i]]
        fwd[i] = (functools.reduce(torch.maximum, up) if up else zero) + stage_means[i]
    bwd: list = [None] * s
    for i in reversed(range(s)):
        down = [bwd[j] for j in dag.succs(i)]
        bwd[i] = (functools.reduce(torch.maximum, down) if down else zero) + stage_means[i]
    through = torch.stack([fwd[i] + bwd[i] - stage_means[i] for i in range(s)])
    return through, torch.amax(through)


# --------------------------------------------------------------------------
# stochastic composition helpers
# --------------------------------------------------------------------------
def _stochastic_factors(dag: WorkflowDAG, device) -> Tuple[Tensor, Tensor, Tensor]:
    """(p, E[N], Var[N]) per stage from the static annotations."""
    s = dag.num_stages
    p = host_constant(dag.exec_probs if dag.exec_probs is not None else (1.0,) * s, device)
    if dag.rework_probs is not None:
        n_mean, n_var = truncated_geometric_moments(
            1.0 - host_constant(dag.rework_probs, device), dag.max_retries
        )
    else:
        n_mean = torch.ones((s,), dtype=torch.float32, device=device)
        n_var = torch.zeros((s,), dtype=torch.float32, device=device)
    return p, n_mean, n_var


def effective_stage_moments(
    dag: WorkflowDAG, stage_means: Tensor, stage_vars: Tensor
) -> Tuple[Tensor, Tensor]:
    """Per-attempt stage moments -> what each stage contributes end to end:
    the rework compound sum, then the branch mixture.  A DAG without
    non-degenerate annotations returns the very tensors it was given."""
    if not dag.is_stochastic:
        return stage_means, stage_vars
    device = stage_means.device
    return stochastic_stage_moments(
        stage_means,
        stage_vars,
        exec_probs=None if dag.exec_probs is None else host_constant(dag.exec_probs, device),
        success_probs=(
            None if dag.rework_probs is None
            else 1.0 - host_constant(dag.rework_probs, device)
        ),
        max_retries=dag.max_retries,
    )


# --------------------------------------------------------------------------
# state + estimation (stacked, never a loop over stages)
# --------------------------------------------------------------------------
class DagState(NamedTuple):
    """Everything the DAG scheduler has learned.

    ``gibbs`` leaves carry (S, K) leading axes, stage-major as
    ``gibbs.fold_stage_axis`` folds them, so estimation treats the DAG as one
    S*K fleet.  ``generator`` is the DAG's random source on its device (the
    reference's ``key``).
    """

    gibbs: gibbs.GibbsState  # per-stage-per-worker posteriors, leaves (S, K)
    step: Tensor  # scalar, observe_dag() calls so far
    generator: torch.Generator


class DagProposeStats(NamedTuple):
    """Per-stage and end-to-end statistics of a stage-wise split.  On a
    stochastic DAG ``stage_e`` / ``stage_var`` are the effective
    contributions and ``e_t`` / ``var`` compose them."""

    stage_e: Tensor  # (S,) expected makespan of each stage at its split
    stage_var: Tensor  # (S,) completion-time variance of each stage
    e_t: Tensor  # end-to-end expected completion (topological composition)
    var: Tensor  # end-to-end completion variance
    score: Tensor  # DAG-level objective score (lower is better)


def init_dag(
    config: SchedulerConfig, dag: WorkflowDAG, seed: int = 0, device=None
) -> DagState:
    """Fresh beliefs for every stage's fleet.  An entry point: runs on CUDA
    unless ``device`` says otherwise; ``seed`` seeds the DAG's generator."""
    device = resolve_device(device)
    s, k = dag.num_stages, dag.num_workers
    generator = torch.Generator(device=device).manual_seed(int(seed))
    fleet = gibbs.init_state(generator, mu_guess=config.mu_guess, shape=(s * k,))
    return DagState(
        gibbs=gibbs.unfold_stage_axis(fleet, s),
        step=torch.zeros((), dtype=torch.int32, device=device),
        generator=generator,
    )


def observe_dag(
    state: DagState,
    telemetry: Telemetry,
    config: SchedulerConfig = SchedulerConfig(),
    mask: Optional[Tensor] = None,
    dag: Optional[WorkflowDAG] = None,
) -> Tuple[DagState, Tensor]:
    """Advance every stage's posteriors from one (S, K, N) telemetry block.

    The stage axis folds into the fleet axis and the whole DAG advances
    through one ``advance_fleet``: on a card each sweep's grid posterior is
    one K1 launch covering S*K workers and both exponents.  ``mask``
    optionally invalidates telemetry elements (broadcastable to the times);
    a ``dag`` with ``stage_workers`` also masks every dead column, so
    whatever a padded column carries leaves its parked posterior exactly as
    it was.  Returns the (S, K) log-likelihood.
    """
    times = telemetry.times
    s = times.shape[0]
    if dag is not None and dag.stage_workers is not None:
        lv = dag.stage_live(times.device)[:, :, None]  # (S, K, 1)
        mask = lv if mask is None else torch.broadcast_to(mask, times.shape) * lv
    fold = gibbs.fold_stage_axis
    fleet, ll = advance_fleet(
        fold(state.gibbs),
        fold(times),
        fold(telemetry.fracs),
        config,
        state.generator,
        mask=None if mask is None else fold(torch.broadcast_to(mask, times.shape)),
    )
    return (
        state._replace(gibbs=gibbs.unfold_stage_axis(fleet, s), step=state.step + 1),
        ll.reshape(times.shape[:2]),
    )


def stage_params(state: DagState, *, use_samples: bool = False) -> UnitParams:
    """Current point estimates as frontier parameters, leaves (S, K)."""
    return unit_params_from_gibbs(state.gibbs, use_samples=use_samples)


# --------------------------------------------------------------------------
# partitioning
# --------------------------------------------------------------------------
def uniform_fractions(dag: WorkflowDAG, device=None) -> Tensor:
    """The naive baseline: every stage split 1/K_s across its live workers,
    on the card unless ``device`` says otherwise."""
    device = resolve_device(device)
    live = dag.stage_live(device)
    if live is None:
        return torch.full(
            (dag.num_stages, dag.num_workers), 1.0 / dag.num_workers,
            dtype=torch.float32, device=device,
        )
    return live / torch.sum(live, dim=-1, keepdim=True)


def _composed_moments(dag, fracs, params, num_points):
    stage_e, stage_var = mean_var_completion(fracs, params, num_points)  # per row
    stage_e, stage_var = effective_stage_moments(dag, stage_e, stage_var)
    e_t, var = dag_completion_moments(dag.preds, stage_e, stage_var, num_points=num_points)
    return stage_e, stage_var, e_t, var


def _deadline_meet(objective: Objective, e_t: Tensor, var: Tensor) -> Tensor:
    """P(T <= d) under the Normal matched to the composed moments."""
    return normal_cdf(objective.deadline, e_t, torch.sqrt(torch.clamp(var, min=1e-18)))


def dag_stats(
    dag: WorkflowDAG,
    fracs: Tensor,
    params: UnitParams,
    objective: Objective = Objective(),
    *,
    num_points: int = 512,
) -> DagProposeStats:
    """Compose per-stage makespan moments into end-to-end DAG statistics;
    on a stochastic DAG each stage's moments become its effective
    contribution before the composition."""
    stage_e, stage_var, e_t, var = _composed_moments(dag, fracs, params, num_points)
    if objective.needs_cdf():
        score = -_deadline_meet(objective, e_t, var)
    else:
        score = objective.score_moments(e_t, var)
    return DagProposeStats(stage_e=stage_e, stage_var=stage_var, e_t=e_t, var=var, score=score)


def _dag_objective_score(
    dag: WorkflowDAG,
    fracs: Tensor,
    params: UnitParams,
    objective: Objective,
    num_points: int,
    *,
    smooth: bool = False,
) -> Tensor:
    """Composed end-to-end objective score of an (S, K) split (differentiable)."""
    _, _, e_t, var = _composed_moments(dag, fracs, params, num_points)
    if objective.needs_cdf():
        p_meet = _deadline_meet(objective, e_t, var)
        if smooth:
            return -torch.log(torch.clamp(p_meet, min=1e-12))
        return -p_meet
    return score_moments_dynamic(
        objective.kind, e_t, var, objective.risk_aversion, objective.var_budget, smooth=smooth
    )


def _joint_refine(
    dag: WorkflowDAG,
    fracs: Tensor,
    params: UnitParams,
    objective: Objective,
    config: SchedulerConfig,
    live: Optional[Tensor],
) -> Tensor:
    """End-to-end Adam refinement of all stage splits at once.

    The per-stage decomposition cannot see that variance bought at a noisy
    fork/join costs E[max] downstream; this pass descends on the full
    (S, K) logits against the composed (effective-moment) objective.  The
    caller keeps it only if it beats the per-stage split.
    """
    pin = (lambda x: x) if live is None else (lambda x: torch.where(live > 0, x, -1e9))
    params = UnitParams(*(x.detach() for x in params))
    logits = torch.log(torch.clamp(fracs, min=1e-9)).detach()
    m = torch.zeros_like(logits)
    v = torch.zeros_like(logits)
    with torch.enable_grad():
        for step in range(1, config.opt_steps + 1):
            x = logits.detach().requires_grad_(True)
            loss = _dag_objective_score(
                dag, torch.softmax(pin(x), dim=-1), params, objective, config.num_points,
                smooth=True,
            )
            (g,) = torch.autograd.grad(loss, x)
            m = 0.9 * m + 0.1 * g
            v = 0.999 * v + 0.001 * g * g
            mh = m / (1.0 - 0.9**step)
            vh = v / (1.0 - 0.999**step)
            logits = logits - config.opt_lr * mh / (torch.sqrt(vh) + 1e-8)
    f = torch.softmax(pin(logits), dim=-1)
    # The per-worker floor of solve_fractions, rows renormalized.
    f = torch.clamp(f, min=config.min_fraction)
    if live is not None:
        f = torch.where(live > 0, f, 0.0)
    return f / torch.sum(f, dim=-1, keepdim=True)


def propose_dag(
    state: DagState,
    dag: WorkflowDAG,
    config: SchedulerConfig = SchedulerConfig(),
    *,
    critical_path_aware: bool = True,
    objectives: Optional[Tuple[Objective, ...]] = None,
    params: Optional[UnitParams] = None,
) -> Tuple[Tensor, DagProposeStats]:
    """Objective-optimal stage-wise splits under the current beliefs.

    Returns fractions (S, K), each row on its (live-masked) simplex, and the
    composed end-to-end statistics.  By objective kind:

      mean       each stage minimizes its expected makespan (E of a sum of
                 stage times is the sum of their E).
      mean_var   each stage's risk aversion is scaled by its criticality
                 when ``critical_path_aware``: variance on a slack branch
                 cannot move end-to-end latency.
      var_budget the end-to-end budget is split across stages in proportion
                 to their unconstrained variance (times criticality), each
                 stage solves its own budget, and one reallocation round
                 gives the slack of stages below their slice to the stages
                 that clipped against theirs.
      deadline   stage s gets d * E_s / L_s, L_s the longest expected path
                 through s, and maximizes its own P(t_s <= d_s).

    On a stochastic DAG the cross-stage quantities come from effective
    stage moments, the end-to-end budgets are converted to the per-attempt
    level each stage solve controls, and ``_joint_refine`` runs and is kept
    only if it wins.  ``objectives`` gives each stage its own objective
    (budgets and deadlines are then per-stage constraints, and the stats
    score the composition under ``config.objective``).  ``params``
    overrides the posterior point estimates (e.g. the true parameters).
    Every stage solve of one objective is one row-batched
    ``solve_fractions``.
    """
    if params is None:
        params = stage_params(state)
    device = params.mu.device
    live = dag.stage_live(device)
    stochastic = dag.is_stochastic
    solve_kw = dict(
        steps=config.opt_steps,
        lr=config.opt_lr,
        num_points=config.num_points,
        min_fraction=config.min_fraction,
    )

    def bsolve(p, objective, live_rows, **overrides):
        """One row-batched solve over a leading stage axis."""
        return solve_fractions(p, objective=objective, live=live_rows, **solve_kw, **overrides)

    # Unconstrained (risk-neutral) pre-solve: the allocation baseline.
    f0, st0 = bsolve(params, Objective.mean(), live)
    e0, v0 = st0.e_t, st0.var  # (S,) per-attempt moments at the mean split

    # Cross-stage bookkeeping runs on effective contributions; per-stage
    # solves stay at the per-attempt level they control.
    if stochastic:
        p_exec, n_mean, n_var = _stochastic_factors(dag, device)
        eff_e0, eff_v0 = effective_stage_moments(dag, e0, v0)
    else:
        eff_e0, eff_v0 = e0, v0

    through, crit_len = path_lengths(dag, eff_e0)
    crit = through / torch.clamp(crit_len, min=1e-9) if critical_path_aware else torch.ones_like(e0)

    if objectives is not None:
        obj_tuple = as_stage_objectives(objectives, dag.num_stages)
        fracs = f0
        groups: dict = {}
        for i, o in enumerate(obj_tuple):
            groups.setdefault(o, []).append(i)
        for o, idx_list in groups.items():
            if o.kind == "mean":
                continue  # the presolve rows already minimize E[t]
            idx = host_constant(idx_list, device, torch.int64)
            take = lambda x: x.index_select(0, idx)
            p_g = UnitParams(*(take(x) for x in params))
            lv_g = None if live is None else take(live)
            if o.kind == "mean_var":
                ra = o.risk_aversion * take(crit)
                if stochastic:
                    ra = ra * take(p_exec * n_mean)
                f_g, _ = bsolve(p_g, o, lv_g, risk_aversion=ra)
            elif o.kind == "var_budget":
                # Per-stage budgets constrain the stage's effective variance;
                # convert to the per-attempt budget the solve controls.
                b = torch.full((len(idx_list),), o.var_budget, dtype=torch.float32, device=device)
                if stochastic:
                    b = _attempt_var_budget(b, take(e0), take(p_exec), take(n_mean), take(n_var))
                f_g, _ = bsolve(p_g, o, lv_g, var_budget=b)
            else:  # deadline: the stage's own latency target
                d_g = torch.full((len(idx_list),), o.deadline, dtype=torch.float32, device=device)
                if stochastic:
                    d_g = d_g / take(n_mean)  # each attempt gets its share
                f_g, _ = bsolve(p_g, o, lv_g, deadline=d_g)
            fracs = fracs.index_copy(0, idx, f_g)
        stats_obj = config.objective
    else:
        obj = config.objective
        stats_obj = obj
        if obj.kind == "mean":
            fracs = f0
        elif obj.kind == "mean_var":
            ra = obj.risk_aversion * crit  # (S,)
            if stochastic:
                ra = ra * p_exec * n_mean
            fracs, _ = bsolve(params, obj, live, risk_aversion=ra)
        elif obj.kind == "var_budget":
            w = eff_v0 * crit + 1e-12
            b_s = obj.var_budget * w / torch.sum(w)  # effective-variance slices
            if stochastic:
                b_s = _attempt_var_budget(b_s, e0, p_exec, n_mean, n_var)
            fracs, st1 = bsolve(params, obj, live, var_budget=b_s)
            # Reallocation round: stages clearly below their slice donate the
            # surplus to stages that clipped against theirs.  A stage is donor
            # or receiver, never both, so the slices still sum to <= budget.
            binding = st1.var >= 0.95 * b_s
            surplus = torch.sum(torch.where(binding, 0.0, torch.clamp(b_s - st1.var, min=0.0)))
            recv = binding.to(torch.float32) * w
            extra = surplus * recv / torch.clamp(torch.sum(recv), min=1e-12)
            fracs, _ = bsolve(params, obj, live, var_budget=b_s + extra)
        else:  # deadline
            d_s = obj.deadline * eff_e0 / torch.clamp(through, min=1e-9)  # path-wise slices
            if stochastic:
                d_s = d_s / n_mean  # per-attempt share of the stage's slice
            fracs, _ = bsolve(params, obj, live, deadline=d_s)

        if stochastic:
            # Joint end-to-end refinement, kept only if the composed
            # objective improves.
            refined = _joint_refine(dag, fracs, params, obj, config, live)
            sc_base = _dag_objective_score(dag, fracs, params, obj, config.num_points)
            sc_ref = _dag_objective_score(dag, refined, params, obj, config.num_points)
            fracs = torch.where(sc_ref < sc_base, refined, fracs)

    stats = dag_stats(dag, fracs, params, stats_obj, num_points=config.num_points)
    return fracs, stats


def _attempt_var_budget(
    b_eff: Tensor, e0: Tensor, p_exec: Tensor, n_mean: Tensor, n_var: Tensor
) -> Tensor:
    """Invert the effective-variance transform at the allocation point.

    v_eff = p (E[N] v + Var[N] e^2) + p (1 - p) (E[N] e)^2, solved for the
    per-attempt variance v a stage's solve controls, holding the per-attempt
    mean at the presolve value ``e0``; floored at 1e-9, so an allocation
    below the structural variance still yields the minimum-variance split.
    """
    v = (
        b_eff / torch.clamp(p_exec, min=1e-9)
        - n_var * e0 * e0
        - (1.0 - p_exec) * (n_mean * e0) ** 2
    ) / torch.clamp(n_mean, min=1e-9)
    return torch.clamp(v, min=1e-9)
