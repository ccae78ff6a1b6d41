"""Integer microbatch quantization with on-device refinement.

PyTorch counterpart of ``repro.sched.quantize``.  Simplex fractions become
integer microbatch counts: largest-remainder rounding on the host by a
vectorized water-fill shed/top-up (O(K log K)), then greedy
donor->receiver single-microbatch moves, each scored under the true
objective on the device of ``params``.  Beyond ``_REFINE_SLAB`` workers the
moves are restricted to the top-M donors and receivers ranked by the smooth
objective's gradient, so a move costs O(M^2) evaluations, not O(K^2).
Donors are swept one at a time, so at most M (or K) candidate vectors are
scored at once.
"""
from __future__ import annotations

from typing import Optional

import numpy as np
import torch
from torch import Tensor

from repro_torch.core.frontier import UnitParams

from .objectives import Objective, as_stage_objectives, evaluate

# Coarser quadrature than the continuous solver: the lattice steps are
# O(1/total) so fine integration noise is irrelevant.
_REFINE_QUAD_POINTS = 192

# Fleets larger than this use gradient-ranked donor/receiver slabs; at or
# under it the move sweep is exhaustive.
_REFINE_SLAB = 32


def _water_fill(priority: np.ndarray, cap: np.ndarray, need: int) -> np.ndarray:
    """Integer units per worker reproducing descending-priority greedy taking.

    The greedy takes one unit at a time from the current argmax of
    ``priority_i - taken_i`` (bounded by ``cap_i``) until ``need`` units are
    taken.  The closed form is a water level tau with
    ``taken_i = clip(ceil(priority_i - tau), 0, cap_i)``: bisect tau for a
    fixed 80 iterations, then trim boundary ties lowest-priority-first with
    one stable argsort.
    """
    cap = np.asarray(cap, np.int64)
    taken = np.zeros_like(cap)
    if need <= 0:
        return taken
    priority = np.asarray(priority, np.float64)
    lo = float(priority.min() - cap.max() - 2.0)  # taken = cap everywhere
    hi = float(priority.max() + 1.0)  # taken = 0 everywhere
    for _ in range(80):
        mid = 0.5 * (lo + hi)
        if np.clip(np.ceil(priority - mid), 0, cap).sum() >= need:
            lo = mid
        else:
            hi = mid
    taken = np.clip(np.ceil(priority - lo), 0, cap).astype(np.int64)
    surplus = int(taken.sum()) - need
    if surplus > 0:
        last_unit = np.where(taken > 0, priority - taken + 1.0, np.inf)
        order = np.argsort(last_unit, kind="stable")
        taken[order[:surplus]] -= 1
    return taken


def _refine_counts(
    counts: Tensor,
    params: UnitParams,
    total: int,
    *,
    objective: Objective,
    min_per_worker: int,
    max_moves: int,
    slab: int = _REFINE_SLAB,
) -> Tensor:
    """Greedy best-move descent on the count lattice.

    Each iteration scores single-microbatch donor->receiver moves and applies
    the best strictly-improving one; it stops when none improves (one host
    read per move) or after ``max_moves``.  At K <= slab all K*K moves are
    scored; larger fleets score only the slab x slab block of the donors
    with the highest and the receivers with the lowest smooth-objective
    gradient, and still accept a move only on the true objective.
    """
    k = counts.shape[0]
    inv_total = 1.0 / float(total)
    ids = torch.arange(k, device=counts.device)
    hot = lambda idx: (idx[..., None] == ids).to(counts.dtype)  # one-hot rows

    def score(c):
        return evaluate(
            objective, c.to(torch.float32) * inv_total, params,
            num_points=_REFINE_QUAD_POINTS,
        )

    def sweep(c, donors, receivers):
        """(len(donors), len(receivers)) move scores, one donor at a time."""
        rows = []
        can_give = c[donors] > min_per_worker
        for i in range(donors.shape[0]):
            d = donors[i]
            cand = c[None, :] - hot(d)[None, :] + hot(receivers)
            valid = can_give[i] & (receivers != d)
            rows.append(torch.where(valid, score(cand), torch.inf))
        return torch.stack(rows)

    def smooth_grad(c):
        with torch.enable_grad():
            fr = (c.to(torch.float32) * inv_total).requires_grad_(True)
            loss = evaluate(
                objective, fr, params, num_points=_REFINE_QUAD_POINTS, smooth=True
            )
            (g,) = torch.autograd.grad(loss, fr)
        return g

    def top(x):
        """Indices of the ``slab`` largest entries, ties to the lower index
        (as ``lax.top_k``): workers that do not touch the max tie at a
        gradient of exactly 0, and the order decides the move among ties."""
        return torch.sort(x, descending=True, stable=True).indices[:slab]

    best = score(counts)
    for _ in range(max_moves):
        if k <= slab:
            donors = receivers = ids
        else:
            g = smooth_grad(counts)
            donors = top(torch.where(counts > min_per_worker, g, -torch.inf))
            receivers = top(-g)
        scores = sweep(counts, donors, receivers)
        flat = torch.argmin(scores)
        val = scores.reshape(-1)[flat]
        if not bool(val < best - 1e-9):
            break
        d = donors[flat // receivers.shape[0]]
        r = receivers[flat % receivers.shape[0]]
        counts = counts - hot(d) + hot(r)
        best = torch.minimum(val, best)
    return counts


def quantize_fractions(
    fracs: np.ndarray,
    total_microbatches: int,
    params: Optional[UnitParams] = None,
    *,
    objective: Objective = Objective(),
    min_per_worker: int = 1,
    refine_passes: int = 4,
    live: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Round simplex fractions to integer microbatch counts summing to total.

    Largest-remainder rounding (water-fill shed/top-up, see ``_water_fill``);
    when ``params`` is given, greedy single-microbatch moves accepted only if
    they reduce the true (quantized) objective, on ``params``' device.
    Invariants: counts.sum() == total_microbatches and every count >=
    min_per_worker, for any fraction vector.  Numpy in, numpy out.

    ``live`` (a host (K,) boolean mask of a capacity-slot state) restricts
    quantization to live workers: dead slots get exactly 0 microbatches, are
    exempt from the ``min_per_worker`` floor, and never enter the refinement.
    """
    if live is not None:
        alive = np.flatnonzero(np.asarray(live, bool))
        sub = np.asarray(fracs, np.float64)[alive]
        sub_params = None
        if params is not None:
            rows = torch.as_tensor(alive, device=params.mu.device)
            sub_params = UnitParams(*(x.index_select(0, rows) for x in params))
        counts = np.zeros(len(live), np.int64)
        counts[alive] = quantize_fractions(
            sub / max(sub.sum(), 1e-30), total_microbatches, sub_params,
            objective=objective, min_per_worker=min_per_worker, refine_passes=refine_passes,
        )
        return counts

    fracs = np.asarray(fracs, np.float64)
    k = len(fracs)
    if total_microbatches < k * min_per_worker:
        raise ValueError(
            f"{total_microbatches} microbatches cannot give {k} workers "
            f">= {min_per_worker} each"
        )
    raw = fracs * total_microbatches
    counts = np.maximum(np.floor(raw).astype(np.int64), min_per_worker)
    # Shed from the most over-allocated workers that can still give
    # (sum > total >= k*min implies headroom exists).
    counts -= _water_fill(
        counts - raw,
        counts - min_per_worker,
        int(counts.sum()) - total_microbatches,
    )
    # Top up by largest remainder (each extra unit lowers the remainder by 1,
    # which is exactly the water-fill greedy).
    need = total_microbatches - int(counts.sum())
    counts += _water_fill(raw - counts, np.full(k, max(need, 0)), need)

    if params is None:
        return counts

    refined = _refine_counts(
        torch.as_tensor(counts, device=params.mu.device),
        params,
        total_microbatches,
        objective=objective,
        min_per_worker=min_per_worker,
        max_moves=refine_passes * min(k, 4 * _REFINE_SLAB),
    )
    return refined.cpu().numpy().astype(np.int64)


def quantize_dag_fractions(
    fracs,
    total_microbatches,
    params: Optional[UnitParams] = None,
    *,
    objective: Objective = Objective(),
    objectives=None,
    min_per_worker: int = 1,
    refine_passes: int = 4,
    live: Optional[np.ndarray] = None,
) -> np.ndarray:
    """Round (S, K) stage-wise fractions to per-stage integer counts.

    Each stage's row quantizes on its own (the lattice couples workers
    within a stage, never across stages), so this is a host loop of
    ``quantize_fractions`` calls.  ``total_microbatches`` is an int shared
    by every stage or one per stage; ``objectives`` optionally gives each
    stage its own rounding objective (the spec ``propose_dag`` takes);
    ``live`` is an (S, K) host mask (e.g. ``WorkflowDAG.stage_live()``)
    giving dead pad columns exactly zero microbatches.  With ``params``
    ((S, K) leaves) each row's refinement runs on their device.
    """
    fracs = np.asarray(fracs, np.float64)
    if fracs.ndim != 2:
        raise ValueError(f"expected (S, K) fractions, got shape {fracs.shape}")
    s = fracs.shape[0]
    objs = as_stage_objectives(objective if objectives is None else objectives, s)
    if np.ndim(total_microbatches) == 0:
        totals = [int(total_microbatches)] * s
    else:
        totals = [int(t) for t in total_microbatches]
        if len(totals) != s:
            raise ValueError("need one microbatch total per stage")
    live = None if live is None else np.asarray(live, bool)
    counts = np.zeros(fracs.shape, np.int64)
    for i in range(s):
        counts[i] = quantize_fractions(
            fracs[i],
            totals[i],
            None if params is None else UnitParams(*(x[i] for x in params)),
            objective=objs[i],
            min_per_worker=min_per_worker,
            refine_passes=refine_passes,
            live=None if live is None else live[i],
        )
    return counts
