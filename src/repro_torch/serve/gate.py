"""Online-calibrated drift gate: an EWMA baseline instead of a fixed threshold.

PyTorch counterpart of ``repro.serve.gate``.  A fixed threshold on a
max-over-workers drift statistic depends on the fleet size (the max of K
scores grows with K).  ``GateState`` instead tracks an EWMA mean and squared
deviation of the statistic, and :func:`gate_update` fires when a statistic
exceeds ``mean + z * (sd + rel_floor * |mean| + abs_floor)``: a z-score test
against the observed null level.  Fired statistics are not absorbed into the
baseline, and the first ``warmup`` statistics only calibrate.

The functions take tensors on any device (or host floats) and never read
the device.
"""
from __future__ import annotations

from typing import NamedTuple, Tuple

import torch
from torch import Tensor

DEFAULT_GATE_Z = 4.0
DEFAULT_GATE_WARMUP = 3
DEFAULT_GATE_DECAY = 0.9
_REL_FLOOR = 0.05
_ABS_FLOOR = 1e-6


class GateState(NamedTuple):
    """EWMA baseline of the drift statistic: three scalar tensors."""

    mean: Tensor  # float32, EWMA of the statistic
    var: Tensor  # float32, EWMA of squared deviation from the mean
    count: Tensor  # int32, statistics folded into the baseline


def gate_init(device=None) -> GateState:
    return GateState(
        mean=torch.zeros((), dtype=torch.float32, device=device),
        var=torch.zeros((), dtype=torch.float32, device=device),
        count=torch.zeros((), dtype=torch.int32, device=device),
    )


def gate_threshold(gate: GateState, *, z: float = DEFAULT_GATE_Z) -> Tensor:
    """Current firing level ``mean + z * (sd + floors)``: the relative floor
    keeps a near-deterministic steady state from firing on jitter, the
    absolute floor does the same for a statistic at zero."""
    sd = torch.sqrt(torch.clamp(gate.var, min=0.0))
    return gate.mean + z * (sd + _REL_FLOOR * torch.abs(gate.mean) + _ABS_FLOOR)


def gate_update(
    gate: GateState,
    stat,
    *,
    z: float = DEFAULT_GATE_Z,
    warmup: int = DEFAULT_GATE_WARMUP,
    decay: float = DEFAULT_GATE_DECAY,
    update=True,
) -> Tuple[Tensor, GateState]:
    """Score one statistic against the calibrated baseline; returns (fire, gate).

    ``update`` masks the whole call (an empty drain carries no statistic):
    when false nothing fires and nothing is absorbed.  A fired statistic
    never updates the baseline; the first statistic seeds the EWMA.
    """
    # A host value becomes a device scalar by a fill, not a copy that waits.
    scalar = lambda x, dtype: (x.to(dtype) if isinstance(x, Tensor) else
                               torch.full((), x, dtype=dtype, device=gate.mean.device))
    stat = scalar(stat, torch.float32)
    update = scalar(update, torch.bool)
    warm = gate.count >= warmup
    fire = update & warm & (stat > gate_threshold(gate, z=z))

    fresh = gate.count == 0
    dev = stat - gate.mean
    mean_next = torch.where(fresh, stat, decay * gate.mean + (1.0 - decay) * stat)
    var_next = torch.where(fresh, 0.0, decay * gate.var + (1.0 - decay) * dev * dev)
    absorb = update & ~fire
    return fire, GateState(
        mean=torch.where(absorb, mean_next, gate.mean),
        var=torch.where(absorb, var_next, gate.var),
        count=gate.count + absorb.to(torch.int32),
    )
