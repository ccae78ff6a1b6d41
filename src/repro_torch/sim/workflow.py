"""Monte-Carlo workflow simulator: the independent oracle for composition.

PyTorch counterpart of ``repro.sim.workflow``.  Every closed-form
composition rule of ``repro_torch.core.frontier`` (worker-max quadrature,
serial sums, the PERT branch max and the stochastic transforms) is an
analytic claim about one generative process; this module samples that
process, written from the model's definition:

  * per-attempt stage makespan = max over workers of
    ``N(f_k^alpha mu_k, (f_k^beta sigma_k)^2)``, through the same
    ``component_mean_std`` the analytic path uses, so floors match bit for
    bit;
  * rework loops: a stage re-runs until an attempt succeeds (per-attempt
    rework probability ``r_s``) or hits its ``max_retries`` cap; the stage's
    duration is the exact sum over its sampled attempts;
  * conditional branches: each stage fires an independent Bernoulli
    ``exec_probs`` indicator per sample; a skipped stage contributes zero
    duration but still forwards its predecessors' finish times;
  * composition: exact max at joins, exact sum along chains, exact max over
    sinks.

It shares no composition code with the analytic path, so agreement within
Monte-Carlo error is evidence.  Topology is duck-typed: a bare ``preds``
tuple of tuples, or anything with ``.preds`` and optionally
``.exec_probs`` / ``.rework_probs`` / ``.max_retries`` (a
``repro_torch.sched.WorkflowDAG``); this layer never imports ``sched``.

Sampling streams batches of (batch, S, R_max, K) draws, so ``batch_size``
bounds peak memory.  Each call draws from one ``torch.Generator`` seeded
from its ``seed``: the streams are not the reference's threefry streams, so
the simulator is compared with the reference's statistically.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

import torch
from torch import Tensor

from repro_torch.core.frontier import UnitParams, component_mean_std
from repro_torch.device import host_constant, resolve_device

DEFAULT_NUM_SAMPLES = 200_000
DEFAULT_BATCH_SIZE = 8_192


def topology_spec(
    topology,
) -> Tuple[
    Tuple[Tuple[int, ...], ...],
    Tuple[float, ...],
    Tuple[float, ...],
    Tuple[int, ...],
]:
    """Normalize a duck-typed topology into (preds, exec_probs, rework_probs,
    max_retries) tuples.  Absent annotations are the deterministic values:
    always execute, never rework."""
    preds = getattr(topology, "preds", topology)
    preds = tuple(tuple(int(p) for p in ps) for ps in preds)
    s = len(preds)
    exec_probs = getattr(topology, "exec_probs", None)
    rework_probs = getattr(topology, "rework_probs", None)
    max_retries = getattr(topology, "max_retries", None)
    exec_probs = (1.0,) * s if exec_probs is None else tuple(map(float, exec_probs))
    rework_probs = (0.0,) * s if rework_probs is None else tuple(map(float, rework_probs))
    max_retries = (1,) * s if max_retries is None else tuple(int(r) for r in max_retries)
    if not (len(exec_probs) == len(rework_probs) == len(max_retries) == s):
        raise ValueError("stochastic annotations must have one entry per stage")
    return preds, exec_probs, rework_probs, max_retries


def _stage_durations(
    generator: torch.Generator,
    mean: Tensor,
    std: Tensor,
    exec_probs: Tensor,
    rework_probs: Tensor,
    max_retries: Tensor,
    r_max: int,
    num_samples: int,
) -> Tensor:
    """(num_samples, S) sampled effective stage durations (rework + branch)."""
    s, k = mean.shape
    dev = mean.device
    # Every attempt is an independent worker-max draw: (n, S, R_max, K).
    z = torch.randn((num_samples, s, r_max, k), generator=generator, device=dev)
    attempts = torch.amax(mean[None, :, None, :] + std[None, :, None, :] * z, dim=-1)

    # Truncated-geometric attempt counts by inverse CDF.  log(r) = -inf at
    # r = 0 sends the ratio to -0.0, one attempt, no NaN.
    u = torch.rand((num_samples, s), generator=generator, device=dev)
    log_r = torch.log(torch.clamp(rework_probs, min=1e-38))
    n_attempts = torch.minimum(1.0 + torch.floor(torch.log1p(-u) / log_r), max_retries)
    n_attempts = torch.where(rework_probs <= 0.0, 1.0, n_attempts)
    taken = torch.arange(r_max, dtype=torch.float32, device=dev) < n_attempts[..., None]
    duration = torch.sum(attempts * taken, dim=-1)  # (n, S)

    # Bernoulli path activation: skipped stages contribute zero duration.
    active = torch.rand((num_samples, s), generator=generator, device=dev) < exec_probs
    return duration * active


def simulate_workflow(
    seed: int,
    topology,
    fracs,
    params: UnitParams,
    *,
    num_samples: int = DEFAULT_NUM_SAMPLES,
    batch_size: int = DEFAULT_BATCH_SIZE,
    device=None,
) -> Tensor:
    """Sampled end-to-end completion times of a (stochastic) workflow.

    An entry point: runs on CUDA unless ``device`` says otherwise.
    ``topology`` is duck-typed (see :func:`topology_spec`); ``fracs`` and the
    ``UnitParams`` leaves are (S, K): the true worker parameters to use the
    simulator as an oracle, or posterior point estimates.  Returns at least
    ``num_samples`` samples, rounded up to whole batches of ``batch_size``.

    >>> params = UnitParams.of(mu=torch.full((2, 2), 8.0), sigma=torch.full((2, 2), 0.2))
    >>> t = simulate_workflow(0, ((), (0,)), torch.full((2, 2), 0.5), params,
    ...                       num_samples=4096, batch_size=2048, device="cpu")
    >>> t.shape, bool(abs(float(t.mean()) - 8.0) < 0.5)
    (torch.Size([4096]), True)
    """
    device = resolve_device(device)
    preds, exec_probs, rework_probs, max_retries = topology_spec(topology)
    fracs = torch.as_tensor(fracs, dtype=torch.float32).to(device)
    if fracs.ndim != 2 or fracs.shape[0] != len(preds):
        raise ValueError(
            f"fracs must be (S, K) with S == {len(preds)}, got {tuple(fracs.shape)}"
        )
    params = UnitParams(*(torch.as_tensor(x, dtype=torch.float32).to(device) for x in params))
    mean, std = component_mean_std(fracs, params)  # (S, K): the analytic path's floors
    batch_size = int(min(batch_size, num_samples))
    num_batches = -(-int(num_samples) // batch_size)
    generator = torch.Generator(device=device).manual_seed(int(seed))
    const = functools.partial(host_constant, device=device)
    p, r, caps = const(exec_probs), const(rework_probs), const(max_retries)
    has_succ = {q for ps in preds for q in ps}
    sinks = [i for i in range(len(preds)) if i not in has_succ]

    out = []
    for _ in range(num_batches):
        contrib = _stage_durations(
            generator, mean, std, p, r, caps, max(max_retries), batch_size
        )
        # Exact topological composition per sample: start at the max over
        # predecessor finishes, finish after this stage's sampled duration.
        fin: list = [None] * len(preds)
        for i, ps in enumerate(preds):
            start = functools.reduce(
                torch.maximum, [fin[q] for q in ps], contrib.new_zeros((batch_size,))
            )
            fin[i] = start + contrib[:, i]
        out.append(functools.reduce(torch.maximum, [fin[i] for i in sinks]))
    return torch.cat(out)


def simulate_moments(
    seed: int,
    topology,
    fracs,
    params: UnitParams,
    *,
    num_samples: int = DEFAULT_NUM_SAMPLES,
    batch_size: int = DEFAULT_BATCH_SIZE,
    device=None,
) -> Tuple[Tensor, Tensor]:
    """(E, Var) of the end-to-end completion time, straight from samples
    (the variance with divisor n, as ``jnp.var``)."""
    t = simulate_workflow(
        seed, topology, fracs, params,
        num_samples=num_samples, batch_size=batch_size, device=device,
    )
    return torch.mean(t), torch.var(t, correction=0)


def simulate_telemetry(
    seed: int,
    fracs,
    params: UnitParams,
    *,
    num_obs: int = 16,
    noise: Optional[Tensor] = None,
    device=None,
) -> Tensor:
    """Per-worker telemetry times from the true generative model.

    Returns ``fracs.shape + (num_obs,)`` times, (K, N) for a flat fleet or
    (S, K, N) for a stage-stacked DAG, each ``t = f^alpha mu + f^beta sigma
    z`` with fresh standard-normal ``z``, floored at 1e-6.  ``noise``
    optionally scales the per-draw std.  An entry point: runs on CUDA unless
    ``device`` says otherwise.
    """
    device = resolve_device(device)
    fracs = torch.as_tensor(fracs, dtype=torch.float32).to(device)
    params = UnitParams(*(torch.as_tensor(x, dtype=torch.float32).to(device) for x in params))
    mean, std = component_mean_std(fracs, params)
    if noise is not None:
        std = std * noise
    generator = torch.Generator(device=device).manual_seed(int(seed))
    z = torch.randn(mean.shape + (num_obs,), generator=generator, device=device)
    return torch.clamp(mean[..., None] + std[..., None] * z, min=1e-6)
