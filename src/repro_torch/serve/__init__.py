"""Streaming serving loop on PyTorch: the estimator as an always-on service.

Counterpart of ``repro.serve``.  A device-resident ``TelemetryRing`` buffers
observations, each ``tick`` drains whole batches through the fleet-native
estimator (optionally with only a top-M active set on the exponent grid),
and the simplex solve re-runs only when the posterior moved (drift-gated
cadence with a hard staleness cap), synchronously or on a side CUDA stream.
Readers take the last published split from a double-buffered host slot.

    >>> import numpy as np
    >>> from repro_torch import sched, serve
    >>> config = serve.ServeConfig(
    ...     sched=sched.SchedulerConfig(n_iters=2, grid_size=32, num_points=64,
    ...                                 opt_steps=10),
    ...     capacity=8, drift_threshold=0.05, max_staleness=4)
    >>> loop = serve.ServiceLoop(3, config=config, seed=0, device="cpu")
    >>> rng = np.random.default_rng(1)
    >>> for i in range(8):
    ...     f = rng.uniform(0.1, 0.9, 3)
    ...     loop.push(f, f**0.9 * np.array([5.0, 10.0, 20.0]))
    >>> info = loop.tick()
    >>> (info.drained, info.proposed)
    (8, True)
    >>> bool(abs(loop.fractions().sum() - 1.0) < 1e-5)
    True
"""
from .gate import GateState, gate_init, gate_threshold, gate_update
from .ring import DrainedBatch, TelemetryRing, drain, push, ring_init
from .service import (
    ServeConfig,
    ServeState,
    ServiceLoop,
    TickInfo,
    init,
    posterior_drift,
    solve_published,
    tick,
    tick_with_params,
)

__all__ = [
    "DrainedBatch",
    "GateState",
    "ServeConfig",
    "ServeState",
    "ServiceLoop",
    "TelemetryRing",
    "TickInfo",
    "drain",
    "gate_init",
    "gate_threshold",
    "gate_update",
    "init",
    "posterior_drift",
    "push",
    "ring_init",
    "solve_published",
    "tick",
    "tick_with_params",
]
