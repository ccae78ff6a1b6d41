"""Monte-Carlo workflow simulation on PyTorch: the oracle for composition.

Counterpart of ``repro.sim``.  One generative process, written from the
model's definition, backs three uses: the oracle every closed-form rule of
``repro_torch.core.frontier`` is checked against (:func:`simulate_moments`),
the evaluator of a proposal's true expected completion time under known
worker parameters (:func:`simulate_workflow`), and the fixture factory of
per-worker telemetry (:func:`simulate_telemetry`).

>>> import torch
>>> from repro_torch import sim
>>> from repro_torch.core.frontier import UnitParams
>>> params = UnitParams.of(mu=torch.full((1, 2), 6.0), sigma=torch.full((1, 2), 0.3))
>>> e, v = sim.simulate_moments(0, ((),), torch.full((1, 2), 0.5), params,
...                             num_samples=8192, batch_size=4096, device="cpu")
>>> bool(abs(float(e) - 3.0) < 0.1)
True
"""
from .workflow import (
    DEFAULT_BATCH_SIZE,
    DEFAULT_NUM_SAMPLES,
    simulate_moments,
    simulate_telemetry,
    simulate_workflow,
    topology_spec,
)

__all__ = [
    "DEFAULT_BATCH_SIZE",
    "DEFAULT_NUM_SAMPLES",
    "simulate_moments",
    "simulate_telemetry",
    "simulate_workflow",
    "topology_spec",
]
