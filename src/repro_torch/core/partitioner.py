"""Deprecated import path for the legacy partitioner API.

The implementation is :mod:`repro_torch.sched.compat`: it wraps the
``repro_torch.sched`` scheduler, which builds on ``core``.  This module keeps
``from repro_torch.core.partitioner import HeterogeneityAwarePartitioner``
working; the names resolve lazily (PEP 562), so importing ``core`` never
imports ``sched`` and the import graph stays acyclic.

New code should import from ``repro_torch.sched`` directly.
"""
from __future__ import annotations

__all__ = [
    "HeterogeneityAwarePartitioner",
    "WorkerTelemetry",
    "optimize_fractions",
    "quantize_fractions",
]


def __getattr__(name):
    if name in __all__ or name == "_legacy_objective":
        from repro_torch.sched import compat

        return getattr(compat, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(__all__))
