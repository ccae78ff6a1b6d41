"""Shared arithmetic of the metric readers (``metrics/<name>.py``).

A reader returns None where its run recorded nothing to read; the harness
then leaves the metric out of the result.  Spans and work are the driver's,
taken on the host clock inside the window; kernel times and busy time come
from the window's ``torch.profiler`` trace (``Record.gpu``).
"""
from __future__ import annotations

import importlib

from perfbench.harness import percentile


def rate(rec, work: str):
    n = rec.work.get(work)
    return None if not n else n / rec.window_s


def span_ms(rec, span: str, q: float = 0.5):
    d = rec.durations(span)
    return percentile(d, q) * 1e3 if d else None


def idle_pct(rec, cfg, mix):
    if rec.gpu is None or rec.gpu["busy_s"] <= 0:
        return None
    return 100.0 * (1.0 - rec.gpu["busy_s"] / rec.gpu["window_s"])


def kernel_time(rec, names):
    """(launches, seconds) of the traced kernels whose name holds any of ``names``."""
    n, s = 0, 0.0
    for name, (count, sec) in rec.gpu["kernels"].items():
        if any(k in name for k in names):
            n += count
            s += sec
    return n, s


def roofline_pct(rec, kernel: str, counts: str, per_call: int = 1):
    """Share of the bound: the counted bound of every recorded launch over
    the traced device time of the kernel's launches (``per_call`` device
    kernels a launch).  None without a trace, launches or matching times."""
    calls = rec.launches.get(kernel)
    if rec.gpu is None or not calls:
        return None
    mod = importlib.import_module(f"perfbench.counts.{counts}")
    n, sec = kernel_time(rec, mod.KERNELS)
    launched = sum(k for _, k in calls)
    if n != per_call * launched or sec <= 0:
        return None
    bound = sum(mod.bound_s(*shape) * k for shape, k in calls)
    return 100.0 * bound / sec
