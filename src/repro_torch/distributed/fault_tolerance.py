"""Fault tolerance: heartbeats, Bayesian straggler detection, elastic resize.

Counterpart of ``repro.distributed.fault_tolerance``.  Each worker's
step-time posterior (from the Gibbs estimator) gives a predictive
distribution for its next step time.  A worker whose observed times are
persistently improbable under its own posterior is flagged:

  soft anomaly  (slow but alive)  -> partitioner shifts work away (rebalance)
  hard anomaly  (heartbeat lost)  -> evict; elastic re-mesh; checkpoint resume

This replaces fixed timeout heuristics with calibrated, per-worker,
workload-aware thresholds.  The scores and flags are the partitioner's
(``sched.anomaly``, ``sched.flag_stragglers``) on its device; each step
reads back the two masks it returns, as numpy arrays.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Dict, List, Optional

import numpy as np

from repro_torch.sched import Scheduler


@dataclasses.dataclass
class WorkerHealth:
    alive: bool = True
    last_heartbeat: float = 0.0
    anomaly_score: float = 0.0
    flagged: bool = False


class FaultToleranceMonitor:
    def __init__(
        self,
        partitioner: Scheduler,
        *,
        heartbeat_timeout: float = 60.0,
        straggler_sigma: float = 3.0,
    ):
        self.partitioner = partitioner
        self.heartbeat_timeout = heartbeat_timeout
        self.straggler_sigma = straggler_sigma
        self.health = [WorkerHealth() for _ in range(partitioner.num_workers)]
        self.events: List[Dict] = []

    def observe_step(
        self, fracs: np.ndarray, times: np.ndarray, now: Optional[float] = None
    ) -> Dict[str, np.ndarray]:
        """Feed one step's telemetry, (K,) fractions and times; returns
        {stragglers, failures} masks."""
        now = time.monotonic() if now is None else now
        finite = np.isfinite(times)
        for i in np.flatnonzero(finite):
            self.health[i].last_heartbeat = now

        # hard failures: heartbeat timeout, or no completion reported at all
        # (an infinite/missing step time IS a missed heartbeat)
        alive = np.array([h.alive for h in self.health], dtype=bool)
        last = np.array([h.last_heartbeat for h in self.health], dtype=np.float64)
        failures = alive & (~finite | ((now - last) > self.heartbeat_timeout))
        # soft stragglers: posterior-predictive anomaly.  Hard failures carry
        # non-finite times and must never enter the soft-anomaly statistics:
        # a placeholder time would corrupt the dead worker's EWMA and skew
        # the median/MAD baseline the live fleet is judged against.  The
        # validity mask keeps them out (``anomaly`` substitutes interior
        # dummies for masked slots itself).
        scores = self.partitioner.anomaly_scores(fracs, times, valid=finite)
        flags = self.partitioner.flag_stragglers(
            self.straggler_sigma, valid=finite & alive
        )
        n = len(self.health)
        score_of = np.zeros(n)
        score_of[: min(n, len(scores))] = scores[:n]
        flag_of = np.zeros(n, dtype=bool)
        flag_of[: min(n, len(flags))] = flags[:n]
        for h, s, f in zip(self.health, score_of.tolist(), flag_of.tolist()):
            h.anomaly_score = s
            h.flagged = f

        if failures.any():
            self.events.append(
                {"type": "failure", "workers": np.flatnonzero(failures).tolist()}
            )
        if flags.any():
            self.events.append(
                {"type": "straggler", "workers": np.flatnonzero(flags).tolist()}
            )
        return {"stragglers": flags, "failures": failures}

    def evict(self, failures: np.ndarray) -> None:
        """Elastic down-scale: drop failed workers from the fleet."""
        self.partitioner.remove_workers(failures)
        self.health = [h for h, f in zip(self.health, failures) if not f]
        self.events.append({"type": "evict", "count": int(failures.sum())})

    def admit(self, count: int, seed: int = 0) -> None:
        """Elastic up-scale: add fresh workers with uninformed priors."""
        self.partitioner.add_workers(count, seed=seed)
        self.health.extend(WorkerHealth() for _ in range(count))
        self.events.append({"type": "admit", "count": count})
