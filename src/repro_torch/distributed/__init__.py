"""Distributed helpers of the port: the simulated heterogeneous cluster that
feeds the partitioned-serving driver, and, as submodules as in the
reference, ``fault_tolerance`` (heartbeats, Bayesian straggler detection,
elastic resize around a ``sched.Scheduler``) and ``compression`` (int8 and
top-k gradient compression with error feedback).  The reference's sharding
comes with ROADMAP item 10."""
from .simulated_cluster import SimulatedCluster, WorkerSpec

__all__ = ["SimulatedCluster", "WorkerSpec"]
