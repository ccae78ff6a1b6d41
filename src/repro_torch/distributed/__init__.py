"""Distributed helpers of the port: the simulated heterogeneous cluster that
feeds the partitioned-serving driver.  The reference's sharding, gradient
compression and fault-tolerance shells come with ROADMAP items 10 and 11."""
from .simulated_cluster import SimulatedCluster, WorkerSpec

__all__ = ["SimulatedCluster", "WorkerSpec"]
