"""Distributed helpers of the port: the simulated heterogeneous cluster that
feeds the partitioned-serving driver, and, as submodules as in the
reference, ``fault_tolerance`` (heartbeats, Bayesian straggler detection,
elastic resize around a ``sched.Scheduler``) and ``compression`` (int8 and
top-k gradient compression with error feedback).

Two sharding concerns are easy to conflate.  Estimator fleet sharding
(``repro_torch.core.sharding``, re-exported here as :class:`ShardingConfig`)
splits the Bayesian estimator's worker axis K across the ranks of a
``workers`` ``DeviceMesh``: thread it through
``sched.SchedulerConfig(mesh=...)`` or ``core.gibbs.*(sharding=...)``.
Model-tensor sharding (``repro_torch.distributed.sharding``, the
counterpart of ``repro.distributed.sharding``) maps the model's parameters
and caches onto a (pod,) data x model ``DeviceMesh`` as DTensors; the model
stack takes it through ``models.MeshInfo``.
"""
from repro_torch.sharding import ShardingConfig

from .simulated_cluster import SimulatedCluster, WorkerSpec

__all__ = ["ShardingConfig", "SimulatedCluster", "WorkerSpec"]
