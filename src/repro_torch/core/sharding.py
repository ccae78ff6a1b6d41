"""Fleet-axis sharding of the estimator: the public home of
``repro_torch.sharding``, at the reference's path ``repro.core.sharding``.

The code lives in the top-level ``repro_torch.sharding``, which depends on
torch alone, so that ``kernels.ops.posterior_grid_fleet(sharding=)`` imports
it without importing ``core``.
"""
from repro_torch.sharding import (
    FLEET_AXIS,
    ShardingConfig,
    constrain_fleet,
    gather_fleet,
    local_rows,
    pad_fleet_axis,
    pad_fleet_mask,
    shard_fleet_call,
    shard_fleet_map,
    tree_map,
    unpad_fleet_axis,
)

__all__ = [
    "FLEET_AXIS",
    "ShardingConfig",
    "constrain_fleet",
    "gather_fleet",
    "local_rows",
    "pad_fleet_axis",
    "pad_fleet_mask",
    "shard_fleet_call",
    "shard_fleet_map",
    "tree_map",
    "unpad_fleet_axis",
]
