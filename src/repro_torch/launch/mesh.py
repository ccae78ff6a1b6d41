"""Production mesh construction.

The port's counterpart of ``repro.launch.mesh``, over a torch ``DeviceMesh``.
Functions (not module constants), so importing never touches a process
group.  Single pod: 16x16 = 256 ranks, axes (data, model).  Multi pod:
2x16x16 = 512 ranks, axes (pod, data, model); the pod axis is an additional
pure data-parallel dimension across pods.  Each mesh is laid over ranks
0..n-1 of an initialized world, which may hold more ranks (the dry run's
fake world of 512 holds both meshes).
"""
from __future__ import annotations

import math
from typing import Optional, Tuple


def production_shape(multi_pod: bool = False) -> Tuple[Tuple[int, ...], Tuple[str, ...]]:
    """(shape, axis names) of the production mesh."""
    if multi_pod:
        return (2, 16, 16), ("pod", "data", "model")
    return (16, 16), ("data", "model")


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    """The (16, 16) ("data", "model") or (2, 16, 16) ("pod", "data", "model")
    ``DeviceMesh`` over ranks 0..n-1 of the initialized world."""
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import DeviceMesh

    shape, axes = production_shape(multi_pod)
    n = math.prod(shape)
    if dist.get_world_size() < n:
        raise ValueError(f"the production mesh {shape} needs {n} ranks; the world has "
                         f"{dist.get_world_size()}")
    return DeviceMesh(device_type, torch.arange(n).reshape(shape), mesh_dim_names=axes)


def make_host_mesh(device_type: str = "cpu"):
    """The whole current world as a 1-D ("data",) mesh (CPU tests and examples)."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    return init_device_mesh(device_type, (dist.get_world_size(),), mesh_dim_names=("data",))


def batch_axes(mesh) -> Tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.mesh_dim_names)


def model_axis(mesh) -> Optional[str]:
    return "model" if "model" in mesh.mesh_dim_names else None
