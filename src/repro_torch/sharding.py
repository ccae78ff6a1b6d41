"""Fleet-axis sharding of the estimation engine over a torch ``DeviceMesh``.

PyTorch counterpart of ``repro.core.sharding``, public as
``repro_torch.core.sharding``.  It depends on torch alone, so every layer that
takes ``sharding=`` imports it downward, ``kernels`` included.  The paper's Gibbs
estimator treats each processing unit's posterior independently, so the
fleet axis K splits across the ranks of a 1-D ``workers`` mesh: each rank
runs the per-worker work (the Normal-Gamma update, the O(K·G·N) grid
posterior, the Beta fit) on its contiguous block of K_pad / n rows, and the
small per-worker results are all-gathered.  The exponent grid and the
hyperprior stay replicated.

``ShardingConfig`` is the one value threaded through the stack:

    core.gibbs.gibbs_batch / fit_fleet / fit_dag      sharding=...
    kernels.ops.posterior_grid_fleet                  sharding=...
    hier.fit_hyperprior_sharded / shrink / surprise   sharding=...
    sched.SchedulerConfig(mesh=...) -> observe / observe_dag / admissions

``None`` everywhere is the single-device path, unchanged.  A fleet whose K
does not divide the shard count is padded with dummy workers (copies of the
last row, their telemetry masked out) and sliced back after the mapped
region.

The state is global: every rank holds all K rows of every leaf, and every
sharded call returns the global result on every rank.  The fleet axis is
split only inside the sharded calls, so :func:`constrain_fleet` has nothing
to place and returns its input.

A mesh is built over an initialized process group (one process per card, as
``torchrun`` starts them):

    torch.distributed.init_process_group("nccl", ...)
    cfg = ShardingConfig.auto()                 # all ranks, axis "workers"
    config = sched.SchedulerConfig(mesh=cfg)    # or mesh=cfg.mesh
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, List, Optional

import torch
import torch.distributed as dist
from torch import Tensor

FLEET_AXIS = "workers"


@dataclasses.dataclass(frozen=True)
class ShardingConfig:
    """How to partition the estimation fleet axis across the ranks of a mesh.

    ``mesh`` is a 1-D ``torch.distributed.device_mesh.DeviceMesh`` whose
    dimension names hold ``axis``; the fleet axis K (or a workflow DAG's
    folded S*K axis) is split across it.  Frozen, hashable and equal by value
    (a ``DeviceMesh`` hashes and compares by its layout and dimension names).
    """

    mesh: Any  # torch.distributed.device_mesh.DeviceMesh
    axis: str = FLEET_AXIS

    def __post_init__(self):
        names = tuple(self.mesh.mesh_dim_names or ())
        if self.axis not in names:
            raise ValueError(f"mesh {names} has no {self.axis!r} axis")

    @staticmethod
    def auto(num_devices: Optional[int] = None, axis: str = FLEET_AXIS) -> "ShardingConfig":
        """A 1-D mesh over the first ``num_devices`` ranks (default all) of
        the initialized default process group, with the device type of its
        backend (NCCL: "cuda", gloo: "cpu").  Raises when no process group is
        initialized: it never makes a one-rank world of its own."""
        if not (dist.is_available() and dist.is_initialized()):
            raise RuntimeError(
                "ShardingConfig.auto() needs an initialized default process group "
                "(torch.distributed.init_process_group)")
        from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

        world = dist.get_world_size()
        n = world if num_devices is None else int(num_devices)
        if not 1 <= n <= world:
            raise ValueError(f"num_devices={n} outside 1..{world}, the process group's size")
        device_type = "cuda" if "nccl" in dist.get_backend() else "cpu"  # gloo: the host's
        if n == world:
            mesh = init_device_mesh(device_type, (n,), mesh_dim_names=(axis,))
        else:  # every rank takes part in building it; ranks >= n are outside it
            mesh = DeviceMesh(device_type, list(range(n)), mesh_dim_names=(axis,))
        return ShardingConfig(mesh=mesh, axis=axis)

    @property
    def num_shards(self) -> int:
        return int(self.mesh.shape[self.mesh.mesh_dim_names.index(self.axis)])

    def pad(self, k: int) -> int:
        """Dummy workers needed to make a K-fleet divide the shard count."""
        return (-k) % self.num_shards

    @property
    def group(self):
        """The process group of ``axis``."""
        return self.mesh.get_group(self.axis)

    @property
    def rank(self) -> int:
        """This process's shard index along ``axis``."""
        return int(self.mesh.get_local_rank(self.axis))

    def check_device(self, x: Tensor) -> None:
        """Raise unless ``x`` lies on the device type the mesh serves."""
        if x.device.type != self.mesh.device_type:
            raise ValueError(
                f"the fleet is on {x.device.type!r} but the {self.axis!r} mesh serves "
                f"{self.mesh.device_type!r} tensors")


# --------------------------------------------------------------------------
# trees of tensors
# --------------------------------------------------------------------------
def tree_map(fn: Callable[[Tensor], Tensor], tree):
    """Apply ``fn`` to every tensor leaf of a tree of (named) tuples, lists
    and dicts, such as a ``GibbsState``; ``None`` stays ``None``."""
    if isinstance(tree, Tensor):
        return fn(tree)
    if tree is None:
        return None
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(tree_map(fn, x) for x in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, x) for x in tree)
    if isinstance(tree, dict):
        return {key: tree_map(fn, x) for key, x in tree.items()}
    raise TypeError(f"unexpected state leaf {type(tree).__name__}")


def _leaves(tree) -> List[Tensor]:
    out: List[Tensor] = []
    tree_map(lambda x: out.append(x) or x, tree)
    return out


def pad_fleet_axis(tree, pad: int):
    """Append ``pad`` dummy rows to every leaf's leading (fleet) axis.

    Dummy rows copy the last real row: finite, of the right dtype, so the
    padded program computes harmless values that :func:`unpad_fleet_axis`
    slices off.  Telemetry padding should carry ``mask=0`` rows instead
    (:func:`shard_fleet_call`'s ``mask_index``)."""
    if pad == 0:
        return tree
    grow = lambda x: torch.cat([x, x[-1:].expand((pad,) + tuple(x.shape[1:]))], dim=0)
    return tree_map(grow, tree)


def pad_fleet_mask(mask: Tensor, pad: int) -> Tensor:
    """``mask`` with ``pad`` zero rows appended: the validity mask of a fleet
    padded by :func:`pad_fleet_axis`, so that its dummy rows count for
    nothing, not even in their own discarded rows."""
    if pad == 0:
        return mask
    return torch.cat([mask, mask.new_zeros((pad,) + tuple(mask.shape[1:]))], dim=0)


def unpad_fleet_axis(tree, k: int):
    """Inverse of :func:`pad_fleet_axis`: keep the first ``k`` fleet rows."""
    return tree_map(lambda x: x[:k], tree)


def local_rows(tree, sharding: ShardingConfig):
    """This rank's contiguous block of K_pad / n rows of every leaf of a
    padded fleet tree (views, no copy).  Raises when a leaf is on a device
    type the mesh does not serve, or when K_pad does not divide the shards."""
    leaves = _leaves(tree)
    k_pad = leaves[0].shape[0]
    for x in leaves:
        sharding.check_device(x)
    n = sharding.num_shards
    if k_pad % n:
        raise ValueError(f"a fleet axis of {k_pad} rows does not divide {n} shards; pad it first")
    block = k_pad // n
    lo = sharding.rank * block
    return tree_map(lambda x: x[lo:lo + block], tree)


def gather_fleet(tree, sharding: ShardingConfig):
    """All-gather every rank's block of rows into the global fleet leaves, on
    every rank: one collective per dtype, the leaves side by side as columns
    of one (block, W) buffer."""
    leaves = _leaves(tree)
    n = sharding.num_shards
    gathered = {}
    for dtype in dict.fromkeys(x.dtype for x in leaves):
        group = [x for x in leaves if x.dtype == dtype]
        block = group[0].shape[0]
        cols = [x.reshape(block, -1) for x in group]
        buf = torch.cat(cols, dim=1) if len(cols) > 1 else cols[0].contiguous()
        out = torch.empty((n * block, buf.shape[1]), dtype=dtype, device=buf.device)
        dist.all_gather(list(out.chunk(n, dim=0)), buf, group=sharding.group)
        start = 0
        for x, c in zip(group, cols):
            gathered[id(x)] = out[:, start:start + c.shape[1]].reshape((n * block,) + tuple(x.shape[1:]))
            start += c.shape[1]
    return tree_map(lambda x: gathered[id(x)], tree)


def shard_fleet_map(fn: Callable, sharding: ShardingConfig) -> Callable:
    """The analogue of ``shard_map`` over the workers axis.

    Every argument and result carries the fleet axis leading, K_pad rows
    dividing the shard count; replicated extras (the grid) are closed over.
    Each rank runs ``fn`` on its contiguous block of K_pad / n rows, and the
    outputs are all-gathered along dim 0, so every rank returns the global
    (K_pad, ...) results.  ``fn`` must not mix fleet rows.
    """

    def wrapped(*args):
        return gather_fleet(fn(*local_rows(args, sharding)), sharding)

    return wrapped


def shard_fleet_call(fn: Callable, sharding: ShardingConfig, args, *, mask_index=None):
    """Pad -> map -> unpad in one place (the fleet-call pattern).

    Every positional argument (tree leaves included) carries the fleet axis
    leading.  If K does not divide the shard count, every argument is padded
    with copies of its last row, except the argument at ``mask_index`` (the
    validity mask), which gets zero rows (:func:`pad_fleet_mask`).  Outputs
    are sliced back to K.
    """
    k = _leaves(args[0])[0].shape[0]
    pad = sharding.pad(k)
    args = tuple(pad_fleet_mask(a, pad) if i == mask_index else pad_fleet_axis(a, pad)
                 for i, a in enumerate(args))
    out = shard_fleet_map(fn, sharding)(*args)
    return unpad_fleet_axis(out, k) if pad else out


def constrain_fleet(tree, sharding: Optional[ShardingConfig], *, axis: int = 0):
    """The reference's placement hint for fleet-axis leaves; here the identity.

    The reference attaches a ``workers`` sharding to each leaf so that its
    rows live on the device that computes them, and calls this placement
    only a locality hint.  The port's state is global and replicated on
    every rank, and the fleet axis is split inside the sharded calls alone,
    so there is nothing to place: ``tree`` itself is returned, with or
    without ``sharding``.  ``axis`` names the fleet axis of the leaves (1 for
    a workflow DAG's (S, K, ...) leaves), as in the reference.
    """
    return tree
