"""Multi-pod dry run: one whole step of an (arch, shape) cell on a production
mesh, counted per device, with nothing allocated.

The port's counterpart of ``repro.launch.dryrun``'s ``full_compile``,
``run_cell`` and ``main``.  The reference lowers the step with XLA on 512
forced host devices and reads ``cost_analysis`` and ``memory_analysis``.
The port has no compiler: it runs the step once, eagerly, on fake tensors
(``FakeTensorMode``) placed as DTensors by ``distributed.sharding``'s
rules on a ``DeviceMesh`` over a fake world of 512 ranks
(``init_process_group("fake")``; this process is rank 0), and a dispatch
mode (``DeviceCounter``) counts what rank 0 does:

* ``full_cost.flops``: the products' FLOPs (torch's ``flop_counter``
  formulas; elementwise work counts none) plus each kernel's own count;
* ``full_cost.bytes``: eager torch's traffic, each operation's inputs plus
  its new outputs, unfused (a view moves nothing; a row write into a cache
  counts the rows); each kernel by its own count;
* ``full_coll``: the bytes of the collectives rank 0 runs, by kind, under
  the reference's traffic model (an all-reduce twice its result, any other
  collective its result once);
* ``memory``: the high-water mark of rank 0's live storages during the
  step, the arguments (parameters, optimizer state, batch, cache) included.

Only the local tensors count.  DTensor's sharding propagator runs each new
operation once on global fake tensors to learn its output's shape; those
operations, and their tensors, are left out.  K2 (``repro_torch::
decode_attention`` and ``_lse``), K3 and K3's backward are each one custom
op, counted by the formulas of their bounds (``kernels.decode_attention.
work``, ``kernels.lru_scan.work`` and ``backward_work``), so a cell counts
the same on ``--device cpu`` as on ``cuda``: the fake tensors reach each
op's shape rule, never the plain version or the kernel.

The unit roofline (``with_units``, the single mesh) decomposes the step
as the reference does: ``train_units`` and ``serve_units`` run one layer
cycle's function, the embedding and head, and the optimizer once each on
fake, placed arguments under a fresh counter, and ``assemble`` scales each
unit by its trips into per-device FLOPs, bytes and collective bytes and a
bound under an H100 hardware model (below).  The collective term is by
mesh axis: the counter records each collective's bytes under the mesh dim
whose group it runs on, and each axis has its bandwidth (NVLink within a
node, the NICs across nodes).

Recorded differences from the reference: every layer is counted
(``full_cost``), where the reference's scanned stack counts one layer cycle
once (``full_cost_scan_body_once``); bytes are unfused; ``alias_bytes`` is
0, because the port updates caches in place (the cache is an argument, and
the step's outputs are only what it makes anew); the world is a fake
process group, not 512 XLA host devices; a unit is one eager run, not a
compile; the ``rest`` layers (``_cycles_and_rest``) count in no unit, as in
the reference, while ``full_cost`` counts them.

    python -m repro_torch.launch.dryrun --arch tinyllama-1.1b --shape decode_32k \\
        --mesh single --device cpu
    python -m repro_torch.launch.report --dir experiments/dryrun_torch

Nothing here starts a world or touches a device at import.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import functools
import json
import math
import pathlib
import sys
import time
import traceback
import weakref
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensor, unset_fake_temporarily

from ..configs import ARCHS, SHAPES, RunConfig, applicable, get_arch, get_shape
from ..distributed import sharding as shd
from ..models import model_zoo, transformer
from ..models.layers import ApplyCtx, MeshInfo, constrain_batch, mesh_scope, rmsnorm, rmsnorm_spec
from ..models.params import abstract_params, axes_tree, leaves
from ..optim import adamw
from ..train import serve_step as ss
from ..train import train_step as ts
from .mesh import batch_axes as mesh_batch_axes
from .mesh import make_production_mesh
from .mesh import model_axis as mesh_model_axis

# Options toggled from the CLI, as the reference's; ``device`` picks the
# mesh's device type (and so the kernels' route).
OPTS: Dict[str, Any] = {"seq_shard_attention": False, "q_chunk": 2048, "remat": "full",
                        "fsdp": True, "seq_parallel": False, "fuse_projections": False,
                        "capacity_factor": None, "grad_dtype": None, "device": "cuda"}
WORLD = 512  # the fake world: both production meshes fit in it

# ---------------------------------------------------------------------------
# H100 hardware model (per GPU; PERF.md §3 gives the sources)
# ---------------------------------------------------------------------------
PEAK_FLOPS = 989e12  # bf16 dense tensor cores, H100 SXM5 datasheet: 1979 TFLOP/s with sparsity, halved
HBM_BW = 3.35e12  # B/s, HBM3 of the H100 SXM5 (datasheet)
NVLINK_BW = 450e9  # B/s each way: NVLink 4 gives a GPU 900 GB/s in both directions (datasheet)
NIC_BW = 50e9  # B/s: one 400 Gb/s ConnectX-7 a GPU, the DGX H100 compute fabric
GPUS_PER_NODE = 8  # DGX H100; the production mesh takes ranks 0..n-1 row-major, node rank // 8
COLL_KINDS = ("all-reduce", "all-gather", "reduce-scatter", "all-to-all", "collective-permute")
# The collectives by the name of their op (c10d's in-place ops, the
# functional ones DTensor calls, their autograd forms); the rest of those
# namespaces (wait, barrier) carries no payload.
_COLL_OPS = {
    "all-reduce": ("all_reduce", "allreduce_", "allreduce_coalesced_", "all_reduce_coalesced"),
    "all-gather": ("all_gather_into_tensor", "allgather_", "_allgather_base_",
                   "all_gather_into_tensor_coalesced", "allgather_into_tensor_coalesced_",
                   "all_gather_into_tensor_out"),
    "reduce-scatter": ("reduce_scatter_tensor", "reduce_scatter_", "_reduce_scatter_base_",
                       "reduce_scatter_tensor_coalesced", "reduce_scatter_tensor_out"),
    "all-to-all": ("all_to_all_single", "alltoall_", "alltoall_base_", "shard_dim_alltoall"),
    "collective-permute": ("send", "recv_", "recv_any_source_"),
}
_COLL_OF = {name: kind for kind, names in _COLL_OPS.items() for name in names}
# DTensor's Shard(i) -> Shard(j) is ``_dtensor::shard_dim_alltoall``
_COLL_NAMESPACES = ("c10d", "_c10d_functional", "_c10d_functional_autograd", "_dtensor")
OTHER = "other"  # the axis of a collective over a group that is no mesh dim
PROPAGATION, ALLTOALL = "propagation", "alltoall"  # the sites ``_dispatch_site`` tells apart
# Operations that move no bytes: allocations, device queries, waits, the
# functional collectives' autograd wrapper.
_NO_TRAFFIC = ("empty", "empty_strided", "empty_like", "new_empty", "new_empty_strided",
               "device", "wait_tensor", "_wrap_tensor_autograd", "lift_fresh",
               "_local_scalar_dense")
# Row reads (an embedding lookup) move the rows they read, not the table;
# in-place row writes (the decode step's cache write) the rows they write.
_ROW_READS = ("index", "index_select", "embedding", "gather")
_ROW_WRITES = ("index_copy_", "index_put_")


# ---------------------------------------------------------------------------
# the per-device counter
# ---------------------------------------------------------------------------


def _dispatch_site() -> Optional[str]:
    """PROPAGATION when the current operation runs inside DTensor's sharding
    propagator (on global fake tensors, to learn an output's shape);
    ALLTOALL inside DTensor's ``shard_dim_alltoall``, which on a CPU mesh
    (gloo has no all-to-all) runs as an all-gather and a chunk; else None."""
    f = sys._getframe(2)
    while f is not None:
        code = f.f_code
        if "sharding_prop" in code.co_filename:
            return PROPAGATION
        if code.co_name == "shard_dim_alltoall" and code.co_filename.endswith("_collective_utils.py"):
            return ALLTOALL
        f = f.f_back
    return None


def _tensors(tree) -> List[torch.Tensor]:
    return [x for x in torch.utils._pytree.tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _group_name(func, args, kwargs) -> Optional[str]:
    """The name of the process group a collective runs on: its
    ``group_name`` argument (a name, or a group), else its
    ``process_group``'s (a boxed group, in c10d's in-place ops)."""
    import torch.distributed as dist

    for i, arg in enumerate(func._schema.arguments):
        if arg.name in ("group_name", "process_group"):
            v = kwargs[arg.name] if arg.name in kwargs else args[i] if i < len(args) else None
            if isinstance(v, torch.ScriptObject):
                v = dist.ProcessGroup.unbox(v)
            return v if isinstance(v, str) else getattr(v, "group_name", None)
    return None


def _kernel_work():
    """The kernels' custom ops -> (name, their (operations, bytes) formula)."""
    from ..kernels import decode_attention as k2
    from ..kernels import lru_scan as k3

    ops = torch.ops.repro_torch
    return {
        ops.decode_attention.default: ("decode_attention", k2.work),
        ops.decode_attention_lse.default: (
            "decode_attention", lambda q, k, v, n: k2.work(q, k, v, n, return_lse=True)),
        ops.lru_scan.default: ("lru_scan", k3.work),
        ops.lru_scan_bwd.default: ("lru_scan_bwd", k3.backward_work),
    }


class DeviceCounter(torch.utils._python_dispatch.TorchDispatchMode):
    """A dispatch mode that counts one rank's work: FLOPs, bytes, collective
    bytes by kind, kernel calls, and the high-water mark of its live
    storages.  It sees the local tensors: an operation on DTensors is
    passed on (DTensor's dispatch then runs it on the shards, which this
    mode sees), and the sharding propagator's operations on global fake
    tensors are left out.  ``hold`` counts tensors that are live before the
    step (its arguments).  Given ``mesh``, the collective bytes are also
    counted by the mesh dim whose group they run on (``coll_axis``; OTHER
    for a group that is no mesh dim)."""

    def __init__(self, mesh=None):
        super().__init__()
        from torch.utils.flop_counter import flop_registry

        self._flop_registry = flop_registry
        self._kernels = _kernel_work()
        self.flops = 0.0
        self.bytes = 0.0
        self.coll = {k: 0 for k in COLL_KINDS}
        self.coll_axis: Dict[str, int] = {}
        self._axis_of = {} if mesh is None else {
            mesh.get_group(i).group_name: name for i, name in enumerate(mesh.mesh_dim_names)}
        self.kernel_calls: Dict[str, int] = {}
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live: Dict[int, int] = {}
        self._in_dtensor = False

    # --- memory ------------------------------------------------------------
    def _free(self, key: int) -> None:
        self.live_bytes -= self._live.pop(key, 0)

    def track(self, t: torch.Tensor) -> int:
        """Count ``t``'s storage as live until it is freed; returns the bytes
        it added (0 if it was live already)."""
        st = t.untyped_storage()
        key = st._cdata
        if key in self._live:
            return 0
        n = st.nbytes()
        self._live[key] = n
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)
        weakref.finalize(st, self._free, key)
        return n

    def hold(self, tree) -> int:
        """Count the local tensors of ``tree`` as live; returns their bytes."""
        from ..device import local

        return sum(self.track(local(t)) for t in _tensors(tree))

    @staticmethod
    def storages(tree) -> Dict[int, int]:
        """{storage: bytes} of the local tensors of ``tree``."""
        from ..device import local

        return {local(t).untyped_storage()._cdata: local(t).untyped_storage().nbytes()
                for t in _tensors(tree)}

    # --- dispatch ----------------------------------------------------------
    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            if self._in_dtensor:
                return NotImplemented  # DTensor's dispatch, which runs it on the shards
            return self._dtensor_dispatch(func, args, kwargs)
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        fake = any(isinstance(t, FakeTensor) for t in ins + outs)
        site = _dispatch_site() if fake else None
        if not fake or site == PROPAGATION:
            return out  # DTensor's host bookkeeping, or its propagator's global tensors
        for t in outs:
            self.track(t)
        namespace, _, name = func._schema.name.partition("::")
        if site == ALLTOALL and name != "shard_dim_alltoall":
            # the CPU mesh's all-gather and chunk, counted as the card's
            # all-to-all: its input sent, as many bytes received
            if _COLL_OF.get(name) == "all-gather":
                payload = sum(_nbytes(t) for t in _tensors(args[0]))
                self._collective("all-to-all", payload, func, args, kwargs)
                self.bytes += 2 * payload
            return out
        if func in self._kernels:
            name, work = self._kernels[func]
            flops, nbytes = work(*args, **kwargs)
            self.kernel_calls[name] = self.kernel_calls.get(name, 0) + 1
            self.flops += flops
            self.bytes += nbytes
            return out
        if namespace in _COLL_NAMESPACES:
            kind = _COLL_OF.get(name)
            if kind is not None:
                payload = sum(_nbytes(t) for t in (outs or _tensors(args[0])))
                self._collective(kind, 2 * payload if kind == "all-reduce" else payload,
                                 func, args, kwargs)
        if func._overloadpacket in self._flop_registry:
            self.flops += self._flop_registry[func._overloadpacket](*args, **kwargs, out_val=out)
        self.bytes += self._traffic(func, name, ins, outs, args)
        return out

    def _collective(self, kind: str, payload: int, func, args, kwargs) -> None:
        self.coll[kind] += payload
        axis = self._axis_of.get(_group_name(func, args, kwargs), OTHER)
        self.coll_axis[axis] = self.coll_axis.get(axis, 0) + payload

    def _dtensor_dispatch(self, func, args, kwargs):
        """``func`` on DTensors through DTensor's dispatch, with the fake mode
        unset and this mode on: the shards are fake tensors, which compute
        fake by their own mode, and this mode counts what they do, while the
        tensors DTensor makes for its host bookkeeping (a shard's offsets,
        read back with ``int()`` or ``tolist()``, which a fake tensor cannot
        give) are real, and not counted."""
        self._in_dtensor = True
        try:
            with unset_fake_temporarily(), self:
                return func(*args, **kwargs)
        finally:
            self._in_dtensor = False

    @staticmethod
    def _traffic(func, name: str, ins, outs, args) -> int:
        if name in _NO_TRAFFIC or any(r.alias_info is not None and not r.alias_info.is_write
                                      for r in func._schema.returns):
            return 0  # an allocation, a query, a view
        if name in _ROW_READS:  # the index read, the rows read and written
            return sum(_nbytes(t) for t in ins if t is not args[0]) + \
                2 * sum(_nbytes(t) for t in outs)
        if name in _ROW_WRITES:  # the source (and index) read, as many bytes written
            rest = [t for t in ins if t is not args[0]]
            return sum(_nbytes(t) for t in rest) + _nbytes(rest[-1])
        fresh = [t for t in outs if not any(t is i for i in ins)]
        return sum(_nbytes(t) for t in ins) + sum(_nbytes(t) for t in fresh)


# ---------------------------------------------------------------------------
# the fake world and the placed, shape-only arguments
# ---------------------------------------------------------------------------


def fake_world(world_size: int = WORLD) -> None:
    """Rank 0 of a fake process group of ``world_size`` ranks (collectives
    return at once and move nothing), unless a world is up already."""
    import torch.distributed as dist

    if dist.is_initialized():
        if dist.get_world_size() < world_size:
            raise RuntimeError(f"a world of {dist.get_world_size()} ranks is up; the dry run "
                               f"needs {world_size}")
        return
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=world_size)


def _zip_map(fn, tree, other):
    if isinstance(tree, dict):
        return {k: _zip_map(fn, tree[k], other[k]) for k in tree}
    if isinstance(tree, list):
        return [_zip_map(fn, x, y) for x, y in zip(tree, other)]
    return fn(tree, other)


def placed(like: torch.Tensor, spec, mesh, device, dtype=None):
    """A ``DTensor`` of ``like``'s shape (and ``dtype``, else its own) placed
    by ``spec``, whose local shard is a new tensor of the shard's shape on
    ``device`` (fake under ``FakeTensorMode``): no global tensor is made."""
    from torch.distributed.tensor import DTensor

    pl = shd.placements(spec, mesh)
    shape = list(like.shape)
    for i, p in enumerate(pl):
        if p.is_shard():
            shape[p.dim] //= mesh.size(i)
    loc = torch.empty(shape, dtype=dtype or like.dtype, device=device)
    return DTensor.from_local(loc, mesh, pl, run_check=False, shape=like.shape,
                              stride=torch.empty(like.shape, device="meta").stride())


def place_tree(tree, specs, mesh, device, dtype=None):
    return _zip_map(lambda t, spec: placed(t, spec, mesh, device, dtype), tree, specs)


def _bdims_for(mesh, dim_size: int) -> Optional[Tuple[str, ...]]:
    """The data axes a batch dim divides, dropping 'pod' first (long_500k's
    batch of 1 is replicated)."""
    bdims = mesh_batch_axes(mesh)
    while bdims:
        if dim_size % shd.axes_size(mesh, bdims) == 0:
            return bdims
        bdims = bdims[1:]
    return None


def batch_specs(batch_abs, mesh, *, microbatched: bool = False):
    """Serving batches split dim 0 over the data axes, train batches (M, B/M,
    ...) dim 1, each where it divides, else replicated."""

    def one(a):
        d = 1 if microbatched else 0
        bdims = _bdims_for(mesh, a.shape[d])
        if bdims is None:
            return shd.PS(*([None] * a.ndim))
        lead = (None, bdims) if microbatched else (bdims,)
        return shd.PS(*lead, *([None] * (a.ndim - len(lead))))

    return _zip_map(lambda a, _: one(a), batch_abs, batch_abs)


def optimizer_dtype(cfg) -> str:
    """The AdamW moments' dtype of a cell: bfloat16 above 2e11 parameters,
    as the reference's dry run picks it (the ``Trainer`` keeps float32)."""
    return "bfloat16" if model_zoo.param_count(cfg) > 2e11 else "float32"


# ---------------------------------------------------------------------------
# the whole step
# ---------------------------------------------------------------------------


def full_compile(cfg, run: RunConfig, shape, mesh) -> Dict[str, Any]:
    """One whole step of the cell on fake tensors, counted on rank 0: the
    train step (``make_train_step`` on ``adamw.abstract_state``), a prefill
    or a decode step (``make_prefill_step`` / ``make_decode_step``), its
    arguments placed by the sharding rules.  Returns the reference's keys
    where the meaning is the same (``memory``, ``num_microbatches``) and
    ``full_cost``, ``full_coll``, ``kernel_calls`` and ``step_seconds``."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    mi = MeshInfo(mesh, mesh_batch_axes(mesh), mesh_model_axis(mesh))
    dp = shd.axes_size(mesh, mesh_batch_axes(mesh))
    device = torch.device(mesh.device_type)
    train = shape.kind == "train"
    params_abs = model_zoo.abstract_model_params(cfg)
    params_specs = shd.tree_shardings(
        params_abs, model_zoo.model_axes(cfg), mesh,
        shd.default_rules(mesh, fsdp=train and OPTS["fsdp"]))
    extra: Dict[str, Any] = {}
    with FakeTensorMode(allow_non_fake_inputs=True):
        params = place_tree(params_abs, params_specs, mesh, device)
        if train:
            ctx = ApplyCtx(mode="train", mesh_info=mi, remat=run.remat, q_chunk=OPTS["q_chunk"],
                           seq_shard_attention=OPTS["seq_shard_attention"],
                           seq_parallel=OPTS["seq_parallel"],
                           fuse_projections=OPTS["fuse_projections"])
            m = max(shape.global_batch // dp, 1)
            batch_abs = model_zoo.input_specs(cfg, shape, num_microbatches=m)
            batch = place_tree(batch_abs, batch_specs(batch_abs, mesh, microbatched=True), mesh,
                               device)
            opt_dt = ts.DTYPES[run.optimizer_dtype]
            opt_abs = adamw.abstract_state(params_abs, opt_dt)
            opt = adamw.AdamWState(
                m=place_tree(opt_abs.m, params_specs, mesh, device),
                v=place_tree(opt_abs.v, params_specs, mesh, device),
                count=torch.zeros((), dtype=torch.int32, device=device))
            step = torch.zeros((), dtype=torch.int32, device=device)
            fn = ts.make_train_step(cfg, run, ctx=ctx, num_microbatches=m)
            args = (params, opt, batch, step)
            extra["num_microbatches"] = m
        else:
            cache_abs = model_zoo.abstract_cache(cfg, shape)
            cache = place_tree(cache_abs, shd.cache_shardings(
                cache_abs, transformer.cache_axes_tree(cfg), mesh), mesh, device)
            batch_abs = model_zoo.input_specs(cfg, shape)
            batch = place_tree(batch_abs, batch_specs(batch_abs, mesh), mesh, device)
            if shape.kind == "prefill":
                ctx = ApplyCtx(mode="prefill", mesh_info=mi, q_chunk=OPTS["q_chunk"],
                               seq_shard_attention=OPTS["seq_shard_attention"])
                fn = ss.make_prefill_step(cfg, ctx=ctx)
                args = (params, batch, cache)
            else:
                fn = ss.make_decode_step(cfg, ctx=ApplyCtx(mode="decode", mesh_info=mi))
                args = (params, batch["token"], cache)
        counter = DeviceCounter(mesh)
        argument_bytes = counter.hold(args)
        t0 = time.time()
        with counter:
            out = fn(*args)
        extra["step_seconds"] = round(time.time() - t0, 1)
        # what the step made anew; a cache written in place is an argument
        arguments = counter.storages(args)
        output_bytes = sum(n for key, n in counter.storages(out).items() if key not in arguments)
        del out
    temp = counter.peak_bytes - argument_bytes - output_bytes
    return {
        "memory": {"argument_bytes": float(argument_bytes), "output_bytes": float(output_bytes),
                   "temp_bytes": float(temp), "alias_bytes": 0.0,
                   "peak_bytes_est": float(counter.peak_bytes)},
        "full_cost": {"flops": counter.flops, "bytes": counter.bytes},
        "full_coll": dict(counter.coll),
        "full_coll_by_axis": dict(counter.coll_axis),
        "kernel_calls": dict(counter.kernel_calls),
        "counting": {
            "per": "device (rank 0's local tensors)",
            "layers": "every layer (the reference: the scanned body once)",
            "flops": "products by torch.utils.flop_counter, kernels by their own formulas",
            "bytes": "eager torch: each operation's inputs plus new outputs, unfused",
            "alias_bytes": "0: caches are updated in place; outputs are what the step made anew",
        },
        **extra,
    }


def cut_cell(cfg, shape, mesh_shape: Tuple[int, ...] = (1, 1), *, device: str = "cuda",
             run: Optional[RunConfig] = None) -> Dict[str, Any]:
    """``full_compile`` of a cell cut to size: ``cfg`` at ``shape`` on a
    ("data", "model") mesh of ``mesh_shape`` over the first ranks of the
    fake world (started if none is up), ``run`` the cell's settings by
    default (its ``optimizer_dtype``, remat "full")."""
    from torch.distributed.device_mesh import DeviceMesh

    fake_world()
    mesh = DeviceMesh(device, torch.arange(math.prod(mesh_shape)).reshape(mesh_shape),
                      mesh_dim_names=("data", "model"))
    run = run or RunConfig(model=cfg, shape=shape, optimizer_dtype=optimizer_dtype(cfg),
                           remat=OPTS["remat"])
    return full_compile(cfg, run, shape, mesh)


# ---------------------------------------------------------------------------
# unit runs (single-pod cost decomposition)
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class UnitResult:
    """One unit's per-device counts, run once; ``trips`` the times a step
    runs it.  ``coll_by_axis`` holds the collective bytes by mesh axis."""

    name: str
    trips: int
    flops: float
    bytes: float
    coll: Dict[str, int]
    coll_by_axis: Dict[str, int] = dataclasses.field(default_factory=dict)

    def scaled(self) -> Dict[str, Any]:
        return {
            "flops": self.flops * self.trips,
            "bytes": self.bytes * self.trips,
            "coll": {k: v * self.trips for k, v in self.coll.items()},
            "coll_by_axis": {k: v * self.trips for k, v in self.coll_by_axis.items()},
        }


def run_unit(name: str, trips: int, fn, args, mesh, ctx: ApplyCtx) -> UnitResult:
    """``fn(*args)`` once on fake, placed arguments under a fresh counter
    (the reference's ``compile_unit``)."""
    counter = DeviceCounter(mesh)
    with counter, mesh_scope(ctx):
        fn(*args)
    return UnitResult(name, trips, counter.flops, counter.bytes, dict(counter.coll),
                      dict(counter.coll_axis))


def _act_spec(mesh, ndim: int, batch: int):
    """An activation's spec: its batch over the data axes where they divide it."""
    return shd.PS(_bdims_for(mesh, batch), *([None] * (ndim - 1)))


def _placed_act(shape, dtype, mesh, device, *, grad: bool = False):
    meta = torch.empty(shape, dtype=dtype, device="meta")
    x = placed(meta, _act_spec(mesh, len(shape), shape[0]), mesh, device)
    return x.requires_grad_(True) if grad else x


def _placed_params(spec, cfg, mesh, device, *, fsdp: bool, grad: bool = False):
    """``spec``'s parameters in the model dtype, placed by the default rules."""
    p_abs = abstract_params(spec, model_zoo.model_dtype(cfg))
    specs = shd.tree_shardings(p_abs, axes_tree(spec), mesh, shd.default_rules(mesh, fsdp=fsdp))
    tree = place_tree(p_abs, specs, mesh, device)
    for t in leaves(tree) if grad else ():
        t.requires_grad_(True)
    return tree


def _cycle_caches(cfg, mesh, device, batch: int, max_len: int):
    """One cycle's decode caches (a list over the pattern), placed by the
    cache rules."""
    out = []
    for kind in cfg.pattern:
        c_abs = transformer.init_block_cache(cfg, kind, batch, max_len,
                                             model_zoo.model_dtype(cfg), "meta")
        out.append(place_tree(c_abs, shd.cache_shardings(
            c_abs, transformer._block_cache_axes(cfg, kind), mesh), mesh, device))
    return out


def _value_and_grad(loss, wrt):
    """The gradient of ``loss`` for every leaf of ``wrt``, each reduced to
    its leaf's placements, as the train step reduces it."""
    flat = leaves(wrt)
    grads = torch.autograd.grad(loss, flat, allow_unused=True)
    return loss, [g.redistribute(p.device_mesh, p.placements) if g is not None else g
                  for p, g in zip(flat, grads)]


def _head_spec(cfg):
    """The embedding, the final norm and the head (untied) of ``cfg``."""
    full = transformer.lm_spec(cfg)
    spec = {"embed": full["embed"], "final_norm": rmsnorm_spec(cfg.d_model)}
    if "head" in full:
        spec["head"] = full["head"]
    return spec


def train_units(cfg, run: RunConfig, shape, mesh, M: int) -> List[UnitResult]:
    """The train step's units: one layer cycle's forward and backward
    (``cycle_vg``, n_cycles x M trips) under the run's remat, as
    ``transformer._run_stack`` wraps it; the encoder's cycle (``enc_cycle_vg``,
    encdec); the embedding, head and loss (``embed_head_vg``, M); the AdamW
    update (``optimizer``, 1).  The reference's units and trips."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.utils.checkpoint import checkpoint, create_selective_checkpoint_contexts

    fsdp = OPTS["fsdp"]
    device = torch.device(mesh.device_type)
    mi = MeshInfo(mesh, mesh_batch_axes(mesh), mesh_model_axis(mesh))
    ctx = ApplyCtx(mode="train", mesh_info=mi, remat=run.remat,
                   q_chunk=OPTS["q_chunk"], seq_shard_attention=OPTS["seq_shard_attention"],
                   seq_parallel=OPTS["seq_parallel"], fuse_projections=OPTS["fuse_projections"])
    dt = model_zoo.model_dtype(cfg)
    b_mb, t, d = shape.global_batch // M, shape.seq_len, cfg.d_model
    t_text = t - cfg.vision_patches if cfg.vision_patches else t
    n_cycles, rest = transformer._cycles_and_rest(cfg)
    units: List[UnitResult] = []

    def cycle_vg(ccfg, cyc_params, x, enc_out=None):
        positions = torch.arange(x.shape[1], device=device)

        def cycle(cp, xx, aux):
            return transformer.apply_cycle(ccfg, cp, xx, ctx=ctx, positions=positions,
                                           enc_out=enc_out, aux=aux)

        aux = torch.zeros((), dtype=torch.float32, device=device)
        if ctx.remat == "none":
            y, aux = cycle(cyc_params, x, aux)
        else:
            saving = {}
            if ctx.remat in ("dots", "outs"):
                weights = {transformer._storage(p) for p in leaves(cyc_params)}
                saving["context_fn"] = functools.partial(
                    create_selective_checkpoint_contexts,
                    transformer.remat_policy(ctx.remat, weights))
            y, aux = checkpoint(cycle, cyc_params, x, aux, use_reentrant=False, **saving)
        y = constrain_batch(y, ctx)  # made whole, as the next cycle pins its input
        return _value_and_grad(torch.sum(y.float()) * 1e-6 + aux,
                               [cyc_params, x] + ([enc_out] if enc_out is not None else []))

    with FakeTensorMode(allow_non_fake_inputs=True):
        cyc = [_placed_params(transformer.block_spec(cfg, k), cfg, mesh, device, fsdp=fsdp,
                              grad=True) for k in cfg.pattern]
        x = _placed_act((b_mb, t, d), dt, mesh, device, grad=True)
        args = (cfg, cyc, x)
        if cfg.family == "encdec":
            args += (_placed_act((b_mb, cfg.encoder_seq, d), dt, mesh, device, grad=True),)
        units.append(run_unit("cycle_vg", n_cycles * M, cycle_vg, args, mesh, ctx))

        if cfg.family == "encdec":
            from ..models.encdec import encoder_cfg

            ecfg = encoder_cfg(cfg)
            ecyc = [_placed_params(transformer.block_spec(ecfg, k), ecfg, mesh, device,
                                   fsdp=fsdp, grad=True) for k in ecfg.pattern]
            ex = _placed_act((b_mb, cfg.encoder_seq, d), dt, mesh, device, grad=True)
            units.append(run_unit("enc_cycle_vg", ecfg.num_layers * M, cycle_vg,
                                  (ecfg, ecyc, ex), mesh, ctx))

        def eh_vg(hp, tokens, labels, x):
            e = transformer._embed(cfg, hp, tokens, None, ctx)
            h = rmsnorm(hp["final_norm"], x + e, cfg.norm_eps)
            logits = transformer._head(cfg, hp, h, ctx)
            # the port's loss reads whole rows of the vocab (``train_step.loss_fn``)
            logits, labels = constrain_batch(logits, ctx), constrain_batch(labels, ctx)
            xent, _ = ts.cross_entropy(logits, labels, cfg.vocab_size)
            return _value_and_grad(xent, [hp, x])

        hp = _placed_params(_head_spec(cfg), cfg, mesh, device, fsdp=fsdp, grad=True)
        tokens, labels = (_placed_act((b_mb, t_text), torch.int32, mesh, device) for _ in range(2))
        xt = _placed_act((b_mb, t_text, d), dt, mesh, device, grad=True)
        units.append(run_unit("embed_head_vg", M, eh_vg, (hp, tokens, labels, xt), mesh, ctx))

        params_abs = model_zoo.abstract_model_params(cfg)
        specs = shd.tree_shardings(params_abs, model_zoo.model_axes(cfg), mesh,
                                   shd.default_rules(mesh, fsdp=fsdp))
        params = place_tree(params_abs, specs, mesh, device)
        opt_abs = adamw.abstract_state(params_abs, ts.DTYPES[run.optimizer_dtype])
        opt = adamw.AdamWState(m=place_tree(opt_abs.m, specs, mesh, device),
                               v=place_tree(opt_abs.v, specs, mesh, device),
                               count=torch.zeros((), dtype=torch.int32, device=device))
        grads = place_tree(params_abs, specs, mesh, device, ts.DTYPES[run.grad_dtype])
        units.append(run_unit("optimizer", 1, ts.make_optimizer_unit(cfg, run),
                              (params, opt, grads), mesh, ctx))
    return units


def serve_units(cfg, shape, mesh, kind: str) -> List[UnitResult]:
    """The serving step's units: one layer cycle's prefill or decode with its
    caches (``cycle_prefill`` / ``cycle_decode``, n_cycles trips); the
    encoder's cycle (``enc_cycle_fwd``, encdec prefill); the embedding, head
    and greedy pick (``embed_head_<mode>``, 1).  The reference's units and
    trips; parameters in the serving layout (no FSDP)."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    device = torch.device(mesh.device_type)
    mi = MeshInfo(mesh, mesh_batch_axes(mesh), mesh_model_axis(mesh))
    mode = "prefill" if kind == "prefill" else "decode"
    ctx = ApplyCtx(mode=mode, mesh_info=mi, q_chunk=OPTS["q_chunk"],
                   seq_shard_attention=OPTS["seq_shard_attention"])
    dt = model_zoo.model_dtype(cfg)
    b, d = shape.global_batch, cfg.d_model
    t = shape.seq_len if kind == "prefill" else 1
    n_cycles, rest = transformer._cycles_and_rest(cfg)
    units: List[UnitResult] = []
    scalar = lambda shp: placed(torch.empty(shp, dtype=torch.int32, device="meta"),
                                shd.PS(*([None] * len(shp))), mesh, device)

    def cycle_fwd(cyc_params, x, caches, enc_out=None):
        if kind == "prefill":
            positions, length = torch.arange(t, device=device), None
        else:  # the last row of a full cache, as the cell's decode step reads
            length = scalar(())
            positions = length.reshape(1)
        y, _ = transformer.apply_cycle(cfg, cyc_params, x, ctx=ctx, positions=positions,
                                       length=length, caches=caches, enc_out=enc_out)
        return constrain_batch(y, ctx)  # made whole, as the next cycle pins its input

    with FakeTensorMode(allow_non_fake_inputs=True), torch.no_grad():
        cyc = [_placed_params(transformer.block_spec(cfg, k), cfg, mesh, device, fsdp=False)
               for k in cfg.pattern]
        args = (cyc, _placed_act((b, t, d), dt, mesh, device),
                _cycle_caches(cfg, mesh, device, b, shape.seq_len))
        if cfg.family == "encdec" and kind == "prefill":
            args += (_placed_act((b, cfg.encoder_seq, d), dt, mesh, device),)
        units.append(run_unit(f"cycle_{mode}", n_cycles, cycle_fwd, args, mesh, ctx))

        if cfg.family == "encdec" and kind == "prefill":
            from ..models.encdec import encoder_cfg

            ecfg = encoder_cfg(cfg)
            ectx = dataclasses.replace(ctx, mode="train")
            epos = torch.arange(cfg.encoder_seq, device=device)
            ecyc = [_placed_params(transformer.block_spec(ecfg, k), ecfg, mesh, device,
                                   fsdp=False) for k in ecfg.pattern]
            enc_fwd = lambda cp, x: constrain_batch(
                transformer.apply_cycle(ecfg, cp, x, ctx=ectx, positions=epos)[0], ctx)
            units.append(run_unit("enc_cycle_fwd", ecfg.num_layers, enc_fwd,
                                  (ecyc, _placed_act((b, cfg.encoder_seq, d), dt, mesh, device)),
                                  mesh, ctx))

        def eh_fwd(hp, tokens, x):
            e = transformer._embed(cfg, hp, tokens, None, ctx)
            h = rmsnorm(hp["final_norm"], x + e[:, -1:], cfg.norm_eps)
            return ss.greedy(transformer._head(cfg, hp, h, ctx)[:, 0])

        hp = _placed_params(_head_spec(cfg), cfg, mesh, device, fsdp=False)
        units.append(run_unit(f"embed_head_{mode}", 1, eh_fwd,
                              (hp, _placed_act((b, t), torch.int32, mesh, device),
                               _placed_act((b, 1, d), dt, mesh, device)), mesh, ctx))
    return units


# ---------------------------------------------------------------------------
# roofline assembly
# ---------------------------------------------------------------------------


def group_bandwidth(ranks) -> float:
    """A collective's bandwidth over the group of ``ranks`` (a GPU's node is
    its rank // GPUS_PER_NODE): NVLink within one node; across nodes each
    node's NICs carry its share, NIC_BW a rank, capped by NVLink."""
    per_node = collections.Counter(int(r) // GPUS_PER_NODE for r in ranks)
    if len(per_node) == 1:
        return NVLINK_BW
    return min(NVLINK_BW, NIC_BW * min(per_node.values()))


def axis_bandwidths(mesh) -> Dict[str, float]:
    """Each mesh dim's bandwidth: that of rank 0's group along it (rank 0 is
    the counted rank).  A collective under no mesh dim (OTHER) takes NIC_BW."""
    ranks = mesh.mesh
    out = {}
    for i, name in enumerate(mesh.mesh_dim_names):
        index = [0] * ranks.ndim
        index[i] = slice(None)
        out[name] = group_bandwidth(ranks[tuple(index)].tolist())
    return out


def model_flops(cfg, shape) -> float:
    n_act = model_zoo.param_count(cfg, active_only=True)
    if shape.kind == "train":
        tokens = shape.global_batch * shape.seq_len
        return 6.0 * n_act * tokens
    if shape.kind == "prefill":
        tokens = shape.global_batch * shape.seq_len
        return 2.0 * n_act * tokens
    return 2.0 * n_act * shape.global_batch  # decode: one token per sequence


def assemble(units: List[UnitResult], chips: int, shape, cfg,
             bandwidths: Dict[str, float]) -> Dict[str, Any]:
    """The reference's roofline of the units, per device, under the H100
    model: compute over PEAK_FLOPS, memory over HBM_BW, and the collective
    bytes of each mesh axis over that axis's bandwidth (``bandwidths``;
    OTHER and any axis not named there at NIC_BW), summed."""
    tot_flops = sum(u.scaled()["flops"] for u in units)
    tot_bytes = sum(u.scaled()["bytes"] for u in units)
    tot_coll: Dict[str, float] = {k: 0.0 for k in COLL_KINDS}
    tot_axis: Dict[str, float] = {}
    for u in units:
        sc = u.scaled()
        for k, v in sc["coll"].items():
            tot_coll[k] += v
        for k, v in sc["coll_by_axis"].items():
            tot_axis[k] = tot_axis.get(k, 0.0) + v
    coll_bytes = sum(tot_coll.values())

    compute_s = tot_flops / PEAK_FLOPS  # per-device quantities
    memory_s = tot_bytes / HBM_BW
    coll_s = sum(v / bandwidths.get(k, NIC_BW) for k, v in tot_axis.items())
    terms = {"compute_s": compute_s, "memory_s": memory_s, "collective_s": coll_s}
    dominant = max(terms, key=terms.get)
    mf = model_flops(cfg, shape)
    hlo_flops_global = tot_flops * chips
    return {
        "per_device": {
            "flops": tot_flops,
            "bytes": tot_bytes,
            "collective_bytes": coll_bytes,
            "collective_breakdown": tot_coll,
            "collective_by_axis": tot_axis,
        },
        "terms_seconds": terms,
        "dominant": dominant,
        "model_flops_global": mf,
        "hlo_flops_global": hlo_flops_global,
        "model_over_hlo": mf / hlo_flops_global if hlo_flops_global else 0.0,
        "roofline_bound_s": max(terms.values()),
        "units": [
            {"name": u.name, "trips": u.trips, "flops": u.flops,
             "bytes": u.bytes, "coll": u.coll, "coll_by_axis": u.coll_by_axis}
            for u in units
        ],
    }


# ---------------------------------------------------------------------------
# cells and the command line
# ---------------------------------------------------------------------------


def run_cell(arch: str, shape_name: str, mesh_kind: str, out_dir: pathlib.Path, *,
             with_units: bool = True, force: bool = False) -> Dict[str, Any]:
    """One cell, written to ``out_dir/<arch>__<shape>__<mesh>.json`` (read back
    unless ``force``).  ``with_units`` adds the unit roofline (``roofline``)
    on the single mesh, as the reference's."""
    cfg = get_arch(arch)
    if OPTS.get("capacity_factor"):
        cfg = dataclasses.replace(cfg, capacity_factor=OPTS["capacity_factor"])
    shape = get_shape(shape_name)
    tag = f"{arch}__{shape_name}__{mesh_kind}"
    out_path = pathlib.Path(out_dir) / f"{tag}.json"
    if out_path.exists() and not force:
        return json.loads(out_path.read_text())
    if not applicable(cfg, shape):
        res = {"cell": tag, "skipped": "long_500k requires sub-quadratic decode"}
        out_path.write_text(json.dumps(res, indent=1))
        return res
    fake_world()
    mesh = make_production_mesh(multi_pod=(mesh_kind == "multi"), device_type=OPTS["device"])
    run = RunConfig(model=cfg, shape=shape, optimizer_dtype=optimizer_dtype(cfg),
                    remat=OPTS.get("remat", "full"),
                    grad_dtype=OPTS.get("grad_dtype") or "float32")
    t0 = time.time()
    res: Dict[str, Any] = {"cell": tag, "chips": mesh.size(),
                           "mesh": dict(zip(mesh.mesh_dim_names, mesh.shape)),
                           "device": OPTS["device"]}
    res["full"] = full = full_compile(cfg, run, shape, mesh)
    if with_units and mesh_kind == "single":
        if shape.kind == "train":
            units = train_units(cfg, run, shape, mesh, full.get("num_microbatches", 1))
        else:
            units = serve_units(cfg, shape, mesh, shape.kind)
        res["roofline"] = assemble(units, res["chips"], shape, cfg, axis_bandwidths(mesh))
    res["wall_seconds"] = round(time.time() - t0, 1)
    out_path.write_text(json.dumps(res, indent=1))
    return res


def main(argv: Optional[List[str]] = None) -> None:
    ap = argparse.ArgumentParser(description="multi-pod dry run (per-device counts)")
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--mesh", choices=["single", "multi", "both"], default="both")
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--no-units", action="store_true", help="skip the unit roofline")
    ap.add_argument("--force", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun_torch")
    ap.add_argument("--seq-shard-attention", action="store_true",
                    help="context-parallel attention chunks (perf A/B)")
    ap.add_argument("--q-chunk", type=int, default=2048)
    ap.add_argument("--remat", default="full", choices=["full", "none", "dots", "outs"])
    ap.add_argument("--no-fsdp", action="store_true",
                    help="replicate params over data axes (ZeRO-1; small models)")
    ap.add_argument("--seq-parallel", action="store_true",
                    help="Megatron sequence parallelism on the residual stream")
    ap.add_argument("--fuse-projections", action="store_true",
                    help="fused qkv + gate/up projections (1 dx all-reduce)")
    ap.add_argument("--capacity-factor", type=float, default=None,
                    help="override MoE capacity factor")
    ap.add_argument("--grad-dtype", default=None, choices=["float32", "bfloat16"])
    ap.add_argument("--device", choices=["cuda", "cpu"], default="cuda",
                    help="the mesh's device type (the fake tensors' device)")
    args = ap.parse_args(argv)

    OPTS.update(seq_shard_attention=args.seq_shard_attention, q_chunk=args.q_chunk,
                remat=args.remat, fsdp=not args.no_fsdp, seq_parallel=args.seq_parallel,
                fuse_projections=args.fuse_projections, capacity_factor=args.capacity_factor,
                grad_dtype=args.grad_dtype, device=args.device)
    out_dir = pathlib.Path(args.out)
    out_dir.mkdir(parents=True, exist_ok=True)

    archs = list(ARCHS) if (args.all or args.arch is None) else [args.arch]
    shapes = list(SHAPES) if (args.all or args.shape is None) else [args.shape]
    meshes = ["single", "multi"] if args.mesh == "both" else [args.mesh]

    failures = []
    for a in archs:
        for s in shapes:
            for m in meshes:
                tag = f"{a}__{s}__{m}"
                try:
                    res = run_cell(a, s, m, out_dir, with_units=not args.no_units,
                                   force=args.force)
                    if "skipped" in res:
                        print(f"[skip] {tag}: {res['skipped']}", flush=True)
                        continue
                    full = res["full"]
                    dom = res.get("roofline", {}).get("dominant", "-")
                    bound = res.get("roofline", {}).get("roofline_bound_s", 0.0)
                    print(f"[ok]   {tag}: peak/dev={full['memory']['peak_bytes_est'] / 2**30:.2f}GiB "
                          f"dominant={dom} bound={bound * 1e3:.2f}ms "
                          f"flops/dev={full['full_cost']['flops']:.4e} "
                          f"bytes/dev={full['full_cost']['bytes']:.4e} "
                          f"coll/dev={sum(full['full_coll'].values()):.4e} "
                          f"kernels={full['kernel_calls']} wall={res.get('wall_seconds', 0)}s",
                          flush=True)
                except Exception as e:  # noqa: BLE001 — report every cell, fail at the end
                    failures.append(tag)
                    print(f"[FAIL] {tag}: {type(e).__name__}: {e}", flush=True)
                    traceback.print_exc()
    if failures:
        raise SystemExit(f"{len(failures)} cells failed: {failures}")
    print("dry-run complete: all cells ran.")


if __name__ == "__main__":
    main()
