"""Logical-axis sharding rules for MODEL tensors, with divisibility fallback.

The port's counterpart of ``repro.distributed.sharding``.  (The estimator's
fleet-axis sharding is a separate, much simpler concern: a 1-D ``workers``
mesh over an embarrassingly parallel axis, in ``repro_torch.core.sharding``.)

Every parameter and cache tensor carries logical axis names
(``models.params.axes_tree``, ``models.transformer.cache_axes_tree``).
``spec_for`` maps them to mesh axes greedily: each logical axis tries its
candidate mesh axes in order; a candidate is taken only if (a) it is not
already used by another dim of the same tensor and (b) the dim size is
divisible by the mesh-axis size.  Anything that fails degrades to
replication, so that e.g. smollm's 9 heads or granite's 40 experts still
place on a 16-way model axis.

Default ruleset (TP on 'model', FSDP/ZeRO on 'data' (+ 'pod')):
  vocab/mlp/heads/kv_heads/rnn/cell -> model   (tensor parallel)
  experts -> the data axes                     (expert parallel)
  embed  -> fsdp axes  (ZeRO-3: parameters sharded over the data parallels)
  batch  -> (pod, data)

The rules are pure Python over anything with ``axis_names`` and a ``shape``
mapping (the reference's ``Mesh``, a test's stand-in) or over a torch
``DeviceMesh`` (its ``mesh_dim_names`` and ``shape``).  Where the reference
hands out ``NamedSharding``s, the port hands out ``PartitionSpec``s: the
specs of ``tree_shardings`` and ``cache_shardings`` become DTensor
placements by ``placements`` and are applied by ``shard_tree``.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional, Sequence, Tuple

from ..device import is_dtensor

AxisCandidates = Tuple[str, ...]
Rules = Dict[str, Tuple[AxisCandidates, ...]]


class PartitionSpec(tuple):
    """One entry per tensor dim: None (replicated), a mesh axis name, or a
    tuple of mesh axis names (the dim split over their product, the first
    axis major), as ``jax.sharding.PartitionSpec``."""

    def __new__(cls, *parts):
        return super().__new__(cls, parts)

    def __repr__(self) -> str:
        return f"PartitionSpec{tuple.__repr__(self)}"


PS = PartitionSpec


def axis_names(mesh) -> Tuple[str, ...]:
    """The mesh's axis names: a ``DeviceMesh``'s dim names, else ``axis_names``."""
    if hasattr(mesh, "mesh_dim_names"):
        return tuple(mesh.mesh_dim_names or ())
    return tuple(mesh.axis_names)


def axis_size(mesh, name: str) -> int:
    if hasattr(mesh, "mesh_dim_names"):
        return int(mesh.shape[axis_names(mesh).index(name)])
    return int(mesh.shape[name])


def default_rules(mesh, *, fsdp: bool = True) -> Rules:
    pod = "pod" in axis_names(mesh)
    data_axes: Tuple[AxisCandidates, ...] = (("pod", "data"), ("data",)) if pod else (("data",),)
    return {
        "vocab": (("model",),),
        "mlp": (("model",),),
        "heads": (("model",),),
        "kv_heads": (("model",),),
        # experts shard over the DATA axes (EP): the model axis is reserved for
        # the per-expert d_ff TP split (models.moe)
        "experts": data_axes,
        "rnn": (("model",),),
        "cell": (("model",),),
        # head_dim is not sharded for parameters (contracting it makes
        # attention logits partial sums); cache_rules keeps it as the last
        # resort for decode-cache storage
        "embed": data_axes if fsdp else (),
        "batch": data_axes,
        "seq": (),
        "layers": (),
    }


def cache_rules(mesh) -> Rules:
    """Decode-cache rules: prefer kv_heads -> model; else shard the cache's seq
    dim over model (flash-decode: per-shard partial softmax and a small
    log-sum-exp combine, ``models.layers``); recurrent-state feature dims
    (head_dim / rnn) as the last resort."""
    r = dict(default_rules(mesh))
    r["seq"] = (("model",),)
    r["head_dim"] = (("model",),)
    return r


# Lower number = assigned first (per-tensor greedy order).
_PRIORITY = {
    "vocab": 0, "mlp": 0, "heads": 0, "kv_heads": 0, "experts": 0,
    "rnn": 0, "cell": 0, "batch": 0,
    "embed": 1,
    "seq": 2,
    "head_dim": 3,
}


def axes_size(mesh, axes: AxisCandidates) -> int:
    """The number of shards over the product of ``axes``."""
    n = 1
    for a in axes:
        n *= axis_size(mesh, a)
    return n


def spec_for(shape: Sequence[int], logical: Sequence[Optional[str]], mesh,
             rules: Rules) -> PartitionSpec:
    """Greedy logical -> mesh assignment with divisibility fallback.

    Dims are visited in ``_PRIORITY`` order (not positional order) so that
    e.g. a divisible kv_heads dim claims the model axis before the seq
    fallback.
    """
    names = axis_names(mesh)
    used: set = set()
    out: list = [None] * len(tuple(shape))
    order = sorted(range(len(out)), key=lambda i: _PRIORITY.get(logical[i] or "", 1))
    for i in order:
        dim, name = shape[i], logical[i]
        for cand in rules.get(name or "", ()):
            cand_t = (cand,) if isinstance(cand, str) else tuple(cand)
            if any(a in used for a in cand_t):
                continue
            if any(a not in names for a in cand_t):
                continue
            if dim % axes_size(mesh, cand_t) != 0:
                continue
            out[i] = cand_t if len(cand_t) > 1 else cand_t[0]
            used.update(cand_t)
            break
    return PartitionSpec(*out)


def placements(spec: Sequence, mesh) -> tuple:
    """The DTensor placements of ``spec`` on a ``DeviceMesh``: ``Shard(d)`` on
    each mesh dim of more than one shard that tensor dim d is split over,
    ``Replicate()`` on the others.  A split into one shard is the same
    layout as replication, and DTensor's propagation refuses some reshapes
    of a size-1 dim that it shards (a single KV head on a model axis of 1)."""
    from torch.distributed.tensor import Replicate, Shard

    names = axis_names(mesh)
    out: List[Any] = [Replicate()] * len(names)
    for d, entry in enumerate(spec):
        for a in () if entry is None else (entry,) if isinstance(entry, str) else entry:
            if axis_size(mesh, a) > 1:
                out[names.index(a)] = Shard(d)
    return tuple(out)


def _map2(fn, tree, other):
    """``fn(leaf, other_leaf)`` over two parallel trees of dicts and lists;
    ``other``'s leaves are tuples (axes, specs)."""
    if isinstance(tree, dict):
        return {k: _map2(fn, tree[k], other[k]) for k in tree}
    if isinstance(tree, list):
        return [_map2(fn, x, y) for x, y in zip(tree, other)]
    return fn(tree, other)


def tree_shardings(abstract_tree: Any, axes_tree_: Any, mesh,
                   rules: Optional[Rules] = None):
    """A ``PartitionSpec`` per leaf of a parallel (tensors, logical axes) tree;
    the tensors may be on the ``meta`` device (``models.params.abstract_params``)."""
    rules = rules or default_rules(mesh)
    return _map2(lambda t, axes: spec_for(t.shape, axes, mesh, rules), abstract_tree, axes_tree_)


def cache_shardings(cache_abstract: Any, cache_axes: Any, mesh, rules: Optional[Rules] = None):
    """Specs for a decode cache from its exact logical-axes tree
    (``models.transformer.cache_axes_tree``): batch over the data axes,
    kv heads (else seq, else feature dims) over model."""
    return tree_shardings(cache_abstract, cache_axes, mesh, rules or cache_rules(mesh))


def replicated_specs(tree: Any):
    """An all-replicated spec for every leaf of ``tree``."""
    return _map2(lambda t, _: PartitionSpec(*([None] * t.ndim)), tree, tree)


def shard_tree(tree: Any, specs: Any, mesh):
    """Each tensor leaf of ``tree`` as a ``DTensor`` on ``mesh`` placed by its
    spec.  Every rank holds the whole leaf, made from the same seed, and
    keeps its own shard of it: no communication, so a seed gives the same
    values sharded or not."""
    from torch.distributed.tensor import distribute_tensor

    return _map2(lambda t, spec: distribute_tensor(t, mesh, placements(spec, mesh),
                                                   src_data_rank=None), tree, specs)


def gather_tree(tree: Any):
    """Every ``DTensor`` leaf of ``tree`` made whole on every rank (a
    collective); plain tensors as they are."""
    from torch.distributed.tensor import DTensor

    return _map2(lambda t, _: t.full_tensor() if isinstance(t, DTensor) else t, tree, tree)


# ---------------------------------------------------------------------------
# activation / batch specs
# ---------------------------------------------------------------------------


def batch_spec(mesh) -> PartitionSpec:
    return PartitionSpec(tuple(a for a in ("pod", "data") if a in axis_names(mesh)))


def data_sharding(mesh, ndim: int) -> tuple:
    """The placements that shard dim 0 (batch) over the data axes and
    replicate the rest."""
    return placements(PartitionSpec(batch_spec(mesh)[0], *([None] * (ndim - 1))), mesh)

