"""Parameter specs: a model is a nested dict (and list) of ``P`` leaves.

The port's counterpart of ``repro.models.params``: the same ``P`` leaves and
the same trees, so a spec means the same parameters in both packages and the
reference's parameter trees carry over leaf for leaf (``convert``).  The
abstract and logical-axes trees of the reference serve its dry-run and
sharding, which are not ported.
"""
from __future__ import annotations

import math
from typing import Any, NamedTuple, Optional, Tuple

import torch

SpecTree = Any  # nested dict / list of P
ParamTree = Any  # the same tree with tensors for leaves


class P(NamedTuple):
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]
    init: str = "normal"  # normal | zeros | ones
    scale: float = 0.02

    def stacked(self, n: int, axis_name: str = "layers") -> "P":
        return P((n, *self.shape), (axis_name, *self.axes), self.init, self.scale)


def tree_map(fn, tree):
    """Map ``fn`` over the leaves of a tree of dicts and lists (dict keys in
    sorted order, as JAX flattens them)."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k]) for k in sorted(tree)}
    if isinstance(tree, list):
        return [tree_map(fn, x) for x in tree]
    return fn(tree)


def leaves(tree) -> list:
    out = []
    tree_map(out.append, tree)
    return out


def unflatten(like, values):
    """``like``'s tree with ``values`` for its leaves, in ``leaves`` order."""
    it = iter(values)
    return tree_map(lambda _: next(it), like)


def stack_spec(spec: SpecTree, n: int, axis_name: str = "layers") -> SpecTree:
    """Add a leading stacked axis to every leaf (per-cycle storage)."""
    return tree_map(lambda p: p.stacked(n, axis_name), spec)


# Elements of one float32 draw: a larger leaf (arctic-480b's stacked
# experts, 4.5e9 elements a layer) is drawn in pieces of this size, so the
# draw needs 4 GiB beside the leaf, not four bytes an element.
_DRAW_CHUNK = 2**30


def init_params(spec: SpecTree, generator: torch.Generator, dtype=torch.float32,
                device=None) -> ParamTree:
    """Materialise a spec: normal(0, scale) leaves drawn from ``generator`` in
    float32 on ``device`` (the generator's device), then cast to ``dtype``;
    leaves over ``_DRAW_CHUNK`` elements are drawn piece by piece in order."""
    device = generator.device if device is None else torch.device(device)

    def draw(shape) -> torch.Tensor:
        return torch.randn(shape, generator=generator, device=device, dtype=torch.float32)

    def make(p: P) -> torch.Tensor:
        if p.init == "zeros":
            return torch.zeros(p.shape, dtype=dtype, device=device)
        if p.init == "ones":
            return torch.ones(p.shape, dtype=dtype, device=device)
        n = math.prod(p.shape)
        if n <= _DRAW_CHUNK:
            return draw(p.shape).mul_(p.scale).to(dtype)
        out = torch.empty(n, dtype=dtype, device=device)
        for i in range(0, n, _DRAW_CHUNK):
            piece = out[i:i + _DRAW_CHUNK]
            piece.copy_(draw(piece.shape).mul_(p.scale))
        return out.view(p.shape)

    return tree_map(make, spec)


def param_count(spec: SpecTree) -> int:
    return sum(math.prod(p.shape) for p in leaves(spec))


def abstract_params(spec: SpecTree, dtype=torch.float32) -> ParamTree:
    """Shape-only stand-ins: tensors on the ``meta`` device (no allocation)."""
    return tree_map(lambda p: torch.empty(p.shape, dtype=dtype, device="meta"), spec)


def axes_tree(spec: SpecTree):
    """Tree of logical-axes tuples, parallel to the parameter tree."""
    return tree_map(lambda p: p.axes, spec)


def param_bytes(spec: SpecTree, bytes_per_elem: int = 2) -> int:
    return param_count(spec) * bytes_per_elem
