"""Gradient compression with error feedback.

Counterpart of ``repro.distributed.compression``.  Two schemes, both with
error-feedback (EF) memory so the compression error is re-injected next
step (required for convergence — Karimireddy et al. 2019):

  * int8_ef — per-tensor symmetric int8 quantization: 4x less data-parallel
    all-reduce traffic (gradients cross the reduce boundary quantized; the
    EF residual stays local).
  * topk_ef — magnitude top-k sparsification (k = ratio of the entries).

Trees are the port's parameter trees (nested dicts with sorted keys, lists,
tensor leaves), walked in the reference's leaf order.  Each leaf is
compressed on its own device and its float32 temporaries are freed before
the next leaf, so a call needs the trees plus about four float32 copies of
the largest leaf.

On a mesh the gradients are ``DTensor``s reduced to their parameters'
placements, replicated on every mesh dim, and the error feedback is made
with the same placements.  Each leaf is then compressed on its local
tensor, which is the whole leaf, so int8's scale and top-k's threshold see
every entry as the reference's unplaced gradients do; the results are
wrapped with the leaf's placements again.  A leaf that is not replicated
is refused: compressed shard by shard it would take each shard's own scale
or threshold.
"""
from __future__ import annotations

from typing import Any, Callable, Tuple

import torch
from torch import Tensor

from repro_torch.device import is_dtensor, local
from repro_torch.models.params import leaves, tree_map


def init_error_feedback(params: Any) -> Any:
    """Float32 zeros like each parameter, with its placements on a mesh."""
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)


def _quant_dequant_int8(g: Tensor) -> Tensor:
    # The reference's order of operations, division included: a reciprocal
    # multiply would change the rounding of g / scale.
    scale = torch.max(torch.abs(g)) / 127.0 + 1e-12
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q.to(torch.float32) * scale


def _topk_mask(g: Tensor, ratio: float) -> Tensor:
    flat = torch.abs(g.reshape(-1))
    k = max(int(flat.shape[0] * ratio), 1)
    # The k-th largest |g|, a value of the leaf itself (lax.top_k(flat, k)[0][-1]);
    # ties with it are kept, so more than k entries may pass.
    thresh = torch.min(torch.topk(flat, k, sorted=False).values)
    return (torch.abs(g) >= thresh).to(g.dtype)


def make_compressor(
    kind: str, error_feedback: Any, *, ratio: float = 0.01
) -> Tuple[Callable, Callable]:
    """Returns (compress_fn(grads, ef) -> (grads, ef), init_ef)."""

    def compress_leaf(g: Tensor, e: Tensor) -> Tuple[Tensor, Tensor]:
        g32 = g.to(torch.float32) + e
        if kind == "int8_ef":
            sent = _quant_dequant_int8(g32)
        elif kind == "topk_ef":
            sent = g32 * _topk_mask(g32, ratio)
        else:
            raise ValueError(kind)
        return sent, g32 - sent

    def compress(grads: Any, ef: Any) -> Tuple[Any, Any]:
        flat_e = iter(leaves(ef))

        def one(g):
            e = next(flat_e)
            if not (is_dtensor(g) or is_dtensor(e)):
                return compress_leaf(g, e)
            return _on_whole_leaf(compress_leaf, g, e)

        out = tree_map(one, grads)  # (sent, new_ef) pairs at the leaves
        return tree_map(lambda o: o[0], out), tree_map(lambda o: o[1], out)

    return compress, init_error_feedback


def _on_whole_leaf(fn: Callable, g: Tensor, e: Tensor) -> Tuple[Tensor, Tensor]:
    """``fn`` on the local tensors of a replicated gradient ``g`` and its
    error feedback ``e`` (DTensors of the same placements), its two results
    wrapped with those placements."""
    from torch.distributed.tensor import DTensor

    if not (is_dtensor(g) and is_dtensor(e)) or tuple(e.placements) != tuple(g.placements) \
            or e.device_mesh != g.device_mesh:
        raise TypeError("a gradient and its error feedback must both be DTensors of one mesh "
                        "and placements (init_error_feedback on the placed parameters)")
    if not all(p.is_replicate() for p in g.placements):
        raise ValueError(f"gradient compression takes a leaf replicated on every mesh dim, not "
                         f"{tuple(g.placements)}: a shard's own scale or threshold would differ "
                         f"from the whole leaf's")
    wrap = lambda x: DTensor.from_local(x, g.device_mesh, g.placements, run_check=False)
    sent, new_e = fn(local(g), local(e))
    return wrap(sent), wrap(new_e)
