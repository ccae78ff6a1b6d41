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
"""
from __future__ import annotations

from typing import Any, Callable, Tuple

import torch
from torch import Tensor

from repro_torch.models.params import leaves, tree_map


def init_error_feedback(params: Any) -> Any:
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device), params)


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

    def compress(grads: Any, ef: Any) -> Tuple[Any, Any]:
        flat_e = iter(leaves(ef))

        def one(g):
            g32 = g.to(torch.float32) + next(flat_e)
            if kind == "int8_ef":
                sent = _quant_dequant_int8(g32)
            elif kind == "topk_ef":
                sent = g32 * _topk_mask(g32, ratio)
            else:
                raise ValueError(kind)
            return sent, g32 - sent

        out = tree_map(one, grads)  # (sent, new_ef) pairs at the leaves
        return tree_map(lambda o: o[0], out), tree_map(lambda o: o[1], out)

    return compress, init_error_feedback
