"""K2: flash-decode GQA attention, one query token per sequence over a KV cache.

Port of ``repro.kernels.decode_attention.decode_attention_pallas``.  For each
sequence b and query head h of kv head h // G:

    out[b, h] = softmax_j<length[b](q[b, h] . k[b, j, kv] * D^-1/2) @ v[b, :length[b], kv]

with the scores and the softmax in float32 and the output in q's dtype.
``decode_attention`` dispatches on the device of its tensors: a CUDA tensor
goes to the hand-written kernel (``csrc/decode_attention.cu``), which raises
if it cannot be built or launched; a CPU tensor goes to the plain PyTorch
version ``decode_attention_plain``, which the tests and the on-card
comparison also use.

``return_lse=True`` also returns each (b, h)'s log-sum-exp of its scaled
scores (float32 (B, H), -inf for an empty row set): a decode whose cache is
split by rows across ranks merges the ranks' outputs by it
(``models.layers._decode_on_mesh``).  A DTensor is refused: the caller runs
the kernel on local tensors under ``local_map``.

Each call is one operation of the dispatcher, the custom ops
``repro_torch::decode_attention`` and ``repro_torch::decode_attention_lse``
(``torch.library``): a CPU implementation (the plain version), a CUDA one
(the kernel, or an error) and a shape rule for fake and meta tensors, so a
dispatch mode sees K2 as one operation and never the plain version's
scores (``launch.dryrun`` counts it by ``work``).
"""
from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch
from torch import Tensor

from ..device import refuse_dtensor
from .build import CudaKernel

_KERNEL = CudaKernel(
    "decode_attention",
    "decode_attention.cu",
    [ctypes.c_void_p] * 9 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
)
CHUNK = 64  # cache rows per block of the kernel's first pass (kChunk)
# The (G, D) = (query heads per kv head, head dimension) pairs the kernel is
# compiled for: recurrentgemma-2b, tinyllama-1.1b, smollm-135m and
# granite-moe-3b-a800m, arctic-480b, whisper-medium (self and cross),
# internvl2-1b, yi-9b and command-r-35b, the reduced configurations of these,
# and the parity shapes of tests/test_kernels.py.
INSTANTIATED = frozenset({(10, 256), (8, 64), (3, 64), (7, 128), (1, 64), (7, 64), (8, 128),
                          (4, 16), (4, 64), (1, 32), (3, 16), (4, 32)})
_DTYPES = (torch.float32, torch.bfloat16)


def decode_attention_plain(q: Tensor, k: Tensor, v: Tensor, length: Optional[Tensor] = None, *,
                           return_lse: bool = False):
    """Plain PyTorch version of K2, as ``repro.kernels.ref.decode_attention_ref``.

    q (B, H, D); k, v (B, S, KVH, D); length (B,) valid rows of each cache,
    or None for all S.  Returns (B, H, D) in q's dtype, and with
    ``return_lse`` the (B, H) float32 log-sum-exps of the scaled scores too.
    """
    b, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    qg = q.reshape(b, kvh, h // kvh, d).float()
    logits = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) * d**-0.5
    if length is None:
        w = torch.softmax(logits, dim=-1)
    else:
        invalid = (torch.arange(s, device=q.device)[None, :] >= length[:, None])[:, None, None, :]
        logits = logits.masked_fill(invalid, float("-inf"))
        w = torch.softmax(logits, dim=-1)
        # An empty row set gives zeros, as the kernels' acc / max(l, 1e-30):
        # its softmax over all -inf is NaN, and every one of its rows is masked.
        w = w.masked_fill(invalid, 0.0)
    out = torch.einsum("bkgs,bskd->bkgd", w, v.float()).reshape(b, h, d).to(q.dtype)
    if not return_lse:
        return out
    return out, torch.logsumexp(logits, dim=-1).reshape(b, h)


def decode_attention_cuda(q: Tensor, k: Tensor, v: Tensor, length: Tensor, *,
                          return_lse: bool = False):
    """Launch K2 on the current stream: q (B, H, D) and k, v (B, S, KVH, D),
    each float32 or bfloat16 (k and v alike), length (B,) on one CUDA device,
    with (H / KVH, D) in ``INSTANTIATED``.  Returns (B, H, D) in q's dtype,
    and with ``return_lse`` the (B, H) float32 log-sum-exps, which the
    combine launch writes."""
    refuse_dtensor("decode_attention_cuda", q, k, v, length)
    b, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    if k.shape != (b, s, kvh, d) or v.shape != k.shape or length.shape != (b,) or h % kvh:
        raise ValueError(
            f"shapes: q {tuple(q.shape)}, k {tuple(k.shape)}, v {tuple(v.shape)}, "
            f"length {tuple(length.shape)}"
        )
    if (h // kvh, d) not in INSTANTIATED:
        raise ValueError(f"decode_attention_cuda: no instantiation for (G, D) = ({h // kvh}, {d}); "
                         f"compiled for {sorted(INSTANTIATED)}")
    if not all(x.is_cuda and x.device == q.device for x in (q, k, v, length)):
        raise ValueError("decode_attention_cuda takes tensors on one CUDA device")
    if q.dtype not in _DTYPES or k.dtype not in _DTYPES or v.dtype != k.dtype:
        raise ValueError(f"dtypes q {q.dtype}, k {k.dtype}, v {v.dtype}: float32 or bfloat16, k as v")
    q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
    if k.data_ptr() % 16 or v.data_ptr() % 16:  # the kernel copies rows in 16-byte units
        raise ValueError("decode_attention_cuda: k and v must start 16-byte aligned")
    length = length.to(torch.int32).contiguous()
    n_chunks = -(-s // CHUNK)
    g = h // kvh
    part_m = torch.empty((b, kvh, n_chunks, g), dtype=torch.float32, device=q.device)
    part_l = torch.empty_like(part_m)
    part_acc = torch.empty((b, kvh, n_chunks, g, d), dtype=torch.float32, device=q.device)
    out = torch.empty_like(q)
    lse = torch.empty((b, h), dtype=torch.float32, device=q.device) if return_lse else None
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        _KERNEL.launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), length.data_ptr(), part_m.data_ptr(),
            part_l.data_ptr(), part_acc.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), b, h, kvh, d, s,
            int(q.dtype == torch.bfloat16), int(k.dtype == torch.bfloat16), stream,
        )
    return out if lse is None else (out, lse)


@torch.library.custom_op("repro_torch::decode_attention", mutates_args=(), device_types="cpu")
def _decode_attention_op(q: Tensor, k: Tensor, v: Tensor, length: Tensor) -> Tensor:
    return decode_attention_plain(q, k, v, length)


@_decode_attention_op.register_kernel("cuda")
def _(q, k, v, length):
    return decode_attention_cuda(q, k, v, length)


@_decode_attention_op.register_fake
def _(q, k, v, length):
    return torch.empty_like(q)


@torch.library.custom_op("repro_torch::decode_attention_lse", mutates_args=(),
                         device_types="cpu")
def _decode_attention_lse_op(q: Tensor, k: Tensor, v: Tensor,
                             length: Tensor) -> Tuple[Tensor, Tensor]:
    return decode_attention_plain(q, k, v, length, return_lse=True)


@_decode_attention_lse_op.register_kernel("cuda")
def _(q, k, v, length):
    return decode_attention_cuda(q, k, v, length, return_lse=True)


@_decode_attention_lse_op.register_fake
def _(q, k, v, length):
    return torch.empty_like(q), q.new_empty(q.shape[:2], dtype=torch.float32)


def work(q: Tensor, k: Tensor, v: Tensor, length: Tensor, return_lse: bool = False):
    """(operations, bytes) of one K2 call, the bound's count: a multiply-add
    (2 operations) for q.k and for p.v at every head and cache row; q, every
    K and V row (a length is not read on the host) and the lengths read, the
    output (and the log-sum-exps) written."""
    b, h, d = q.shape
    nbytes = 2 * q.numel() * q.element_size() + k.numel() * k.element_size() \
        + v.numel() * v.element_size() + length.numel() * length.element_size()
    return 4.0 * b * h * k.shape[1] * d, float(nbytes + (4 * b * h if return_lse else 0))


def decode_attention(q: Tensor, k: Tensor, v: Tensor, length: Tensor, *,
                     return_lse: bool = False):
    """Flash-decode GQA attention (B, H, D) x (B, S, KVH, D) -> (B, H, D)
    (and the (B, H) log-sum-exps with ``return_lse``).

    Same signature as ``decode_attention_pallas``.  CUDA tensors run the
    kernel; CPU tensors run ``decode_attention_plain``; fake and meta
    tensors take the shape rule; a DTensor is refused.  One custom op a call.
    """
    refuse_dtensor("decode_attention", q, k, v, length)
    if q.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"decode_attention: no kernel for device {q.device}")
    op = _decode_attention_lse_op if return_lse else _decode_attention_op
    return op(q, k, v, length)
