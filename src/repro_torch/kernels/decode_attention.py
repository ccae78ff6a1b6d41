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
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch
from torch import Tensor

from .build import CudaKernel

_KERNEL = CudaKernel(
    "decode_attention",
    "decode_attention.cu",
    [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p],
)
CHUNK = 64  # cache rows per block of the kernel's first pass (kChunk)
# The (G, D) = (query heads per kv head, head dimension) pairs the kernel is
# compiled for: recurrentgemma-2b, tinyllama-1.1b, smollm-135m, the reduced
# configurations of these, and the parity shapes of tests/test_kernels.py.
INSTANTIATED = frozenset({(10, 256), (8, 64), (3, 64), (4, 16), (4, 64), (1, 32), (3, 16),
                          (4, 32)})
_DTYPES = (torch.float32, torch.bfloat16)


def decode_attention_plain(q: Tensor, k: Tensor, v: Tensor, length: Optional[Tensor] = None) -> Tensor:
    """Plain PyTorch version of K2, as ``repro.kernels.ref.decode_attention_ref``.

    q (B, H, D); k, v (B, S, KVH, D); length (B,) valid rows of each cache,
    or None for all S.  Returns (B, H, D) in q's dtype.
    """
    b, h, d = q.shape
    s, kvh = k.shape[1], k.shape[2]
    qg = q.reshape(b, kvh, h // kvh, d).float()
    logits = torch.einsum("bkgd,bskd->bkgs", qg, k.float()) * d**-0.5
    if length is None:
        w = torch.softmax(logits, dim=-1)
    else:
        invalid = (torch.arange(s, device=q.device)[None, :] >= length[:, None])[:, None, None, :]
        w = torch.softmax(logits.masked_fill(invalid, float("-inf")), dim=-1)
        # An empty row set gives zeros, as the kernels' acc / max(l, 1e-30):
        # its softmax over all -inf is NaN, and every one of its rows is masked.
        w = w.masked_fill(invalid, 0.0)
    out = torch.einsum("bkgs,bskd->bkgd", w, v.float())
    return out.reshape(b, h, d).to(q.dtype)


def decode_attention_cuda(q: Tensor, k: Tensor, v: Tensor, length: Tensor) -> Tensor:
    """Launch K2 on the current stream: q (B, H, D) and k, v (B, S, KVH, D),
    each float32 or bfloat16 (k and v alike), length (B,) on one CUDA device,
    with (H / KVH, D) in ``INSTANTIATED``.  Returns (B, H, D) in q's dtype."""
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
    stream = torch.cuda.current_stream(q.device).cuda_stream
    with torch.cuda.device(q.device):
        _KERNEL.launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), length.data_ptr(), part_m.data_ptr(),
            part_l.data_ptr(), part_acc.data_ptr(), out.data_ptr(), b, h, kvh, d, s,
            int(q.dtype == torch.bfloat16), int(k.dtype == torch.bfloat16), stream,
        )
    return out


def decode_attention(q: Tensor, k: Tensor, v: Tensor, length: Tensor) -> Tensor:
    """Flash-decode GQA attention (B, H, D) x (B, S, KVH, D) -> (B, H, D).

    Same signature as ``decode_attention_pallas``.  CUDA tensors run the
    kernel; CPU tensors run ``decode_attention_plain``.
    """
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, length)
    if not q.is_cuda:
        raise ValueError(f"decode_attention: no kernel for device {q.device}")
    return decode_attention_cuda(q, k, v, length)
