"""K3: the linear-recurrence scan h_t = a_t h_{t-1} + b_t (the RG-LRU core).

Port of ``repro.kernels.lru_scan.lru_scan_pallas``: a, b (B, T, R) and an
initial state h0 (B, R) give h (B, T, R) in a's dtype, with the state in
float32.  ``lru_scan`` dispatches on the device of its tensors: a CUDA tensor
goes to the hand-written kernel (``csrc/lru_scan.cu``), which raises if it
cannot be built or launched; a CPU tensor goes to the plain PyTorch version
``lru_scan_plain``, which the tests and the on-card comparison also use.
"""
from __future__ import annotations

import ctypes

import torch
from torch import Tensor

from .build import CudaKernel

_KERNEL = CudaKernel(
    "lru_scan",
    "lru_scan.cu",
    [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p],
)


def lru_scan_plain(a: Tensor, b: Tensor, h0: Tensor) -> Tensor:
    """Plain PyTorch version of K3, as ``repro.kernels.ref.lru_scan_ref``: h0
    folded into the first step, then an associative (log-depth) scan along T
    in float32 with the combine (a1, b1) . (a2, b2) = (a1 a2, a2 b1 + b2)."""
    a32, x = a.float(), b.float()
    x = torch.cat([x[:, :1] + a32[:, :1] * h0.float()[:, None], x[:, 1:]], dim=1)
    t = a.shape[1]
    step = 1
    while step < t:  # Hillis-Steele: after this pass each h_t spans 2 * step steps
        x = torch.cat([x[:, :step], a32[:, step:] * x[:, :-step] + x[:, step:]], dim=1)
        a32 = torch.cat([a32[:, :step], a32[:, step:] * a32[:, :-step]], dim=1)
        step *= 2
    return x.to(a.dtype)


def lru_scan_cuda(a: Tensor, b: Tensor, h0: Tensor) -> Tensor:
    """Launch K3 on the current stream: a, b (B, T, R) both float32 or both
    bfloat16, h0 (B, R), on one CUDA device.  Returns (B, T, R) in a's dtype."""
    bsz, t, r = a.shape
    if not all(x.is_cuda and x.device == a.device for x in (b, h0)):
        raise ValueError("lru_scan_cuda takes tensors on one CUDA device")
    if a.dtype not in (torch.float32, torch.bfloat16) or b.dtype != a.dtype:
        raise ValueError(f"dtypes a {a.dtype}, b {b.dtype}: both float32 or both bfloat16")
    if b.shape != a.shape or h0.shape != (bsz, r):
        raise ValueError(f"shapes: a {tuple(a.shape)}, b {tuple(b.shape)}, h0 {tuple(h0.shape)}")
    a, b = a.contiguous(), b.contiguous()
    h0 = h0.to(torch.float32).contiguous()
    out = torch.empty_like(a)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        _KERNEL.launch(
            a.data_ptr(), b.data_ptr(), h0.data_ptr(), out.data_ptr(), bsz, t, r,
            int(a.dtype == torch.bfloat16), stream,
        )
    return out


def lru_scan(a: Tensor, b: Tensor, h0: Tensor) -> Tensor:
    """h_t = a_t h_{t-1} + b_t along T, h0 folded in.  Same signature as
    ``lru_scan_pallas``.  CUDA tensors run the kernel; CPU tensors run
    ``lru_scan_plain``."""
    if a.device.type == "cpu":
        return lru_scan_plain(a, b, h0)
    if not a.is_cuda:
        raise ValueError(f"lru_scan: no kernel for device {a.device}")
    return lru_scan_cuda(a, b, h0)
