"""K3: the linear-recurrence scan h_t = a_t h_{t-1} + b_t (the RG-LRU core).

Port of ``repro.kernels.lru_scan.lru_scan_pallas``: a, b (B, T, R) and an
initial state h0 (B, R) give h (B, T, R) in a's dtype, with the state in
float32.  ``lru_scan`` dispatches on the device of its tensors: a CUDA tensor
goes to the hand-written kernel (``csrc/lru_scan.cu``), which raises if it
cannot be built or launched; a CPU tensor goes to the plain PyTorch version
``lru_scan_plain``, which the tests and the on-card comparison also use.

The kernel is a single-pass chunked scan with a chained carry: a block takes
one tile of ``CHUNK`` time steps by ``WIDTH`` channels of one sequence, and
each chunk waits for the state its predecessor publishes.  The tile is fixed
in the kernel's source; ``scan_layout`` does the tiling's arithmetic
(chunks, channel tiles, tiles, the workspace of carries) and the kernel
refuses a workspace or a tile that disagrees.
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch
from torch import Tensor

from .build import CudaKernel

_KERNEL = CudaKernel(
    "lru_scan",
    "lru_scan.cu",
    [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 6 + [ctypes.c_void_p],
)

# The kernel's tile (kChunk, kWidth in csrc/lru_scan.cu), the fastest of
# those timed at the serving path's prefill shape on an H100 (PERF.md, K3).
CHUNK, WIDTH = 128, 32
_COUNTER_BYTES = 16  # the workspace's tile counter, padded


class ScanLayout(NamedTuple):
    """How one call of K3 is tiled, and the workspace that takes."""

    n_chunks: int  # ceil(T / CHUNK)
    n_rtiles: int  # channel tiles of one sequence, ceil(R / WIDTH)
    n_tiles: int  # blocks of the launch: n_chunks * B * n_rtiles
    workspace_bytes: int  # counter, (n_chunks - 1, B, R) 8-byte carries; cleared per launch


def scan_layout(bsz: int, t: int, r: int) -> ScanLayout:
    """K3's tiling of a (bsz, t, r) scan."""
    n_chunks, n_rtiles = -(-t // CHUNK), -(-r // WIDTH)
    workspace_bytes = _COUNTER_BYTES + 8 * max(n_chunks - 1, 0) * bsz * r
    return ScanLayout(n_chunks, n_rtiles, n_chunks * bsz * n_rtiles, workspace_bytes)


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
    bfloat16, h0 (B, R), on one CUDA device.  Returns (B, T, R) in a's
    dtype.  The kernel has no backward yet (ROADMAP item 12d): under autograd
    with an input that requires a gradient it raises, as its output would
    carry none and the gradients of a, b and h0 would silently be lost."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (a, b, h0)):
        raise NotImplementedError(
            "lru_scan_cuda has no backward yet (ROADMAP item 12d, K3's reverse-time scan): "
            "the hybrid family cannot train on the card; run it under torch.no_grad()")
    if not all(x.is_cuda and x.device == a.device for x in (a, b, h0)):
        raise ValueError("lru_scan_cuda takes tensors on one CUDA device")
    if a.dtype not in (torch.float32, torch.bfloat16) or b.dtype != a.dtype:
        raise ValueError(f"dtypes a {a.dtype}, b {b.dtype}: both float32 or both bfloat16")
    if a.dim() != 3 or b.shape != a.shape or h0.shape != (a.shape[0], a.shape[2]):
        raise ValueError(f"shapes: a {tuple(a.shape)}, b {tuple(b.shape)}, h0 {tuple(h0.shape)}")
    bsz, t, r = a.shape
    layout = scan_layout(bsz, t, r)
    a, b = a.contiguous(), b.contiguous()
    h0 = h0.to(torch.float32).contiguous()
    out = torch.empty_like(a)
    workspace = torch.empty(layout.workspace_bytes, dtype=torch.uint8, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        _KERNEL.launch(
            a.data_ptr(), b.data_ptr(), h0.data_ptr(), out.data_ptr(), workspace.data_ptr(),
            layout.workspace_bytes, bsz, t, r, CHUNK, WIDTH, int(a.dtype == torch.bfloat16),
            stream,
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
