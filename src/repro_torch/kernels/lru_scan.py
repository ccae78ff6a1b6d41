"""K3: the linear-recurrence scan h_t = a_t h_{t-1} + b_t (the RG-LRU core).

Port of ``repro.kernels.lru_scan.lru_scan_pallas``: a, b (B, T, R) and an
initial state h0 (B, R) give h (B, T, R) in a's dtype, with the state in
float32.  ``lru_scan`` dispatches on the device of its tensors: a CUDA tensor
goes to the hand-written kernel (``csrc/lru_scan.cu``), which raises if it
cannot be built or launched; a CPU tensor goes to the plain PyTorch version
``lru_scan_plain``, which the tests and the on-card comparison also use.

Under autograd ``lru_scan`` goes through ``LruScan``, whose backward is the
reverse-time scan g_t = dy_t + a_{t+1} g_{t+1} (db = g, da = g h_{t-1},
dh0 = a_0 g_0): the kernel's second entry point ``lru_scan_bwd`` on a CUDA
tensor, ``lru_scan_backward_plain`` on a CPU tensor.  The TPU kernel has no
backward; the reference differentiates ``lax.associative_scan`` with
``jax.grad`` where the port runs K3.

The kernel is a single-pass chunked scan with a chained carry: a block takes
one tile of ``CHUNK`` time steps by ``WIDTH`` channels of one sequence, and
each chunk waits for the state its predecessor publishes.  The backward has
a tile of its own, ``BWD_CHUNK`` by ``BWD_WIDTH``.  Each tile is fixed in the
kernel's source; ``scan_layout`` does the tiling's arithmetic (chunks,
channel tiles, tiles, the workspace of carries) for either, and the kernel
refuses a workspace or a tile that disagrees.

The scan and its backward are each one operation of the dispatcher, the
custom ops ``repro_torch::lru_scan`` and ``repro_torch::lru_scan_bwd``
(``torch.library``): a CPU implementation (the plain version), a CUDA one
(the kernel, or an error) and a shape rule for fake and meta tensors.
``LruScan`` runs the two ops, so a dispatch mode sees each call as one
operation (``launch.dryrun`` counts them by ``work`` and ``backward_work``).
"""
from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch
from torch import Tensor

from ..device import refuse_dtensor
from .build import CudaKernel

_KERNEL = CudaKernel(
    "lru_scan",
    "lru_scan.cu",
    [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 6 + [ctypes.c_void_p],
)
_BWD_KERNEL = CudaKernel(
    "lru_scan_bwd",
    "lru_scan.cu",
    [ctypes.c_void_p] * 7 + [ctypes.c_longlong] + [ctypes.c_int] * 6 + [ctypes.c_void_p],
)

# The kernel's tile (kChunk, kWidth in csrc/lru_scan.cu), the fastest of
# those timed at the serving path's prefill shape on an H100 (PERF.md, K3).
CHUNK, WIDTH = 128, 32
# The backward's tile (kBwdChunk, kBwdWidth), the fastest of those timed at
# the training path's (2, 512, 2560) that does not slow the prefill shape
# (tools/tune_lru_scan_bwd.py; PERF.md, K3 bwd).
BWD_CHUNK, BWD_WIDTH = 64, 64
_COUNTER_BYTES = 16  # the workspace's tile counter, padded


class ScanLayout(NamedTuple):
    """How one call of K3 (or its backward) is tiled, and the workspace that
    takes."""

    n_chunks: int  # ceil(T / chunk)
    n_rtiles: int  # channel tiles of one sequence, ceil(R / width)
    n_tiles: int  # blocks of the launch: n_chunks * B * n_rtiles
    workspace_bytes: int  # counter, (n_chunks - 1, B, R) 8-byte carries; cleared per launch


def scan_layout(bsz: int, t: int, r: int, chunk: int = CHUNK, width: int = WIDTH) -> ScanLayout:
    """The tiling of a (bsz, t, r) scan by tiles of ``chunk`` steps and
    ``width`` channels: K3's by default, its backward's with ``BWD_CHUNK``
    and ``BWD_WIDTH``."""
    n_chunks, n_rtiles = -(-t // chunk), -(-r // width)
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


def lru_scan_backward_plain(a: Tensor, h: Tensor, h0: Tensor, dy: Tensor):
    """Plain PyTorch version of K3's backward: for h = lru_scan(a, b, h0) and
    dL/dh = dy, returns (da, db, dh0).  g_t = dy_t + a_{t+1} g_{t+1} is
    ``lru_scan_plain`` on the reversed sequence with a shifted by one step,
    in float32; db = g and da = g h_{t-1} (h_{-1} = h0) in a's dtype, dh0 =
    a_0 g_0 in h0's."""
    a32 = a.float()
    a_next = torch.cat([a32[:, 1:], torch.zeros_like(a32[:, :1])], dim=1)  # g_T = 0
    g = lru_scan_plain(a_next.flip(1), dy.float().flip(1), torch.zeros_like(a32[:, 0])).flip(1)
    h_prev = torch.cat([h0.float()[:, None], h.float()[:, :-1]], dim=1)
    return (g * h_prev).to(a.dtype), g.to(a.dtype), (a32[:, 0] * g[:, 0]).to(h0.dtype)


def _check(what: str, a: Tensor, others, h0: Tensor) -> None:
    """The launchers' refusals: no DTensor; one CUDA device; a and
    ``others`` (B, T, R) all float32 or all bfloat16; h0 (B, R)."""
    refuse_dtensor(what, a, *others, h0)
    if not all(x.is_cuda and x.device == a.device for x in (a, *others, h0)):
        raise ValueError(f"{what} takes tensors on one CUDA device")
    if a.dtype not in (torch.float32, torch.bfloat16) or any(x.dtype != a.dtype for x in others):
        raise ValueError(f"{what}: dtypes {a.dtype}, {[x.dtype for x in others]}: all float32 or "
                         "all bfloat16")
    if a.dim() != 3 or any(x.shape != a.shape for x in others) or \
            h0.shape != (a.shape[0], a.shape[2]):
        raise ValueError(f"{what}: shapes {tuple(a.shape)}, {[tuple(x.shape) for x in others]}, "
                         f"h0 {tuple(h0.shape)}")


def lru_scan_cuda(a: Tensor, b: Tensor, h0: Tensor) -> Tensor:
    """Launch K3 on the current stream: a, b (B, T, R) both float32 or both
    bfloat16, h0 (B, R), on one CUDA device.  Returns (B, T, R) in a's
    dtype.  This is the raw launcher, with no gradient: under autograd with
    an input that requires one it raises, as its output would carry none and
    the gradients of a, b and h0 would silently be lost; ``lru_scan`` takes
    such inputs through ``LruScan``."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (a, b, h0)):
        raise RuntimeError("lru_scan_cuda is the raw launcher and carries no gradient: call "
                           "lru_scan, which differentiates K3 through LruScan")
    _check("lru_scan_cuda", a, (b,), h0)
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


def lru_scan_bwd_cuda(a: Tensor, h: Tensor, h0: Tensor, dy: Tensor, *, kernel=None,
                      tile=(BWD_CHUNK, BWD_WIDTH)):
    """Launch K3's backward on the current stream: a, h (the forward's
    output) and dy (B, T, R), all float32 or all bfloat16, h0 (B, R), on one
    CUDA device.  Returns (da, db) in a's dtype; dh0 = a_0 db_0 is the
    caller's (``LruScan.backward``).  ``kernel`` (a ``CudaKernel.variant``
    of this entry point) and ``tile``, the (chunk, width) it was built
    with, launch another build, as ``tools/tune_lru_scan_bwd.py`` does; the
    kernel refuses a tile that is not its own."""
    _check("lru_scan_bwd_cuda", a, (h, dy), h0)
    bsz, t, r = a.shape
    kernel = _BWD_KERNEL if kernel is None else kernel
    chunk, width = tile
    layout = scan_layout(bsz, t, r, chunk, width)
    a, h, dy = a.contiguous(), h.contiguous(), dy.contiguous()
    h0 = h0.to(torch.float32).contiguous()
    da, db = torch.empty_like(a), torch.empty_like(a)
    workspace = torch.empty(layout.workspace_bytes, dtype=torch.uint8, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    with torch.cuda.device(a.device):
        kernel.launch(
            a.data_ptr(), dy.data_ptr(), h.data_ptr(), h0.data_ptr(), da.data_ptr(),
            db.data_ptr(), workspace.data_ptr(), layout.workspace_bytes, bsz, t, r, chunk, width,
            int(a.dtype == torch.bfloat16), stream,
        )
    return da, db


@torch.library.custom_op("repro_torch::lru_scan", mutates_args=(), device_types="cpu")
def _lru_scan_op(a: Tensor, b: Tensor, h0: Tensor) -> Tensor:
    return lru_scan_plain(a, b, h0)


@_lru_scan_op.register_kernel("cuda")
def _(a, b, h0):
    return lru_scan_cuda(a, b, h0)


@_lru_scan_op.register_fake
def _(a, b, h0):
    return torch.empty_like(a)


@torch.library.custom_op("repro_torch::lru_scan_bwd", mutates_args=(), device_types="cpu")
def _lru_scan_bwd_op(a: Tensor, h: Tensor, h0: Tensor,
                     dy: Tensor) -> Tuple[Tensor, Tensor, Tensor]:
    return lru_scan_backward_plain(a, h, h0, dy)


@_lru_scan_bwd_op.register_kernel("cuda")
def _(a, h, h0, dy):
    da, db = lru_scan_bwd_cuda(a, h, h0, dy.to(a.dtype))
    return da, db, (a[:, 0].float() * db[:, 0].float()).to(h0.dtype)


@_lru_scan_bwd_op.register_fake
def _(a, h, h0, dy):
    return torch.empty_like(a), torch.empty_like(a), torch.empty_like(h0)


def work(a: Tensor, b: Tensor, h0: Tensor):
    """(operations, bytes) of one K3 call, the bound's count: a multiply-add
    an element; a and b read, h written, h0 read."""
    n = a.numel()
    return 2.0 * n, float(n * (2 * a.element_size() + b.element_size())
                          + h0.numel() * h0.element_size())


def backward_work(a: Tensor, h: Tensor, h0: Tensor, dy: Tensor):
    """(operations, bytes) of one call of K3's backward, the bound's count:
    3 operations an element (g = a g + dy, da = g h); a, dy and h read, da
    and db written, h0 read and dh0 written."""
    n = a.numel()
    return 3.0 * n, float(n * (3 * a.element_size() + h.element_size() + dy.element_size())
                          + 2 * h0.numel() * h0.element_size())


class LruScan(torch.autograd.Function):
    """K3 with its backward.  The forward runs ``repro_torch::lru_scan`` (the
    kernel on a CUDA tensor, ``lru_scan_plain`` on a CPU tensor) and saves
    a, its output h and h0 (not b); the backward runs
    ``repro_torch::lru_scan_bwd`` (``lru_scan_bwd`` or
    ``lru_scan_backward_plain``) alike.  Under
    ``torch.utils.checkpoint(use_reentrant=False)`` the forward runs again
    in the recompute, so a layer launches K3 twice and its backward once."""

    @staticmethod
    def forward(ctx, a: Tensor, b: Tensor, h0: Tensor) -> Tensor:
        h = _lru_scan_op(a, b, h0)
        ctx.save_for_backward(a, h, h0)
        return h

    @staticmethod
    def backward(ctx, dy: Tensor):
        a, h, h0 = ctx.saved_tensors
        da, db, dh0 = _lru_scan_bwd_op(a, h, h0, dy)
        return da, db, dh0 if ctx.needs_input_grad[2] else None


def lru_scan(a: Tensor, b: Tensor, h0: Tensor) -> Tensor:
    """h_t = a_t h_{t-1} + b_t along T, h0 folded in.  Same signature as
    ``lru_scan_pallas``.  CUDA tensors run the kernel; CPU tensors run
    ``lru_scan_plain``; fake and meta tensors take the shape rule; under
    autograd with an input that requires a gradient all go through
    ``LruScan``.  A DTensor is refused.  One custom op a call."""
    refuse_dtensor("lru_scan", a, b, h0)
    if a.device.type not in ("cpu", "cuda", "meta"):
        raise ValueError(f"lru_scan: no kernel for device {a.device}")
    if torch.is_grad_enabled() and any(x.requires_grad for x in (a, b, h0)):
        return LruScan.apply(a, b, h0)
    return _lru_scan_op(a, b, h0)
