"""Hand-written Hopper kernels for the port's hot spots.

  * posterior_grid (K1) — the paper's O(K*G*N) exponent-posterior grid
    evaluation (Eqs 10/11), one fused launch for every worker of the fleet
    and both exponents; CUDA C++ in ``csrc/posterior_grid.cu``.
  * decode_attention (K2) — flash-decode GQA attention of one query token
    per sequence over a KV cache (every decode step of an attention layer);
    CUDA C++ in ``csrc/decode_attention.cu``.
  * lru_scan (K3) — the linear recurrence h_t = a_t h_{t-1} + b_t along time
    (every RG-LRU prefill and train forward), and its backward, the same
    scan in reverse time (``lru_scan_bwd``, every RG-LRU train backward);
    CUDA C++ in ``csrc/lru_scan.cu``.

``ops`` holds the public wrappers, which dispatch on the device of their
tensors (kernel on CUDA, plain PyTorch on the CPU); ``build`` compiles the
CUDA sources with ``nvcc`` at first use and counts every kernel's launches.
"""
from . import build, ops
from .build import launch_counts, reset_launch_counts
from .decode_attention import decode_attention_cuda, decode_attention_plain
from .lru_scan import (
    LruScan,
    lru_scan_backward_plain,
    lru_scan_bwd_cuda,
    lru_scan_cuda,
    lru_scan_plain,
)
from .posterior_grid import (
    posterior_grid_cuda,
    posterior_grid_fleet,
    posterior_grid_plain,
)

__all__ = [
    "LruScan",
    "build",
    "decode_attention_cuda",
    "decode_attention_plain",
    "launch_counts",
    "lru_scan_backward_plain",
    "lru_scan_bwd_cuda",
    "lru_scan_cuda",
    "lru_scan_plain",
    "ops",
    "posterior_grid_cuda",
    "posterior_grid_fleet",
    "posterior_grid_plain",
    "reset_launch_counts",
]
