"""Hand-written Hopper kernels for the port's hot spots.

  * posterior_grid (K1) — the paper's O(K*G*N) exponent-posterior grid
    evaluation (Eqs 10/11), one fused launch for every worker of the fleet
    and both exponents; CUDA C++ in ``csrc/posterior_grid.cu``.

``ops`` holds the public wrappers, which dispatch on the device of their
tensors (kernel on CUDA, plain PyTorch on the CPU); ``build`` compiles the
CUDA sources with ``nvcc`` at first use and counts every kernel's launches.
"""
from . import build, ops
from .build import launch_counts, reset_launch_counts
from .posterior_grid import (
    posterior_grid_cuda,
    posterior_grid_fleet,
    posterior_grid_plain,
)

__all__ = [
    "build",
    "launch_counts",
    "ops",
    "posterior_grid_cuda",
    "posterior_grid_fleet",
    "posterior_grid_plain",
    "reset_launch_counts",
]
