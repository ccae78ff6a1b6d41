"""K1, the fleet's exponent-posterior grid (``posterior_grid_fleet_kernel``).

A launch over (K workers, N observations, G grid points) evaluates both
exponents' log-posteriors at every (k, g, n) cell: in the mirrored mode
(the Gibbs sweep's) g log2 f, the exp2, pg * pg and three fused
multiply-adds of two operations each, 9 float32 operations a cell; the
general mode adds a reciprocal, 10.  Bytes: t, f and the mask (K, N), eight
per-worker scalars and the grid read once, the (K, 2, G) output written.
"""
F32_FLOPS = 67e12  # H100 SXM, float32 outside the tensor cores
HBM = 3.35e12  # H100 SXM, bytes/s

KERNELS = ("posterior_grid_fleet_kernel",)


def work(k: int, n: int, g: int, mirrored: bool = True):
    ops = (9.0 if mirrored else 10.0) * k * g * n
    nbytes = 4.0 * (3 * k * n + 8 * k + g + 2 * k * g)
    return ops, nbytes


def bound_s(k: int, n: int, g: int, mirrored: bool = True) -> float:
    ops, nbytes = work(k, n, g, mirrored)
    return max(ops / F32_FLOPS, nbytes / HBM)
