"""K1 (the fleet grid posterior): the port's kernel wrapper against the
reference's Pallas kernel, run in interpret mode on the CPU exactly as
tests/test_kernels.py runs it.

On a CPU tensor the wrapper runs the plain PyTorch version; on a CUDA tensor
it launches the hand-written kernel or raises.  The one test that needs the
card compares the kernel with the plain version there and skips elsewhere.
Tolerance: the reference's ``_assert_logp_close`` (rtol 2e-5 scaled by
1 + max|logp|).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import moments as jm
from repro.kernels import ops as jops
from repro.kernels.posterior_grid import posterior_grid_fleet_pallas, posterior_grid_pallas
from repro_torch import kernels
from repro_torch.core.moments import BetaParams
from repro_torch.kernels import ops
from repro_torch.kernels.posterior_grid import posterior_grid_cuda, posterior_grid_plain
from test_torch_moments import CASES, _jax_grid, assert_logp_close, fleet_case


def _pallas(grid, c, **kw):
    J = jnp.asarray
    return posterior_grid_fleet_pallas(
        J(grid), J(c["t"]), J(c["f"]), J(c["mask"]), J(c["mu"]), J(c["lam"]),
        J(c["alpha"]), J(c["beta"]), *map(J, c["ap"]), *map(J, c["bp"]),
        interpret=True, **kw,
    )


def _ops(grid, c, **kw):
    T = torch.as_tensor
    return ops.posterior_grid_fleet(
        T(grid), T(c["t"]), T(c["f"]), T(c["mu"]), T(c["lam"]), T(c["alpha"]),
        T(c["beta"]), BetaParams(*map(T, c["ap"])), BetaParams(*map(T, c["bp"])),
        T(c["mask"]), **kw,
    )


@pytest.mark.parametrize("zero_cols", [False, True])
@pytest.mark.parametrize("k,g,n", CASES)
def test_posterior_grid_fleet_matches_pallas(k, g, n, zero_cols):
    c = fleet_case(k, n, zero_cols=zero_cols)
    grid = np.linspace(1e-4, 1 - 1e-4, g, dtype=np.float32)
    before = kernels.launch_counts()
    got = _ops(grid, c)
    assert got.shape == (k, 2, g)
    assert_logp_close(got, _pallas(grid, c, block_g=64, block_n=256))
    # CPU tensors take the plain version: the kernel's count does not move
    assert kernels.launch_counts() == before


@pytest.mark.parametrize("zero_cols", [False, True])
@pytest.mark.parametrize("k,g,n", CASES)
def test_posterior_grid_fleet_symmetric_matches_reference_and_pallas(k, g, n, zero_cols):
    """The mirrored mode (symmetric_grid=True, which the Gibbs sweep takes) on
    the exponent grid matches the reference's symmetric-grid oracle and its
    Pallas kernel, which computes the general form."""
    c = fleet_case(k, n, seed=g, zero_cols=zero_cols)
    grid = np.asarray(jm.exponent_grid(g))
    before = kernels.launch_counts()
    got = _ops(grid, c, symmetric_grid=True)
    assert got.shape == (k, 2, g)
    assert_logp_close(got, _jax_grid(grid, c, symmetric_grid=True))
    assert_logp_close(got, _pallas(grid, c, block_g=64, block_n=256))
    assert kernels.launch_counts() == before


def test_posterior_grid_fleet_fully_masked_worker():
    c = fleet_case(3, 150, seed=7)
    c["mask"][1] = 0.0
    grid = np.linspace(1e-4, 1 - 1e-4, 64, dtype=np.float32)
    got = _ops(grid, c)
    assert torch.isfinite(got).all()
    assert_logp_close(got, _pallas(grid, c))


def test_stage_axis_fold_matches_reference_and_rows():
    """(S, K, N) telemetry folds into one S*K-worker launch and back."""
    s, k, n, g = 2, 3, 40, 48
    cs = [fleet_case(k, n, seed=11 + i) for i in range(s)]
    stack = {key: np.stack([c[key] for c in cs]) for key in cs[0] if key not in ("ap", "bp")}
    for key in ("ap", "bp"):
        stack[key] = tuple(np.stack([c[key][j] for c in cs]) for j in range(2))
    grid = np.linspace(1e-4, 1 - 1e-4, g, dtype=np.float32)
    got = _ops(grid, stack)
    assert got.shape == (s, k, 2, g)
    J = jnp.asarray
    from repro.core.moments import BetaParams as JBeta

    want = jops.posterior_grid_fleet(
        J(grid), J(stack["t"]), J(stack["f"]), J(stack["mu"]), J(stack["lam"]),
        J(stack["alpha"]), J(stack["beta"]), JBeta(*map(J, stack["ap"])),
        JBeta(*map(J, stack["bp"])), J(stack["mask"]),
    )
    assert_logp_close(got, want)
    for i in range(s):  # the fold is exact: each stage equals its own launch
        torch.testing.assert_close(got[i], _ops(grid, cs[i]), rtol=0, atol=0)


@pytest.mark.parametrize("mode", ["alpha", "beta"])
def test_single_mode_slices_match_pallas(mode):
    c = fleet_case(1, 300, seed=5)
    grid = np.linspace(1e-4, 1 - 1e-4, 128, dtype=np.float32)
    T, J = torch.as_tensor, jnp.asarray
    other = c["beta"][0] if mode == "alpha" else c["alpha"][0]
    prior = c["ap"] if mode == "alpha" else c["bp"]
    want = posterior_grid_pallas(
        J(grid), J(c["t"][0]), J(c["f"][0]), J(c["mask"][0]), J(c["mu"][0]),
        J(c["lam"][0]), J(other), J(prior[0][0]), J(prior[1][0]),
        mode=mode, interpret=True,
    )
    fn = ops.posterior_grid_alpha if mode == "alpha" else ops.posterior_grid_beta
    got = fn(
        T(grid), T(c["t"][0]), T(c["f"][0]), T(c["mu"][0]), T(c["lam"][0]),
        T(other), BetaParams(T(prior[0][0]), T(prior[1][0])), T(c["mask"][0]),
    )
    assert got.shape == (128,)
    assert_logp_close(got, want)


def test_cuda_wrapper_refuses_cpu_tensors():
    """The kernel path never falls back: handed CPU tensors, it raises."""
    c = fleet_case(2, 16)
    T = torch.as_tensor
    params = torch.zeros((2, 8))
    with pytest.raises(ValueError):
        posterior_grid_cuda(T(np.linspace(0.1, 0.9, 8, dtype=np.float32)),
                            T(c["t"]), T(c["f"]), T(c["mask"]), params)


@pytest.mark.cuda
@pytest.mark.parametrize("symmetric_grid", [False, True])
def test_cuda_kernel_matches_plain_on_card(symmetric_grid):
    """Both kernel modes against the plain version of the same form; the
    mirrored one on the exponent grid, the general one on the grid of
    tests/test_kernels.py, and a G > 256 grid takes several passes."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    for k, g, n in CASES + [(2, 64, 3000)]:  # N above one staged tile of 2048
        c = fleet_case(k, n, zero_cols=True)
        c["mask"][0, : n // 2] = 0.0
        dev = lambda x: torch.as_tensor(x, device="cuda")
        grid = (np.asarray(jm.exponent_grid(g)) if symmetric_grid
                else np.linspace(1e-4, 1 - 1e-4, g, dtype=np.float32))
        args = (dev(grid), dev(c["t"]), dev(c["f"]), dev(c["mask"]), dev(c["mu"]),
                dev(c["lam"]), dev(c["alpha"]), dev(c["beta"]),
                *map(dev, c["ap"]), *map(dev, c["bp"]))
        before = kernels.launch_counts()["posterior_grid_fleet"]
        got = kernels.posterior_grid_fleet(*args, symmetric_grid=symmetric_grid)
        torch.cuda.synchronize()
        assert kernels.launch_counts()["posterior_grid_fleet"] == before + 1
        want = posterior_grid_plain(*args, symmetric_grid=symmetric_grid)
        assert_logp_close(got.cpu(), want.cpu())
