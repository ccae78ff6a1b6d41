"""K3's backward on the CPU: ``lru_scan_backward_plain`` (the formula the
card's ``lru_scan_bwd`` runs) against autograd through ``lru_scan_plain``
and against ``jax.grad`` of the reference's RG-LRU scan, and ``lru_scan``
under autograd (``LruScan``), which on a CPU tensor never reaches a kernel.

For h = lru_scan(a, b, h0) and dL/dh = dy the backward is the reverse-time
scan g_t = dy_t + a_{t+1} g_{t+1}, with db = g, da = g h_{t-1} (h_{-1} = h0)
and dh0 = a_0 g_0.  Tolerances: each gradient within 1e-5 of its largest
entry in float32 (the summation orders differ: measured up to 3e-7), 4e-2
in bfloat16 (da reads the forward's output rounded to bfloat16, as the
card's kernel does, where autograd reads the float32 state).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import kernels
from repro_torch.kernels import lru_scan as k3
from repro_torch.kernels import ops
from repro_torch.models import layers as tl
from repro_torch.models.params import leaves
from repro_torch.train import train_step as tts
from test_torch_model_kernels import _scan_inputs
from test_torch_train_step import batch, both, model, tparams

TOL = {torch.float32: 1e-5, torch.bfloat16: 4e-2}
DTYPES = [torch.float32, torch.bfloat16]
# (B, T, R, decays near 1): one step, ragged T across a chunk of 128, R not a
# multiple of the kernel's 32 channels, and decays in [0.9, 0.9999).
SHAPES = [(1, 1, 5, False), (2, 9, 7, False), (3, 130, 33, False), (2, 257, 16, True)]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """Torch on one thread: the suite's worker processes would oversubscribe
    the cores (tests/test_torch_dag.py)."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def inputs(b, t, r, near_one, dtype, seed=0):
    """a, b, h0 (h0 != 0) and an upstream gradient dy, drawn with numpy."""
    a, x, h0 = _scan_inputs(b, t, r, seed=seed, near_one=near_one)
    dy = np.random.default_rng(seed + 1).normal(size=(b, t, r)).astype(np.float32)
    return [torch.as_tensor(y).to(dtype) for y in (a, x, h0, dy)]


def grads(fn, a, x, h0, dy):
    leaves_ = [y.detach().requires_grad_() for y in (a, x, h0)]
    return torch.autograd.grad(fn(*leaves_), leaves_, dy)


def assert_near(got, want, tol):
    as_np = lambda y: np.asarray(y.float() if isinstance(y, torch.Tensor) else y, np.float32)
    for g, w in zip(map(as_np, got), map(as_np, want)):
        assert g.shape == w.shape
        err = np.abs(g - w).max()
        assert err <= tol * np.abs(w).max() + 1e-12, (g.shape, err, np.abs(w).max())


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,t,r,near_one", SHAPES)
def test_backward_plain_matches_autograd_through_plain(b, t, r, near_one, dtype):
    a, x, h0, dy = inputs(b, t, r, near_one, dtype)
    want = grads(k3.lru_scan_plain, a, x, h0, dy)
    h = k3.lru_scan_plain(a, x, h0)
    got = k3.lru_scan_backward_plain(a, h, h0, dy)
    assert [g.dtype for g in got] == [dtype] * 3
    assert_near(got, want, TOL[dtype])


def reference_scan(a, bb, h0):
    """The reference's RG-LRU scan as written at src/repro/models/recurrent.py:335-344:
    h0 folded into the first step, then ``lax.associative_scan``."""
    bb = bb.at[:, 0].add(a[:, 0] * h0)

    def combine(c1, c2):
        a1, b1 = c1
        a2, b2 = c2
        return a1 * a2, a2 * b1 + b2

    _, h_s = jax.lax.associative_scan(combine, (a, bb), axis=1)
    return h_s


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b,t,r,near_one", SHAPES)
def test_backward_plain_matches_jax_grad_of_the_reference_scan(b, t, r, near_one, dtype):
    """``jax.grad`` of sum(h * dy) through the reference's scan, in float32 on
    the same values (in bfloat16 the port's inputs rounded to it: the
    reference's model stack scans in float32)."""
    a, x, h0, dy = inputs(b, t, r, near_one, dtype, seed=3)
    j = [jnp.asarray(y.float().numpy()) for y in (a, x, h0, dy)]
    want = jax.jit(jax.grad(lambda a_, b_, h_, dy_: jnp.sum(reference_scan(a_, b_, h_) * dy_),
                            argnums=(0, 1, 2)))(*j)
    got = k3.lru_scan_backward_plain(a, k3.lru_scan_plain(a, x, h0), h0, dy)
    assert_near(got, want, TOL[dtype])


@pytest.mark.parametrize("dtype", DTYPES)
def test_lru_scan_under_autograd_goes_through_the_function(dtype, monkeypatch):
    """On a CPU tensor that requires a gradient ``lru_scan`` takes
    ``LruScan``: its forward calls ``lru_scan_plain`` once and its backward
    ``lru_scan_backward_plain`` once (which scans with ``lru_scan_plain``);
    the gradients are the formula's, h0's included."""
    calls = {"plain": 0, "backward": 0}
    plain, backward = k3.lru_scan_plain, k3.lru_scan_backward_plain

    def count(name, fn):
        def wrapped(*args):
            calls[name] += 1
            return fn(*args)
        return wrapped

    monkeypatch.setattr(k3, "lru_scan_plain", count("plain", plain))
    monkeypatch.setattr(k3, "lru_scan_backward_plain", count("backward", backward))
    a, x, h0, dy = inputs(2, 130, 33, False, dtype, seed=5)
    leaves_ = [y.detach().requires_grad_() for y in (a, x, h0)]
    h = ops.lru_scan(*leaves_)
    assert type(h.grad_fn).__name__ == "LruScanBackward"
    assert calls == {"plain": 1, "backward": 0}
    got = torch.autograd.grad(h, leaves_, dy)
    assert calls == {"plain": 2, "backward": 1}
    want = backward(a, plain(a, x, h0), h0, dy)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_lru_scan_without_a_gradient_skips_the_function():
    a, x, h0, _ = inputs(2, 9, 7, False, torch.float32)
    assert ops.lru_scan(a, x, h0).grad_fn is None
    leaves_ = [y.detach().requires_grad_() for y in (a, x, h0)]
    with torch.no_grad():
        assert ops.lru_scan(*leaves_).grad_fn is None


def test_default_h0_takes_no_gradient():
    """``ops.lru_scan`` without h0 scans from zeros; only a and b get
    gradients, and they are the formula's at h0 = 0."""
    a, x, _, dy = inputs(2, 9, 7, False, torch.float32, seed=7)
    la, lx = a.clone().requires_grad_(), x.clone().requires_grad_()
    got = torch.autograd.grad(ops.lru_scan(la, lx), (la, lx), dy)
    zero = torch.zeros((2, 7))
    want = k3.lru_scan_backward_plain(a, k3.lru_scan_plain(a, x, zero), zero, dy)
    for g, w in zip(got, want[:2]):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_cpu_path_under_autograd_never_reaches_a_kernel(monkeypatch):
    """Forward and backward on CPU tensors: no launcher, layout or launch."""
    def refuse(*args, **kwargs):
        raise AssertionError("the CPU path reached a kernel's wrapper")

    for name in ("lru_scan_cuda", "lru_scan_bwd_cuda", "scan_layout"):
        monkeypatch.setattr(k3, name, refuse)
    monkeypatch.setattr(k3._KERNEL, "launch", refuse)
    monkeypatch.setattr(k3._BWD_KERNEL, "launch", refuse)
    before = kernels.launch_counts()
    a, x, h0, dy = inputs(3, 130, 33, True, torch.float32, seed=9)
    got = grads(ops.lru_scan, a, x, h0, dy)
    assert_near(got, grads(k3.lru_scan_plain, a, x, h0, dy), TOL[torch.float32])
    assert kernels.launch_counts() == before


def test_raw_launcher_refuses_an_input_that_requires_a_gradient():
    """``lru_scan_cuda`` carries no gradient, so under autograd it refuses an
    input that requires one, before anything else is checked."""
    a, x, h0, _ = inputs(1, 4, 8, False, torch.float32)
    with pytest.raises(RuntimeError, match="LruScan"):
        k3.lru_scan_cuda(a.requires_grad_(), x, h0)
    with torch.no_grad(), pytest.raises(ValueError, match="one CUDA device"):
        k3.lru_scan_cuda(a, x, h0)


def test_checkpointed_scan_gives_the_gradients_of_the_plain_call():
    """Under ``checkpoint(use_reentrant=False)`` (remat "full") the forward
    runs twice, the saved output h is recomputed, and the gradients are bit
    for bit those of the call without it."""
    a, x, h0, dy = inputs(2, 130, 33, True, torch.float32, seed=11)
    want = grads(ops.lru_scan, a, x, h0, dy)
    got = grads(lambda *y: checkpoint(ops.lru_scan, *y, use_reentrant=False), a, x, h0, dy)
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_full_remat_of_the_hybrid_family_is_bitwise_none_through_the_function(monkeypatch):
    """The reduced hybrid microbatch under remat "full" and "none": the
    gradients bit for bit, each RG-LRU layer's scan through ``LruScan``:
    one forward and one backward a layer under "none", and the recompute's
    forward besides under "full"."""
    counts = {"forward": 0, "backward": 0}
    forward, backward = k3.LruScan.forward, k3.LruScan.backward

    def counted(name, fn):
        def wrapped(ctx, *args):
            counts[name] += 1
            return fn(ctx, *args)
        return staticmethod(wrapped)

    monkeypatch.setattr(k3.LruScan, "forward", counted("forward", forward))
    monkeypatch.setattr(k3.LruScan, "backward", counted("backward", backward))
    _, tcfg, tree = model("recurrentgemma-2b")
    _, tb = both(batch(tcfg))
    out, seen = {}, {}
    for remat in ("none", "full"):
        counts.update(forward=0, backward=0)
        out[remat] = tts.microbatch_value_and_grad(tcfg, tl.ApplyCtx(mode="train", remat=remat))(
            tparams(tree), tb)
        seen[remat] = dict(counts)
    assert seen == {"none": {"forward": 2, "backward": 2}, "full": {"forward": 4, "backward": 2}}
    assert float(out["none"][0][0]) == float(out["full"][0][0])
    for g0, g1 in zip(leaves(out["none"][1]), leaves(out["full"][1])):
        torch.testing.assert_close(g0, g1, rtol=0, atol=0)
